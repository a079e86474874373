"""The six reference scenes as declarative configs.

Each function reproduces one reference example module
(example/{cornell_box,single_model,sky_dome,spectral_box,veach_bdpt,
prism_rainbow}.py): asset, material overrides, lights, integrator choice,
and the camera auto-framing rule.
"""

from dataclasses import dataclass, field

import numpy as np

from ti_raytrace_tpu.camera import CameraSpec, orbit_camera
from ti_raytrace_tpu.core import constants as C
from ti_raytrace_tpu.io.assets import asset_path
from ti_raytrace_tpu.scene.build import (
    MaterialRec,
    SceneBuilder,
    laser_shape,
    sphere_shape,
)


@dataclass
class ExampleConfig:
    name: str
    integrator: str             # debug | pt_rgb | pt_spec | bdpt_rgb | bdpt_spec
    scale_mult: float = 0.8     # camera distance = diag * scale_mult
    fixed_scale: float | None = None
    fixed_target: tuple | None = None
    yaw: float = 0.0
    pitch: float = 0.0
    exposure: float = 0.5       # reference Example.py:43
    sky: dict = field(default_factory=dict)  # PT_Spec sky parameters
    # wavefront compaction schedule for pt_rgb (None = exact; scenes whose
    # paths terminate early gain 3-6x with no measurable bias)
    compaction: tuple | None = None
    # merged-group size for the production path (render_film_frames_merged):
    # >1 routes the CLI onto merged multi-frame dispatches with the
    # compaction schedule above (requires one).  None/1 = plain batched
    # frames.
    group: int | None = None
    # frames per dispatch for the CLI loop (None = run.py default).
    batch: int | None = None
    # BDPT walk-compaction schedules (eye, light) and shadow-batch cap,
    # the bdpt_rgb.render_paths contract.  Walk compaction is off on
    # cluster-tracer scenes (the kernel's dead-lane early exit already
    # makes parked lanes cheap) and on for dense-tracer scenes; the dense
    # shadow cap leaves the prism output byte-identical.
    bdpt_walk_compaction: tuple | None = None
    bdpt_shadow_cap: float | None = None


def _add_sphere_light(b: SceneBuilder, emission=50.0):
    """(reference Example.add_sphere_light, Example.py:27-36)."""
    b.add_shape(
        sphere_shape([0.0, 20.0, 0.0], 5.0),
        MaterialRec(C.MAT_LIGHT, color=[emission] * 3),
    )


def cornell_box():
    """PT_RGB on the classic box (example/cornell_box.py)."""
    b = SceneBuilder()
    b.add_obj(asset_path("model/cornell_box.obj"))
    return b.build(), ExampleConfig(
        "cornell_box",
        "pt_rgb",
        scale_mult=0.8,
        # overflow-gated: the tighter ((2,2),(4,4),(6,8),(9,16),(12,32))
        # overflowed (25.8k kills).  The box interior keeps occupancy
        # high, so merged groups are not used here.  The schedule was
        # tuned on the previous accelerator; not yet re-swept on the GPU.
        compaction=((3, 2), (5, 4), (8, 8), (11, 16)),
        batch=32,
    )


def single_model():
    """Glass sphere + sphere light + env map (example/single_model.py).
    The reference's 100k-tri `mc.obj` benchmark mesh slot lives here; the
    blob is missing upstream, so bench.py substitutes a subdivided mesh."""
    b = SceneBuilder()
    b.add_obj(asset_path("model/sphere.obj"))
    b.materials[0] = MaterialRec(
        C.MAT_GLASS, color=b.materials[0].color, p0=1.3, p1=5.0
    )
    _add_sphere_light(b)
    b.add_env(asset_path("image/env.png"), 5.0)
    return (
        b.build(smooth_normals=True),
        ExampleConfig(
            "single_model",
            "pt_rgb",
            scale_mult=0.8,
            # full-frame occupancy probe: 22.4% alive after b0, 14.9%
            # after b1, 0.63% after b2; merged g16 at ((1,4),(3,128)) runs
            # with overflow 0 (group-pooled capacity 0.78% vs 0.63%
            # occupancy).  (1,8)/(1,5) overflow (hit fraction 22.4% >
            # capacity).  Tuned on the previous accelerator; not yet
            # re-swept on the GPU.
            compaction=((1, 4), (3, 128)),
            group=16,
            batch=64,
        ),
    )


def sky_dome():
    """Mirror sphere under the Hosek-Wilkie sky (example/sky_dome.py)."""
    b = SceneBuilder()
    b.add_obj(asset_path("model/sphere.obj"))
    b.materials[0].p0 = 1.0  # metal
    b.materials[0].p1 = 0.0  # rough
    _add_sphere_light(b)
    sc = b.build(smooth_normals=True, spectral=True)
    # sky parameters fixed inside the reference integrator
    # (PT_Spec.py:49: Sky(3.0, 0.5, 0.17))
    return sc, ExampleConfig(
        "sky_dome",
        "pt_spec",
        scale_mult=2.0,
        sky=dict(turbidity=3.0, albedo=0.5, elevation=0.17),
        # a depth-2 scene: 4.58% alive after bounce 0 (the mirror
        # sphere), 0% after bounce 1 (reflections leave into the sky).
        # ((1,16),) runs with overflow 0 (capacity 6.25% vs a
        # geometry-deterministic 4.58% hit fraction); the while_loop
        # exits on the dead wavefront.
        compaction=((1, 16),),
        batch=64,
    )


def spectral_box():
    """Hero-wavelength spectral cornell box (example/spectral_box.py):
    the first three materials become measured-SPD reflectors."""
    b = SceneBuilder()
    b.add_obj(asset_path("model/cornell_box.obj"))
    for i, tex in ((0, 0), (1, 1), (2, 2)):
        b.materials[i].type = C.MAT_SPECTRAL
        b.materials[i].tex = tex  # 0=white 1=red 2=green SPD
    return (
        b.build(smooth_normals=True, spectral=True),
        ExampleConfig(
            "spectral_box",
            "pt_spec",
            scale_mult=0.8,
            # emitter_scale sqrt(3): the golden embodies a lamp scale of
            # ||Ke||_1 = 30 rather than the reference code's ceiling of
            # ||Ke||_2 = 17.32 (measured by tools/spectral_direct_oracle;
            # PARITY.md 'spectral emitter scale')
            sky=dict(turbidity=3.0, albedo=0.5, elevation=0.17,
                     emitter_scale=float(np.sqrt(3.0))),
            # measured occupancy (64^2 probe): 0.33 after b3, 0.09 after
            # b6, 0.05 after b8 — each phase keeps >=2.5x headroom; the
            # perf harness asserts zero overflow kills at 512^2
            compaction=((3, 2), (6, 4), (8, 8)),
        ),
    )


def veach_bdpt():
    """Veach MIS scene with the bidirectional tracer
    (example/veach_bdpt.py)."""
    b = SceneBuilder()
    b.add_obj(asset_path("model/bdpt.obj"))
    return (
        b.build(smooth_normals=True),
        ExampleConfig("veach_bdpt", "bdpt_rgb", scale_mult=0.5),
    )


def prism_rainbow():
    """Dispersion demo: prism + laser, spectral BDPT
    (example/prism_rainbow.py) — the scene the reference could only run on
    its CPU backend."""
    b = SceneBuilder()
    b.add_obj(asset_path("model/prism1.obj"))
    b.add_shape(
        sphere_shape([0.0, 20.0, 0.0], 5.0),
        MaterialRec(C.MAT_LIGHT, color=[500.0] * 3),
    )
    b.add_shape(
        laser_shape([1.0, 0.0, 9.0], [0.0, 0.0, -1.0], 0.1),
        MaterialRec(C.MAT_LIGHT, color=[500.0] * 3),
    )
    return (
        b.build(spectral=True),
        ExampleConfig(
            "prism_rainbow",
            "bdpt_spec",
            fixed_scale=10.0,
            fixed_target=(0.0, 0.0, 0.0),
            # emitter_scale sqrt(3): rainbow-far.png comes from the same
            # spectral pipeline whose goldens embody a ||Ke||_1 lamp
            # normalization (vs the reference code's ||Ke||_2 ceiling —
            # tools/spectral_direct_oracle.py, PARITY.md 'spectral
            # emitter scale'); both prism lights are gray (500,500,500),
            # where ||Ke||_1/||Ke||_2 = sqrt(3)
            sky=dict(emitter_scale=float(np.sqrt(3.0))),
            # walk schedules sized to the CPU-probed alive fractions
            # (eye .53/.14/.07/.02, light .56/.37/.22/.20); the dense
            # shadow batch is 6.8% active, cap 0.09 leaves 32% headroom
            # and rendered byte-identical sums vs uncapped.
            bdpt_walk_compaction=(((2, 1.7), (3, 5.5), (4, 10.0)),
                                  ((2, 1.6), (3, 2.4), (4, 3.9))),
            bdpt_shadow_cap=0.09,
        ),
    )


BENCH_SCHEDULE = ((1, 4), (4, 16), (8, 64))
"""Compaction schedule for benchmark_100k's plain (non-merged) frames
(occupancy drops to ~0.18 after bounce 1); overflow kills are counted at
runtime, so a scene change that invalidates this schedule is loud, not
silently biased."""

BENCH_SCHEDULE_MERGED = ((1, 5), (3, 24), (8, 128))
"""Schedule for the MERGED group renderer (bench.py): capacity pools
across the group's frames, so survivor spikes average out and the deep
divisors can halve their per-frame headroom.  The (3, 24) boundary
exploits the occupancy collapse after bounce 2 (3.2% survivors vs phase
1's capacity); phase-1 divisor 5 holds because the bench camera's hit
fraction is deterministic (18.3% +- binomial noise at 262k lanes vs 20%
capacity).  Divisors 28/160 for the deeper phases overflow.  Tuned on
the previous accelerator; every run checks that it kills no path."""

BENCH_PAY_DIVISORS = (8, 32)
"""Payload-tail capacities of the fused flush+compact at the two merged
phase boundaries (pt_rgb._flush_compact): the boundary scatter then
covers only dead-with-payload lanes.  Overflow-gated like the width
schedule; (8, 40) kills payload paths."""


def benchmark_100k(n_target: int = 100_000, cache: bool = True):
    """The reference's headline benchmark slot (README.md:56-58): a
    ~100k-triangle mesh in the single_model configuration.  `mc.obj` is a
    missing blob upstream, so the mesh is a densified Teapot.  The host
    arrays (mesh + BVH + clusters + packs, ~10 s to build) are cached
    under .cache/ keyed by the triangle target AND the build format
    version — bump scene.build.BUILD_FORMAT_VERSION whenever the
    builder/packs/cluster layout changes, or this cache silently serves
    stale arrays."""
    import os

    from ti_raytrace_tpu.scene.build import BUILD_FORMAT_VERSION
    from ti_raytrace_tpu.scene.data import device_scene

    cfg = ExampleConfig(
        "benchmark_100k", "pt_rgb", scale_mult=0.8, compaction=BENCH_SCHEDULE
    )
    cache_path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        ".cache", f"bench_scene_{n_target}_v{BUILD_FORMAT_VERSION}.npz",
    )
    if cache and os.path.exists(cache_path):
        with np.load(cache_path) as z:
            host = {k: z[k] for k in z.files}
        return device_scene(host), cfg

    from ti_raytrace_tpu.io.meshgen import densify_to
    from ti_raytrace_tpu.io.obj import load_obj

    mesh = load_obj(asset_path("model/Teapot.obj"))
    pos = np.concatenate(mesh.tri_pos)
    nrm = np.concatenate(mesh.tri_normal)
    uv = np.concatenate(mesh.tri_uv)
    pos, nrm, uv = densify_to(pos, nrm, uv, n_target)

    b = SceneBuilder()
    b.add_triangles(
        pos, nrm, uv, MaterialRec(C.MAT_GLASS, color=(0.8, 0.8, 0.8), p0=1.3, p1=5.0)
    )
    _add_sphere_light(b)
    try:
        b.add_env(asset_path("image/env.png"), 5.0)
    except FileNotFoundError:
        pass
    host = b.build_host()
    if cache:
        os.makedirs(os.path.dirname(cache_path), exist_ok=True)
        np.savez(cache_path, **host)
    return device_scene(host), cfg


EXAMPLES = {
    "cornell_box": cornell_box,
    "single_model": single_model,
    "sky_dome": sky_dome,
    "spectral_box": spectral_box,
    "veach_bdpt": veach_bdpt,
    "prism_rainbow": prism_rainbow,
    "benchmark_100k": benchmark_100k,
}


def cached_host_build(key: str, make_host, cache: bool = True) -> dict:
    """Host-array dict from `make_host()` with an npz disk cache under
    .cache/, keyed by `key` AND scene.build.BUILD_FORMAT_VERSION (same
    contract as benchmark_100k's cache: bump the version constant when
    the builder/packs/cluster layout changes).  Skips the mesh/BVH/
    cluster build and — decisively for the multichip dryrun's cold
    budget — its per-process jit compiles (karras topology alone costs
    minutes under the dryrun's 5-way CPU contention)."""
    import os

    from ti_raytrace_tpu.scene.build import BUILD_FORMAT_VERSION

    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        ".cache", f"scene_{key}_v{BUILD_FORMAT_VERSION}.npz",
    )
    if cache and os.path.exists(path):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    host = make_host()
    if cache:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        # atomic publish: concurrent dryrun sections may build the same
        # scene; a torn npz must never be observable
        tmp = f"{path}.{os.getpid()}.tmp.npz"  # np.savez appends .npz
        np.savez(tmp, **host)
        os.replace(tmp, path)
    return host


def example_cached(name: str, cache: bool = True):
    """EXAMPLES[name]() with the built host arrays cached on disk.

    Wraps the example's single SceneBuilder.build() call in
    cached_host_build, so repeat runs (CLI re-renders, the five dryrun
    section subprocesses) load an npz instead of re-running the ~1-10 s
    build and re-compiling its jits in every fresh process."""
    from ti_raytrace_tpu.scene.data import device_scene

    if name == "benchmark_100k":  # has its own target-keyed cache
        return benchmark_100k(cache=cache)

    orig = SceneBuilder.build

    def cached_build(self, smooth_normals=False, spectral=False):
        host = cached_host_build(
            name,
            lambda: self.build_host(smooth_normals, spectral),
            cache=cache,
        )
        return device_scene(host)

    SceneBuilder.build = cached_build
    try:
        return EXAMPLES[name]()
    finally:
        SceneBuilder.build = orig


def framing_params(scene, cfg: ExampleConfig):
    """The example's framing rule as orbit-rig parameters
    (target, yaw, pitch, scale) — cornell_box.py:26-30 etc."""
    if cfg.fixed_scale is not None:
        target = np.asarray(cfg.fixed_target or (0.0, 0.0, 0.0))
        return target, cfg.yaw, cfg.pitch, cfg.fixed_scale
    lo = np.asarray(scene.aabb_min)
    hi = np.asarray(scene.aabb_max)
    centre = 0.5 * (lo + hi)
    scale = float(np.linalg.norm(hi - lo)) * cfg.scale_mult
    return centre, cfg.yaw, cfg.pitch, scale


def make_camera(scene, cfg: ExampleConfig, width: int, height: int):
    """Apply the example's framing rule (cornell_box.py:26-30 etc.)."""
    spec = CameraSpec(width, height)
    target, yaw, pitch, scale = framing_params(scene, cfg)
    return spec, orbit_camera(target, yaw, pitch, scale)
