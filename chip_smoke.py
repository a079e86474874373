"""On-card smoke test of the renderer's main path.

    python chip_smoke.py              # one GPU: phases 1-6 below
    python chip_smoke.py --four       # four GPUs: the sharded paths only
    python chip_smoke.py --rehearse   # CPU, tiny sizes, kernel interpreted

One process holds one card (or, with --four, four).  Phases, in order:

1. device report: jax.devices(), device kind, JAX version, and the
   cards' name and power limit from nvidia-smi (a child process).
2. tracer parity: the compiled cluster kernel against the threaded-BVH
   oracle (accel/traverse.trace_closest) on benchmark_100k, in both
   wavefront regimes, on camera rays, with the tmax bound and with the
   active/cap_frac capacity path; the dense tracer against the same
   oracle on cornell_box and prism_rainbow.
3. main path: benchmark_100k at 512^2 through bench.py's merged
   progressive renderer, once with the cluster kernel and once with the
   plain XLA tracer (oracle + attribute gather) swapped in here; images
   compared, ms/frame timed in turns (kernel, XLA, XLA, kernel).
4. breadth: the CLI (examples.run.main) on all six example scenes.
5. fidelity: tools/golden on cornell_box and sky_dome, inside
   tools/golden_bounds.json.
6. the last line: {"ok": true, "device": {...}}.

No phase catches its own failure: any failed check raises and the
process exits non-zero without printing the last line.  Outputs (PNGs)
go to chiprun_out/smoke/.
"""

import argparse
import contextlib
import functools
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out", "smoke")

# tracer parity tolerances (phase 2): hit distances agree to f32
# reformulation error (kernel and oracle use different intersection
# algebra); a differing prim is allowed only at a tie, where the
# kernel's distance equals the oracle's closest hit to within TIE_RTOL
# (two triangles sharing the hit point, e.g. a ray through an edge)
T_RTOL, T_ATOL = 1e-4, 1e-5
TIE_RTOL = 1e-5
# main-path image agreement (phase 3): both tracers run the same
# estimator on the same random numbers, so images differ only where a
# path diverges on an f32 tie or a last-bit difference of t.  The image
# means must agree to 1% (a tracer bias far smaller than that shows) and
# the mean absolute pixel difference must stay under 5% of the mean
# (divergent paths are rare: well under a tenth of the pixels)
IMG_MEAN_RTOL = 0.01
IMG_MAD_RTOL = 0.05


def log(*a):
    print(*a, flush=True)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


@contextlib.contextmanager
def phase(name):
    log(f"== phase {name}")
    t0 = time.perf_counter()
    yield
    log(f"== phase {name}: ok in {time.perf_counter() - t0:.1f} s")


# --------------------------------------------------------------- sizes
FULL = dict(
    rays=262144, small_rays=32768, dense_rays=65536,
    bench_size=512, bench_kf=16, bench_group=16,
    pt_size=512, pt_frames=32, bdpt_size=256, bdpt_frames=2,
    golden=(("cornell_box", 64), ("sky_dome", 32)), golden_size=512,
    four_pt_size=512, four_kf=16, four_group=16, four_bdpt_size=256,
)
TINY = dict(
    rays=512, small_rays=256, dense_rays=256,
    bench_size=16, bench_kf=2, bench_group=2,
    pt_size=16, pt_frames=2, bdpt_size=8, bdpt_frames=2,
    golden=(("cornell_box", 1), ("sky_dome", 1)), golden_size=16,
    four_pt_size=16, four_kf=2, four_group=2, four_bdpt_size=8,
)
SCENES = ("cornell_box", "single_model", "sky_dome", "spectral_box",
          "veach_bdpt", "prism_rainbow")


# ------------------------------------------------------ phase 1: device
def device_report(rehearse: bool, n_cards: int):
    import jax

    from ti_raytrace_tpu.core.runtime import card_name_and_power, device_info

    log(f"jax {jax.__version__}, devices: {jax.devices()}")
    info = device_info()
    log(f"device kind: {info['kind']}, count: {info['count']}")
    if rehearse:
        check(info["platform"] == "cpu", f"rehearsal ran on {info}")
        log("nvidia-smi: not queried (CPU rehearsal)")
    else:
        check(info["platform"] == "gpu",
              f"no GPU: JAX's default platform is {info['platform']!r}")
        log(f"nvidia-smi: {card_name_and_power()}")
    check(info["count"] >= n_cards,
          f"need {n_cards} devices, JAX found {info['count']}")
    return info


# ---------------------------------------------- phase 2: tracer parity
def _rays(scene, n, seed):
    """Incoherent rays: half from outside aimed at jittered points of the
    scene box, a quarter from near its centre, a quarter from anywhere,
    the last two in random directions."""
    import jax.numpy as jnp
    import numpy as np

    rng = np.random.default_rng(seed)
    lo = np.asarray(scene.aabb_min)
    hi = np.asarray(scene.aabb_max)
    c = 0.5 * (lo + hi)
    r = float(np.linalg.norm(hi - lo))
    na, nb = n // 2, n // 4
    nc = n - na - nb
    o = np.concatenate([
        c + rng.normal(size=(na, 3)) * r,
        c + rng.normal(size=(nb, 3)) * r * 0.05,
        c + rng.normal(size=(nc, 3)) * r * 0.5,
    ])
    d = np.concatenate([
        c + rng.normal(size=(na, 3)) * (hi - lo) * 0.25 - o[:na],
        rng.normal(size=(n - na, 3)),
    ])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o.T, jnp.float32), jnp.asarray(d.T, jnp.float32)


def _camera_rays(scene, n, seed):
    """One pinhole origin aimed at jittered points around the scene."""
    import jax.numpy as jnp
    import numpy as np

    rng = np.random.default_rng(seed)
    lo = np.asarray(scene.aabb_min)
    hi = np.asarray(scene.aabb_max)
    c = 0.5 * (lo + hi)
    eye = c + np.array([0.3, 0.4, 1.0]) * float(np.linalg.norm(hi - lo))
    tgt = c[None] + rng.normal(size=(n, 3)) * (hi - lo)[None] * 0.3
    d = tgt - eye[None]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.broadcast_to(eye[None], (n, 3))
    return (jnp.asarray(o.T, jnp.float32), jnp.asarray(d.T, jnp.float32))


@functools.lru_cache(maxsize=None)
def _oracle():
    import jax
    import jax.numpy as jnp

    from ti_raytrace_tpu.accel.traverse import trace_closest

    return jax.jit(lambda s, o, d: trace_closest(
        s, jnp.swapaxes(o, 0, 1), jnp.swapaxes(d, 0, 1)))


def compare_to_oracle(label, scene, o, d, t, prim, attr=None, ref=None):
    """Phase-2 pass conditions of one traced wavefront; returns the
    oracle's (t, prim) for reuse."""
    import numpy as np

    from ti_raytrace_tpu.core import constants as C

    t_ref, p_ref = ref if ref is not None else _oracle()(scene, o, d)
    t, prim = np.asarray(t), np.asarray(prim)
    t_ref, p_ref = np.asarray(t_ref), np.asarray(p_ref)
    hit = p_ref >= 0
    miss_ok = (prim[~hit] == -1) & (t[~hit] >= C.INF)
    t_ok = np.isclose(t[hit], t_ref[hit], rtol=T_RTOL, atol=T_ATOL)
    differ = hit & (prim != p_ref)
    tie = differ & np.isclose(t, t_ref, rtol=TIE_RTOL, atol=0.0)
    ties = int(tie.sum())
    msg = (f"{label}: rays={t.shape[0]} hits={int(hit.sum())} "
           f"t_match={int(t_ok.sum())}/{int(hit.sum())} "
           f"miss_match={int(miss_ok.sum())}/{int((~hit).sum())} "
           f"prim_differ={int(differ.sum())} (ties {ties}, max rel t diff "
           f"{_max_rel(t[differ], t_ref[differ]):.2e})")
    if attr is not None:
        pa = np.asarray(scene.prim_attr)
        want = np.where((prim >= 0)[None], pa[:, np.maximum(prim, 0)], 0.0)
        attr_exact = np.array_equal(np.asarray(attr), want)
        msg += f" attr_bit_exact={attr_exact}"
    log(msg)
    check(hit.sum() > t.shape[0] // 20, f"{label}: too few hits to mean much")
    check(t_ok.all(), f"{label}: hit distances disagree with the oracle")
    check(miss_ok.all(), f"{label}: misses disagree with the oracle")
    check(ties == int(differ.sum()), f"{label}: prims differ off a tie")
    if attr is not None:
        check(attr_exact, f"{label}: attribute record is not bit-exact")
    return t_ref, p_ref


def _max_rel(a, b):
    import numpy as np

    return float(np.max(np.abs(a - b) / np.abs(b))) if a.size else 0.0


def tracer_parity(sizes, interpret: bool):
    import jax.numpy as jnp
    import numpy as np

    from ti_raytrace_tpu.accel import DENSE_MAX_PRIMS
    from ti_raytrace_tpu.core import constants as C
    from ti_raytrace_tpu.examples.scenes import benchmark_100k, example_cached
    from ti_raytrace_tpu.ops import cluster_trace as ct
    from ti_raytrace_tpu.ops.dense_trace import trace_shaded as dense_shaded

    scene, _ = benchmark_100k()
    log(f"benchmark_100k: {scene.n_prims} prims, "
        f"{scene.cluster_bounds.shape[1]} clusters; "
        f"kernel {'interpreted' if interpret else 'compiled'}; "
        f"f32 throughout; tolerances t rtol {T_RTOL} atol {T_ATOL}, "
        f"ties rtol {TIE_RTOL}, attributes bit-exact")
    n, ns = sizes["rays"], sizes["small_rays"]
    o, d = _rays(scene, n, seed=0)

    # small-wavefront regime: static order, no sort
    check(ns <= ct.SMALL_WAVEFRONT, "static-order case must be small")
    t, prim, _, attr = ct.trace_clustered(scene, o[:, :ns], d[:, :ns],
                                          interpret=interpret, want_attr=True)
    compare_to_oracle("static order", scene, o[:, :ns], d[:, :ns], t, prim,
                      attr)

    # sorted regime with per-block order (forced at rehearsal sizes)
    sort_small = n <= ct.SMALL_WAVEFRONT
    t0, prim0, _, attr = ct.trace_clustered(
        scene, o, d, interpret=interpret, want_attr=True,
        sort_small=sort_small)
    ref = compare_to_oracle("sorted per-block order", scene, o, d, t0, prim0,
                            attr)

    # camera rays: one shared origin, one shared cluster order
    oc, dc = _camera_rays(scene, n, seed=1)
    t, prim, _, attr = ct.trace_clustered(
        scene, oc, dc, interpret=interpret, want_attr=True, sort_rays=False,
        shared_origin=oc[:, 0])
    compare_to_oracle("camera, shared origin", scene, oc, dc, t, prim, attr)

    # tmax: a bound beyond every hit changes nothing; one in front of
    # every hit leaves only misses
    t0, prim0 = np.asarray(t0), np.asarray(prim0)
    hit = prim0 >= 0
    finite = np.where(hit, t0, 1.0)
    t1, prim1, _ = ct.trace_clustered(scene, o, d, interpret=interpret,
                                      sort_small=sort_small,
                                      tmax=jnp.asarray(finite * 2.0))
    compare_to_oracle("tmax beyond hits", scene, o, d, t1, prim1, ref=ref)
    t2, prim2, _ = ct.trace_clustered(scene, o, d, interpret=interpret,
                                      sort_small=sort_small,
                                      tmax=jnp.asarray(finite * 0.5))
    check((np.asarray(prim2) == -1).all() and (np.asarray(t2) >= C.INF).all(),
          "tmax in front of hits: not every lane missed")
    log("tmax in front of hits: all lanes miss")

    # capacity path: 40% active lanes; ample capacity is exact on the
    # actives and misses the parked lanes; a short one cuts only actives
    active = np.random.default_rng(3).random(n) < 0.4
    ja = jnp.asarray(active)
    t3, prim3, _ = ct.trace_clustered(scene, o, d, interpret=interpret,
                                      sort_small=sort_small, active=ja,
                                      cap_frac=0.75)
    t3, prim3 = np.asarray(t3), np.asarray(prim3)
    check(np.array_equal(prim3[active], prim0[active])
          and np.array_equal(t3[active], t0[active]),
          "capacity 0.75: active lanes differ from the unmasked trace")
    check((prim3[~active] == -1).all() and (t3[~active] >= C.INF).all(),
          "capacity 0.75: parked lanes did not miss")
    cap = ct.capacity_lanes(n, 0.25)
    t4, prim4, _ = ct.trace_clustered(scene, o, d, interpret=interpret,
                                      sort_small=sort_small, active=ja,
                                      cap_frac=0.25)
    t4, prim4 = np.asarray(t4), np.asarray(prim4)
    kept = active & (prim4 == prim0) & ((t4 == t0) | (prim0 == -1))
    cut = active & (prim4 == -1) & (t4 >= C.INF)
    check((kept | cut)[active].all() and (prim4[~active] == -1).all(),
          "capacity 0.25: a lane is neither exact nor cut")
    log(f"capacity: 0.75 exact on {int(active.sum())} actives; 0.25 keeps "
        f"{int((kept & (prim0 >= 0)).sum())} hits, cuts {int((cut & (prim0 >= 0)).sum())} "
        f"(capacity {cap} lanes)")

    # dense tracer on the small scenes
    for name in ("cornell_box", "prism_rainbow"):
        sc, _ = example_cached(name)
        check(sc.n_prims <= DENSE_MAX_PRIMS, f"{name} is not a dense scene")
        od, dd = _rays(sc, sizes["dense_rays"], seed=2)
        t, prim, _, attr = dense_shaded(sc, od, dd)
        compare_to_oracle(f"dense {name}", sc, od, dd, t, prim, attr)


# -------------------------------------------------- phase 3: main path
_XLA_TRACES = [0]  # times xla_trace_clustered entered a traced graph


def xla_trace_clustered(scene, o, d, interpret=False, sort_rays=True,
                        want_attr=False, sort_small=False, shared_origin=None,
                        tile_order=False, tmax=None, active=None,
                        cap_frac=None):
    """The plain XLA tracer behind trace_clustered's contract: the
    threaded-BVH wavefront (accel/traverse.trace_closest), barycentrics
    of the winning triangle, and the attribute gather.  No capacity cut:
    every active lane is traced."""
    import jax.numpy as jnp

    from ti_raytrace_tpu.accel.traverse import trace_closest
    from ti_raytrace_tpu.core import constants as C

    del interpret, sort_rays, sort_small, shared_origin, tile_order, cap_frac
    _XLA_TRACES[0] += 1
    if active is not None:
        d = d * active[None, :].astype(d.dtype)
        o = jnp.where(active[None, :], o, 1e9)
    t, prim = trace_closest(scene, jnp.swapaxes(o, 0, 1),
                            jnp.swapaxes(d, 0, 1))
    if tmax is not None:
        beyond = (tmax > 0.0) & (t >= tmax)
        prim = jnp.where(beyond, -1, prim)
        t = jnp.where(beyond, C.INF, t)
    # barycentrics of the winning triangle (shape prims report 0)
    p = jnp.maximum(prim, 0)
    v0, e1, e2 = scene.tri_v0[p].T, scene.tri_e1[p].T, scene.tri_e2[p].T

    def cross(a, b):
        return jnp.stack([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                          a[0] * b[1] - a[1] * b[0]])

    pv = cross(d, e2)
    det = jnp.sum(e1 * pv, axis=0)
    inv = 1.0 / jnp.where(jnp.abs(det) > 1e-12, det, 1.0)
    tv = o - v0
    u = jnp.sum(tv * pv, axis=0) * inv
    v = jnp.sum(d * cross(tv, e1), axis=0) * inv
    tri = (prim >= 0) & (scene.prim_type[p] == C.PRIM_TRI)
    uv = jnp.where(tri[None], jnp.stack([u, v]), 0.0)
    if want_attr:
        attr = jnp.where(prim[None] >= 0, scene.prim_attr[:, p], 0.0)
        return t, prim, uv, attr
    return t, prim, uv


@contextlib.contextmanager
def xla_tracer():
    """Swap the plain XLA tracer in for the cluster kernel while a
    render graph is traced."""
    from ti_raytrace_tpu.ops import cluster_trace as ct

    kernel = ct.trace_clustered
    ct.trace_clustered = xla_trace_clustered
    try:
        yield
    finally:
        ct.trace_clustered = kernel


def main_path(sizes):
    import jax
    import numpy as np

    import bench
    from ti_raytrace_tpu import film as film_mod
    from ti_raytrace_tpu.integrators import pt_rgb

    size, kf, group = sizes["bench_size"], sizes["bench_kf"], sizes["bench_group"]
    scene, spec, cam, nee = bench.setup(size)
    step_k = bench.make_step(scene, spec, cam, nee, kf, group)
    # a second compiled instance of the same renderer, traced with the
    # XLA tracer swapped in.  A new function object: JAX reuses a traced
    # graph for the same function, whichever jit wraps it
    raw = pt_rgb.render_film_frames_merged.__wrapped__

    def merged(scene, spec, cam, film, n_frames, group, compaction, nee,
               pay_divisors=None):
        return raw(scene, spec, cam, film, n_frames, group, compaction, nee,
                   pay_divisors=pay_divisors)

    merged_x = jax.jit(merged, static_argnames=(
        "spec", "n_frames", "group", "compaction", "nee", "pay_divisors"))
    step_x = bench.make_step(scene, spec, cam, nee, kf, group, render=merged_x)

    films = {"kernel": film_mod.new_film(size, size),
             "xla": film_mod.new_film(size, size)}
    kills = {"kernel": 0, "xla": 0}
    steps = {"kernel": step_k, "xla": step_x}

    def dispatch(name):
        t0 = time.perf_counter()
        if name == "xla":
            with xla_tracer():
                fl, ov = steps[name](films[name])
        else:
            fl, ov = steps[name](films[name])
        fl.hdr.block_until_ready()
        films[name] = fl
        kills[name] += int(np.asarray(ov))
        return time.perf_counter() - t0

    for name in ("kernel", "xla"):
        log(f"{name}: compile + first {kf} frames {dispatch(name):.1f} s")
    check(_XLA_TRACES[0] > 0, "the XLA tracer never entered the render graph")
    times = {"kernel": [], "xla": []}
    for name in ("kernel", "xla", "xla", "kernel"):
        times[name].append(dispatch(name) / kf * 1e3)
    for name in ("kernel", "xla"):
        log(f"ms/frame {name}: "
            + ", ".join(f"{ms:.3f}" for ms in times[name])
            + f" ({size}x{size}, {kf} frames/dispatch, group {group})")
    log(f"compaction overflow kills: kernel {kills['kernel']}, "
        f"xla {kills['xla']}")

    img = {k: np.asarray(fl.hdr) for k, fl in films.items()}
    os.makedirs(OUT_DIR, exist_ok=True)
    for k, fl in films.items():
        film_mod.save_png(fl, os.path.join(OUT_DIR, f"bench_{k}.png"))
    mk, mx = float(img["kernel"].mean()), float(img["xla"].mean())
    mad = float(np.abs(img["kernel"] - img["xla"]).mean())
    log(f"image mean: kernel {mk:.6f}, xla {mx:.6f}; mean |diff| {mad:.6f} "
        f"(limits: means {IMG_MEAN_RTOL:.0%}, |diff| {IMG_MAD_RTOL:.0%} of "
        f"the mean)")
    check(np.isfinite(img["kernel"]).all(), "kernel image is not finite")
    check(mk > 0.0, "kernel image is black")
    check(kills["kernel"] == 0, "compaction overflow kills on the kernel path")
    check(abs(mk - mx) <= IMG_MEAN_RTOL * mx, "image means disagree")
    check(mad <= IMG_MAD_RTOL * mx, "images disagree")


# ------------------------------------------------------ phase 4: breadth
def breadth(sizes, rehearse: bool):
    import numpy as np

    from ti_raytrace_tpu.examples import run
    from ti_raytrace_tpu.examples.scenes import EXAMPLES

    os.makedirs(OUT_DIR, exist_ok=True)
    for name in SCENES:
        bdpt = EXAMPLES[name] in (EXAMPLES["veach_bdpt"],
                                  EXAMPLES["prism_rainbow"])
        size = sizes["bdpt_size"] if bdpt else sizes["pt_size"]
        frames = sizes["bdpt_frames"] if bdpt else sizes["pt_frames"]
        # two dispatches: the first holds the compile, the rate comes
        # from the second
        fl, rep = run.main([
            name, "--size", str(size), "--frames", str(frames),
            "--snapshot-every", str(frames // 2),
            "--out", os.path.join(OUT_DIR, f"{name}.png"),
        ] + (["--cpu"] if rehearse else []))
        hdr = np.asarray(fl.hdr)
        log(f"{name}: {size}x{size}, {frames} frames "
            f"{rep['frames_by_path']}, compile+first "
            f"{rep['compile_s']:.1f} s, {rep['fps']:.3f} fps, "
            f"mean {hdr.mean():.5f}")
        # a scene with a merged group must dispatch whole groups, or the
        # CLI renders it on the plain batched path instead
        check(rehearse or not rep["merged_group"]
              or set(rep["frames_by_path"]) == {"merged"},
              f"{name}: frames left its merged production path")
        check(np.isfinite(hdr).all(), f"{name}: image is not finite")
        check(hdr.max() > 0.0, f"{name}: image is black")


# ----------------------------------------------------- phase 5: fidelity
def fidelity(sizes, rehearse: bool):
    from ti_raytrace_tpu.tools import golden

    for name, frames in sizes["golden"]:
        if rehearse:
            # tiny renders cannot meet the 512^2 bounds: report the diff
            scene_name, integ, rel, _ = golden.TARGETS[name]
            img = golden.render_scene(scene_name, frames, sizes["golden_size"],
                                      integrator=integ)
            diff = golden.mean_abs_diff(img, golden.load_reference(rel))
            log(f"golden {name} (rehearsal size): diff {diff:.4f}")
            continue
        rc = golden.main(["--scene", name, "--frames", str(frames)])
        check(rc == 0, f"golden {name} is outside its bound")


# ------------------------------------------------ four cards (--four)
def four_cards(sizes):
    """Sharded PT (merged, benchmark_100k) and sharded BDPT (veach) over a
    4-device mesh at their production settings, each against its
    one-device mirror."""
    import jax

    from ti_raytrace_tpu.parallel.shard import make_mesh

    mesh = make_mesh(jax.devices()[:4])
    log(f"mesh: {mesh.size} devices, 1-D")
    four_pt(sizes, mesh)
    four_bdpt(sizes, mesh)


def four_pt(sizes, mesh):
    """Merged multi-frame PT, lane-sharded, on the bench schedule, against
    the same lane shards rendered one at a time on one card.  Each device
    compacts its own morton quarter of the image, so a schedule sized for
    the image mean can kill paths on a busy quarter: the kills are
    reported and must match the mirror's, not be zero."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench
    from ti_raytrace_tpu.camera import morton_pixel_order
    from ti_raytrace_tpu.examples.scenes import BENCH_SCHEDULE_MERGED
    from ti_raytrace_tpu.parallel.shard import (
        _merged_lane_shard, new_lane_film, render_film_frames_merged_sharded,
        replicate_scene)

    kf, group = sizes["four_kf"], sizes["four_group"]
    scene, spec, cam, nee = bench.setup(sizes["four_pt_size"])
    comp = BENCH_SCHEDULE_MERGED
    t0 = time.perf_counter()
    fl = new_lane_film(spec, mesh, seed=3)
    fl2, ov = render_film_frames_merged_sharded(
        replicate_scene(scene, mesh), spec, cam, fl, kf, group, comp, nee,
        mesh)
    hdr = np.asarray(fl2.hdr)
    log(f"sharded PT: {kf} frames in {time.perf_counter() - t0:.1f} s "
        f"(compile included), schedule {comp}, overflow kills {int(ov)}")

    W, H = spec.width, spec.height
    N = W * H
    perm, _ = morton_pixel_order(W, H)
    px = jnp.asarray((perm // H).astype(np.float32))
    py = jnp.asarray((perm % H).astype(np.float32))
    ns = N // mesh.size
    dev0 = jax.devices()[0]
    key0 = jax.random.PRNGKey(3)

    @jax.jit
    def one_shard(scene_, cam_, key_, i, px_sl, py_sl):
        return _merged_lane_shard(
            scene_, spec, cam_, jnp.zeros((3, ns), jnp.float32),
            jnp.zeros((), jnp.int32), key_, i, px_sl, py_sl,
            kf, group, comp, nee)

    parts, kills = [], []
    for i in range(mesh.size):
        sl = slice(i * ns, (i + 1) * ns)
        args = jax.device_put((scene, cam, key0, jnp.int32(i), px[sl],
                               py[sl]), dev0)
        out = one_shard(*args)
        parts.append(np.asarray(out[0]))
        kills.append(int(out[3]))
    ref = np.concatenate(parts, axis=1)
    log(f"one-card shards: overflow kills {kills}")
    _agree("sharded PT vs one-card shards", hdr, ref)
    check(int(ov) == sum(kills), "sharded PT: kills differ from the mirror")


def four_bdpt(sizes, mesh):
    """One BDPT frame on veach at full depth: psum'd splats over the mesh
    against the same 4 slices on one card."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ti_raytrace_tpu.examples.scenes import example_cached, make_camera
    from ti_raytrace_tpu.integrators import bdpt_rgb
    from ti_raytrace_tpu.parallel.shard import (render_bdpt_frame_sharded,
                                                replicate_scene)

    scene_b, cfg_b = example_cached("veach_bdpt")
    spec_b, cam_b = make_camera(scene_b, cfg_b, sizes["four_bdpt_size"],
                                sizes["four_bdpt_size"])
    key = jax.random.PRNGKey(5)
    t0 = time.perf_counter()
    img_s = np.asarray(jax.jit(lambda s, c, k: render_bdpt_frame_sharded(
        s, spec_b, c, jnp.int32(1), k, mesh))(
            replicate_scene(scene_b, mesh), cam_b, key))
    log(f"sharded BDPT (max_depth {bdpt_rgb.MAX_DEPTH}): one frame in "
        f"{time.perf_counter() - t0:.1f} s (compile included)")
    t0 = time.perf_counter()
    args = jax.device_put((scene_b, cam_b, key), jax.devices()[0])
    img_1 = np.asarray(bdpt_rgb.render_frame_sliced(
        args[0], spec_b, args[1], jnp.int32(1), args[2], n_slices=mesh.size))
    log(f"render_frame_sliced(4) on one card: {time.perf_counter() - t0:.1f} "
        f"s (compile included)")
    _agree("sharded BDPT vs render_frame_sliced(4)", img_s, img_1)


def _agree(label, a, b):
    """Same computation on a mesh and on one card: equal up to summation
    order, so allclose at rtol 1e-4 / atol 1e-5 on at least 99.9% of the
    values and image means within 1e-4."""
    import numpy as np

    check(a.shape == b.shape, f"{label}: shapes {a.shape} vs {b.shape}")
    close = np.isclose(a, b, rtol=1e-4, atol=1e-5)
    exact = float((a == b).mean())
    mean_rel = abs(float(a.mean()) - float(b.mean())) / max(float(b.mean()), 1e-12)
    log(f"{label}: bit-equal {exact:.6f}, close {close.mean():.6f}, "
        f"max |diff| {float(np.abs(a - b).max()):.3e}, "
        f"mean rel diff {mean_rel:.3e}")
    check(np.isfinite(a).all() and a.max() > 0.0, f"{label}: bad image")
    check(close.mean() >= 0.999 and mean_rel <= 1e-4, f"{label}: disagree")


# ------------------------------------------------------------------ main
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--four", action="store_true",
                    help="four cards: the sharded paths and their mirrors only")
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU at tiny sizes, cluster kernel interpreted")
    args = ap.parse_args(argv)

    if args.rehearse:
        # must precede the first backend use
        os.environ["JAX_PLATFORMS"] = "cpu"
        if args.four:
            flags = os.environ.get("XLA_FLAGS", "")
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=4").strip()
    sys.path.insert(0, HERE)
    from ti_raytrace_tpu.core.runtime import setup_compile_cache

    setup_compile_cache()
    sizes = TINY if args.rehearse else FULL
    n_cards = 4 if args.four else 1
    t_start = time.perf_counter()

    with phase("1 device report"):
        info = device_report(args.rehearse, n_cards)
    if args.four:
        with phase("four-card sharded paths"):
            four_cards(sizes)
    else:
        with phase("2 tracer parity"):
            tracer_parity(sizes, interpret=args.rehearse)
        with phase("3 main path"):
            main_path(sizes)
        with phase("4 breadth"):
            breadth(sizes, args.rehearse)
        with phase("5 fidelity"):
            fidelity(sizes, args.rehearse)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}}), flush=True)


if __name__ == "__main__":
    main()
