"""Integrator-level tests (CPU, small films): determinism, checkpoint
resume, camera geometry, PT statistical sanity, BDPT smoke, sharding."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ti_raytrace_tpu import film as film_mod
from ti_raytrace_tpu.camera import CameraSpec, orbit_camera, project, ray_directions, ray_origins
from ti_raytrace_tpu.examples.scenes import EXAMPLES, make_camera


@pytest.fixture(scope="module")
def cornell():
    scene, cfg = EXAMPLES["cornell_box"]()
    spec, cam = make_camera(scene, cfg, 32, 32)
    return scene, cfg, spec, cam


def test_camera_center_ray(cornell):
    _, _, spec, cam = cornell
    d = np.asarray(ray_directions(spec, cam, jnp.int32(0), jax.random.PRNGKey(0)))
    d = d.reshape(spec.width, spec.height, 3)
    centre_dir = d[spec.width // 2, spec.height // 2]
    # camera orbits at yaw=0 -> looks along -z
    assert centre_dir[2] < -0.99
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-5)


def test_camera_project_roundtrip(cornell):
    _, _, spec, cam = cornell
    key = jax.random.PRNGKey(1)
    d = ray_directions(spec, cam, jnp.int32(0), key)
    o = ray_origins(spec, cam)
    pts = o + 3.0 * d  # points along each pixel's ray
    px, py, _, valid = project(spec, cam, pts)
    xi = np.arange(spec.width).repeat(spec.height)
    yi = np.tile(np.arange(spec.height), spec.width)
    ok = np.asarray(valid)
    assert ok.mean() > 0.95
    assert (np.abs(np.asarray(px)[ok] - xi[ok]) <= 1).all()
    assert (np.abs(np.asarray(py)[ok] - yi[ok]) <= 1).all()


def test_pt_rgb_deterministic(cornell):
    from ti_raytrace_tpu.integrators import pt_rgb

    scene, _, spec, cam = cornell
    k = jax.random.PRNGKey(7)
    a = np.asarray(pt_rgb.render_frame(scene, spec, cam, jnp.int32(1), k))
    b = np.asarray(pt_rgb.render_frame(scene, spec, cam, jnp.int32(1), k))
    np.testing.assert_array_equal(a, b)


def test_pt_rgb_statistics(cornell):
    """Light pixels bright, walls colored correctly, energy plausible."""
    from ti_raytrace_tpu.integrators import pt_rgb

    scene, cfg, spec, cam = cornell
    fl = film_mod.new_film(32, 32)
    for _ in range(8):
        fl = film_mod.accumulate(
            fl, pt_rgb.render_frame(scene, spec, cam, fl.frame, fl.key)
        )
    hdr = np.asarray(fl.hdr)
    assert np.isfinite(hdr).all() and hdr.min() >= 0.0
    # left column lanes see the red wall: red channel dominates
    left = hdr[2:6, 8:24].mean(axis=(0, 1))
    right = hdr[26:30, 8:24].mean(axis=(0, 1))
    assert left[0] > 2.0 * left[1]
    assert right[1] > 2.0 * right[0]
    # ceiling light region is the brightest thing in frame
    assert hdr.max() >= 5.0


def test_film_checkpoint_resume(tmp_path, cornell):
    from ti_raytrace_tpu.integrators import pt_rgb

    scene, _, spec, cam = cornell

    def advance(fl, n):
        for _ in range(n):
            fl = film_mod.accumulate(
                fl, pt_rgb.render_frame(scene, spec, cam, fl.frame, fl.key)
            )
        return fl

    straight = advance(film_mod.new_film(32, 32, seed=3), 4)

    half = advance(film_mod.new_film(32, 32, seed=3), 2)
    p = str(tmp_path / "ckpt.npz")
    film_mod.save_checkpoint(half, p)
    resumed = advance(film_mod.load_checkpoint(p), 2)

    np.testing.assert_allclose(
        np.asarray(straight.hdr), np.asarray(resumed.hdr), rtol=1e-6
    )
    assert int(resumed.frame) == 4


def test_debug_aovs(cornell):
    from ti_raytrace_tpu.integrators import debug

    scene, _, spec, cam = cornell
    for aov in ("albedo", "normal", "gnormal", "fnormal", "depth", "prim"):
        img = np.asarray(
            debug.render_frame(scene, spec, cam, 0, jax.random.PRNGKey(0), aov=aov)
        )
        assert img.shape == (32, 32, 3)
        assert np.isfinite(img).all()


@pytest.mark.slow
def test_bdpt_rgb_smoke(cornell):
    from ti_raytrace_tpu.integrators import bdpt_rgb

    scene, _, spec, cam = cornell
    img = np.asarray(
        bdpt_rgb.render_frame(scene, spec, cam, jnp.int32(1), jax.random.PRNGKey(2))
    )
    assert img.shape == (32, 32, 3)
    assert np.isfinite(img).all() and img.min() >= 0.0
    assert img.max() > 0.0


def test_sharded_matches_shape(cornell):
    from ti_raytrace_tpu.integrators import pt_rgb
    from ti_raytrace_tpu.parallel.shard import (
        make_mesh,
        render_frame_sharded,
        replicate_scene,
    )

    scene, _, spec, cam = cornell
    mesh = make_mesh()
    assert mesh.size == 8  # conftest forces 8 CPU devices
    scene_r = replicate_scene(scene, mesh)
    # one outer jit: eager ops on 8-way-sharded values cost ~100 ms each
    img = jax.jit(lambda s, c, fr, k: render_frame_sharded(
        pt_rgb.trace_paths, s, spec, c, fr, k, mesh
    ))(scene_r, cam, jnp.int32(1), jax.random.PRNGKey(0))
    img = np.asarray(img)
    assert img.shape == (32, 32, 3)
    assert img.mean() > 0.01


def _sharded_bdpt_mirror(cornell, max_depth: int):
    """8-device BDPT (psum splat reduction) vs the same computation run
    shard-by-shard on one device: identical per-shard keys, radiance
    shards concatenated, splat films summed."""
    from ti_raytrace_tpu.integrators import bdpt_rgb
    from ti_raytrace_tpu.parallel.shard import (
        make_mesh,
        render_bdpt_frame_sharded,
        replicate_scene,
    )

    scene, _, spec, cam = cornell
    mesh = make_mesh()
    scene_r = replicate_scene(scene, mesh)
    key = jax.random.PRNGKey(5)
    # ONE outer jit: eagerly-dispatched ops on 8-way-sharded values cost
    # ~100 ms each on the virtual-device CPU backend — unjitted, this
    # call alone took 7 of the quick tier's 15 minutes
    img_sharded = np.asarray(
        jax.jit(lambda s, c, fr, k: render_bdpt_frame_sharded(
            s, spec, c, fr, k, mesh, max_depth=max_depth)
        )(scene_r, cam, jnp.int32(1), key)
    )

    # single-device mirror with the exact shard key discipline
    from ti_raytrace_tpu.camera import ray_directions, ray_origins

    k_cam, k_eye, k_light, k_conn = jax.random.split(key, 4)
    o = jnp.swapaxes(ray_origins(spec, cam), 0, 1)
    d = jnp.swapaxes(ray_directions(spec, cam, jnp.int32(1), k_cam), 0, 1)
    N = spec.width * spec.height
    ns = N // mesh.size
    parts = []
    splat_total = jnp.zeros((spec.width, spec.height, 3), jnp.float32)

    @jax.jit  # same shapes every shard: compile once, execute 8x
    def one_shard(o_sl, d_sl, i):
        eye, eye_count = bdpt_rgb.build_eye_path_rays(
            scene, o_sl, d_sl, jax.random.fold_in(k_eye, i),
            eye_depth=max_depth + 2,
        )
        light, light_count = bdpt_rgb.build_light_path(
            scene, ns, jax.random.fold_in(k_light, i),
            light_depth=max_depth + 1,
        )
        return bdpt_rgb._connections(
            scene, spec, cam, eye, eye_count, light, light_count,
            jax.random.fold_in(k_conn, i), max_depth=max_depth,
        )

    for i in range(mesh.size):
        sl = slice(i * ns, (i + 1) * ns)
        radiance, splat = one_shard(o[:, sl], d[:, sl], jnp.int32(i))
        parts.append(jnp.swapaxes(radiance, 0, 1))
        splat_total = splat_total + splat
    img_ref = np.asarray(
        jnp.concatenate(parts, 0).reshape(spec.width, spec.height, 3)
        + splat_total
    )
    assert img_sharded.shape == img_ref.shape == (32, 32, 3)
    assert img_sharded.mean() > 0.0
    np.testing.assert_allclose(img_sharded, img_ref, rtol=1e-4, atol=1e-5)


def test_sharded_bdpt_matches_single_device(cornell):
    """Depth shrunk to 1 (9 strategy families incl. the e=1 splat): the
    sharding semantics don't depend on depth, and the full graph takes
    ~12 min to partition on the CPU backend (see
    test_sharded_bdpt_full_depth for the full-graph partition check).
    QUICK tier on purpose — the default run must catch sharding
    regressions."""
    _sharded_bdpt_mirror(cornell, max_depth=1)


@pytest.mark.slow
@pytest.mark.full_graph
def test_sharded_bdpt_full_depth(cornell):
    """The FULL ~30-strategy BDPT graph partitioned over 8 devices —
    the expensive end-to-end sharding proof.
    Run explicitly: pytest -m full_graph tests/test_render.py"""
    from ti_raytrace_tpu.integrators import bdpt_rgb

    _sharded_bdpt_mirror(cornell, max_depth=bdpt_rgb.MAX_DEPTH)


def test_pt_spec_smoke():
    from ti_raytrace_tpu.integrators import pt_spec

    scene, cfg = EXAMPLES["spectral_box"]()
    spec, cam = make_camera(scene, cfg, 16, 16)
    render = pt_spec.make_render_frame(**cfg.sky)
    img = np.asarray(render(scene, spec, cam, jnp.int32(1), jax.random.PRNGKey(0)))
    assert img.shape == (16, 16, 3)
    assert np.isfinite(img).all()
    assert img.max() > 0.0


def test_debug_obj_and_node_dump(tmp_path, cornell):
    from ti_raytrace_tpu.accel.lbvh import dump_nodes
    from ti_raytrace_tpu.io.assets import asset_path
    from ti_raytrace_tpu.scene.build import SceneBuilder

    b = SceneBuilder()
    b.add_obj(asset_path("model/cornell_box.obj"))
    p = str(tmp_path / "debug.obj")
    b.write_debug_obj(p)
    from ti_raytrace_tpu.io.obj import load_obj

    back = load_obj(p)
    assert back.triangle_count() == 36

    scene, _, _, _ = cornell
    dump_nodes(
        dict(
            bvh_min=scene.bvh_min, bvh_max=scene.bvh_max,
            bvh_prim=scene.bvh_prim, bvh_escape=scene.bvh_escape,
        ),
        str(tmp_path / "nodelist.txt"),
    )
    lines = open(tmp_path / "nodelist.txt").read().strip().splitlines()
    assert len(lines) == 2 * 36 - 1


def test_camera_orbit_helpers():
    from ti_raytrace_tpu.camera import orbit_pitch, orbit_yaw

    y, st = orbit_yaw((0, 0, 0), 0.0, 0.0, 3.0)
    assert y == 0.003 and st.eye.shape == (3,)
    p, st = orbit_pitch((0, 0, 0), 0.0, 0.49, 3.0)
    assert abs(p - 0.493) < 1e-9
    p2, _ = orbit_pitch((0, 0, 0), 0.0, 0.51, 3.0)
    assert p2 == 0.51  # clamped at the limit


def test_compaction_matches_exact():
    """Wavefront compaction is a performance mode: on a glass scene with
    early-terminating paths it must agree with the exact render."""
    from ti_raytrace_tpu.integrators import pt_rgb

    scene, cfg = EXAMPLES["single_model"]()
    spec, cam = make_camera(scene, cfg, 32, 32)

    def render(compaction, n=6):
        # max_depth 6: the parity property is depth-independent and the
        # full 15-bounce graph doubles this test's compile time
        fl = film_mod.new_film(32, 32, seed=11)
        for _ in range(n):
            fl = film_mod.accumulate(
                fl,
                pt_rgb.render_frame(
                    scene, spec, cam, fl.frame, fl.key, compaction,
                    max_depth=6,
                ),
            )
        return np.asarray(fl.hdr)

    exact = render(None)
    compacted = render(((1, 2), (4, 8)))
    # same seeds -> identical sampling decisions for surviving paths;
    # only capacity cuts may differ
    assert abs(compacted.mean() - exact.mean()) / max(exact.mean(), 1e-9) < 0.02


def test_merged_group1_matches_sequential():
    """render_film_frames_merged(group=1) must replay render_film_frames'
    exact RNG stream and phase structure — the merged path's contract."""
    from ti_raytrace_tpu.integrators import pt_rgb

    scene, cfg = EXAMPLES["single_model"]()
    spec, cam = make_camera(scene, cfg, 32, 32)
    nee = pt_rgb.has_nee_materials(scene)
    sched = ((1, 2), (4, 8))

    fl_s = film_mod.new_film(32, 32, seed=13)
    fl_s, ov_s = pt_rgb.render_film_frames(scene, spec, cam, fl_s, 2, sched,
                                           nee, max_depth=6)
    fl_m = film_mod.new_film(32, 32, seed=13)
    fl_m, ov_m = pt_rgb.render_film_frames_merged(
        scene, spec, cam, fl_m, 2, 1, sched, nee, max_depth=6
    )
    assert int(fl_m.frame) == int(fl_s.frame) == 2
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(fl_m.key)),
        np.asarray(jax.random.key_data(fl_s.key)),
    )
    assert int(ov_m) == int(ov_s)
    np.testing.assert_allclose(
        np.asarray(fl_m.hdr), np.asarray(fl_s.hdr), rtol=1e-5, atol=1e-6
    )


@pytest.mark.slow
def test_merged_group2_consistent():
    """group=2 merging changes only the RNG stream of merged bounces.
    SLOW tier: group-2 merged bookkeeping is already covered bit-exactly
    in the quick tier by test_shard_production's per-shard mirror; this
    adds the merged-vs-sequential statistical cross-check.
    Camera rays stay on the film key chain, so pixels whose primary rays
    miss in every frame are BIT-identical (sharp check of the g*N pixel
    bookkeeping); hit pixels agree statistically."""
    from ti_raytrace_tpu.integrators import pt_rgb

    scene, cfg = EXAMPLES["single_model"]()
    spec, cam = make_camera(scene, cfg, 32, 32)
    nee = pt_rgb.has_nee_materials(scene)
    sched = ((1, 2), (4, 8))
    n = 4

    fl_s = film_mod.new_film(32, 32, seed=13)
    fl_s, _ = pt_rgb.render_film_frames(scene, spec, cam, fl_s, n, sched, nee,
                                        max_depth=6)
    fl_m = film_mod.new_film(32, 32, seed=13)
    fl_m, ov = pt_rgb.render_film_frames_merged(
        scene, spec, cam, fl_m, n, 2, sched, nee, max_depth=6
    )
    a = np.asarray(fl_s.hdr)
    b = np.asarray(fl_m.hdr)
    assert np.isfinite(b).all() and b.min() >= 0.0
    assert int(ov) == 0
    # env-only pixels identical in both modes (same camera jitter chain)
    same = np.isclose(a, b, rtol=1e-4).all(axis=-1)
    assert same.mean() > 0.2, same.mean()
    # overall energy agrees despite the different merged-bounce stream
    # (tolerance sized for the 4-frame run: same.mean() is n-independent)
    assert abs(b.mean() - a.mean()) / max(a.mean(), 1e-9) < 0.2


def test_merged_pay_divisors_exact():
    """The fused flush+compact (pay_divisors) banks every lane's payload
    exactly once — with enough tail capacity it must reproduce the plain
    flush+compact path (same RNG, same widths, zero overflow)."""
    from ti_raytrace_tpu.integrators import pt_rgb

    scene, cfg = EXAMPLES["single_model"]()
    spec, cam = make_camera(scene, cfg, 32, 32)
    nee = pt_rgb.has_nee_materials(scene)
    sched = ((1, 2), (4, 8))

    fl_p = film_mod.new_film(32, 32, seed=13)
    fl_p, ov_p = pt_rgb.render_film_frames_merged(
        scene, spec, cam, fl_p, 2, 2, sched, nee, max_depth=6
    )
    fl_f = film_mod.new_film(32, 32, seed=13)
    fl_f, ov_f = pt_rgb.render_film_frames_merged(
        scene, spec, cam, fl_f, 2, 2, sched, nee, pay_divisors=(1,),
        max_depth=6
    )
    assert int(ov_p) == int(ov_f) == 0
    np.testing.assert_allclose(
        np.asarray(fl_f.hdr), np.asarray(fl_p.hdr), rtol=1e-6, atol=1e-7
    )


def test_calibrate_compaction_glass_scene():
    from ti_raytrace_tpu.integrators import pt_rgb

    scene, cfg = EXAMPLES["single_model"]()
    spec, cam = make_camera(scene, cfg, 32, 32)
    sched = pt_rgb.calibrate_compaction(scene, spec, cam, probe_size=32)
    # glass + env scene: paths die early -> a non-trivial schedule
    assert sched is not None and len(sched) >= 1
    starts = [s for s, _ in sched]
    divs = [d for _, d in sched]
    assert starts == sorted(starts)
    assert all(d2 >= 2 * d1 for d1, d2 in zip(divs, divs[1:]))


@pytest.mark.slow
def test_bdpt_sliced_consistent(cornell):
    """Sliced BDPT must produce a valid frame of the same magnitude as the
    unsliced path (RNG decorrelates per slice, so compare statistics)."""
    from ti_raytrace_tpu.integrators import bdpt_rgb

    scene, _, spec, cam = cornell
    k = jax.random.PRNGKey(9)
    full = np.zeros((32, 32, 3), np.float32)
    sliced = np.zeros((32, 32, 3), np.float32)
    for i in range(6):
        kk = jax.random.fold_in(k, i)
        full += np.asarray(bdpt_rgb.render_frame(scene, spec, cam, jnp.int32(1), kk))
        sliced += np.asarray(
            bdpt_rgb.render_frame_sliced(scene, spec, cam, jnp.int32(1), kk, 2)
        )
    full /= 6
    sliced /= 6
    assert np.isfinite(sliced).all() and sliced.min() >= 0.0
    assert abs(sliced.mean() - full.mean()) / full.mean() < 0.15
