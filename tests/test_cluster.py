"""Cluster-stream tracer vs the threaded-BVH oracle (interpret mode).

The production tracer for large scenes (ops/cluster_trace.py) must agree
exactly with accel/traverse.trace_closest: hit distance, winning
primitive, and the attribute record must equal the prim_attr column of
that primitive bit for bit.  Runs on a small scene so Pallas interpret
mode stays fast; both wavefront regimes are covered (the small-wavefront
static-order path and the sorted per-block-order path share every
kernel line except the ordering inputs).  The compiled kernel is checked
against the same oracle on the card by chip_smoke.py (phase 2).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from ti_raytrace_tpu.accel.traverse import trace_closest
from ti_raytrace_tpu.core import constants as C
from ti_raytrace_tpu.io.assets import asset_path
from ti_raytrace_tpu.ops.cluster_trace import trace_clustered
from ti_raytrace_tpu.scene.build import MaterialRec, SceneBuilder, sphere_shape


@pytest.fixture(scope="module")
def sphere_scene():
    # Teapot: 25200 tris, all unique (sphere.obj triplicates most faces,
    # which makes prim-identity vs the oracle ambiguous on every tie).
    # Same geometry/material as the dryrun's cached teapot scene ->
    # shares its npz (skips the ~15 s build on warm runs).
    from ti_raytrace_tpu.examples.scenes import cached_host_build
    from ti_raytrace_tpu.scene.data import device_scene

    def make_host():
        b = SceneBuilder()
        b.add_obj(asset_path("model/Teapot.obj"))
        b.add_shape(sphere_shape([0.0, 20.0, 0.0], 5.0),
                    MaterialRec(C.MAT_LIGHT, color=[50.0] * 3))
        return b.build_host()

    return device_scene(cached_host_build("dryrun_teapot", make_host))


def _rays(scene, n, seed=0):
    rng = np.random.default_rng(seed)
    lo = np.asarray(scene.aabb_min)
    hi = np.asarray(scene.aabb_max)
    c = 0.5 * (lo + hi)
    r = float(np.linalg.norm(hi - lo))
    o = np.concatenate([
        c + rng.normal(size=(n // 2, 3)) * r * 0.8,   # outside-in
        c + rng.normal(size=(n - n // 2, 3)) * r * 0.05,  # inside-out
    ]).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o.T), jnp.asarray(d.T)


def test_cluster_matches_bvh_oracle(sphere_scene):
    scene = sphere_scene
    o, d = _rays(scene, 192)
    t, prim, uv, attr = trace_clustered(
        scene, o, d, interpret=True, want_attr=True
    )
    t_ref, p_ref = trace_closest(
        scene, jnp.swapaxes(o, 0, 1), jnp.swapaxes(d, 0, 1)
    )
    t = np.asarray(t)
    prim = np.asarray(prim)
    t_ref = np.asarray(t_ref)
    p_ref = np.asarray(p_ref)
    hit = t_ref < 1e5
    assert hit.sum() > 30  # the ray set must actually exercise hits
    np.testing.assert_allclose(
        np.where(hit, t, 0.0), np.where(hit, t_ref, 0.0), rtol=1e-4, atol=1e-4
    )
    # prim ids must agree except where two primitives tie on t (shared
    # edges / coincident geometry): both winners are then valid
    mismatch = hit & (prim != p_ref)
    assert mismatch.mean() < 0.02
    if mismatch.any():
        np.testing.assert_allclose(t[mismatch], t_ref[mismatch],
                                   rtol=1e-5, atol=1e-5)
    # misses agree too
    assert (prim[~hit] == p_ref[~hit]).all()

    # attribute record == the winner's prim_attr column, bit for bit
    attr = np.asarray(attr)
    pa = np.asarray(scene.prim_attr)
    exp = pa[:, np.clip(prim, 0, scene.n_prims - 1)]
    exp = np.where((prim >= 0)[None, :], exp, 0.0)
    np.testing.assert_array_equal(attr, exp)


def test_cluster_sorted_path_matches(sphere_scene, monkeypatch):
    """The big-wavefront regime (morton sort + per-block front-to-back
    order + unsort) must agree with the static-order result."""
    from ti_raytrace_tpu.ops import cluster_trace as ct

    scene = sphere_scene
    o, d = _rays(scene, 160, seed=3)
    t_small, prim_small, _ = trace_clustered(scene, o, d, interpret=True)
    monkeypatch.setattr(ct, "SMALL_WAVEFRONT", 0)
    t_sorted, prim_sorted, _ = trace_clustered(scene, o, d, interpret=True)
    np.testing.assert_allclose(
        np.asarray(t_small), np.asarray(t_sorted), rtol=1e-5, atol=1e-5
    )
    assert (np.asarray(prim_small) == np.asarray(prim_sorted)).all()


def test_cluster_origin_mt_matches(sphere_scene):
    """The shared-origin path (camera wavefronts: shared_origin selects
    one front-to-back cluster order for every ray block) must reproduce
    the static-order path's hits."""
    scene = sphere_scene
    o, d = _rays(scene, 128, seed=11)
    o = jnp.broadcast_to(o[:, :1], o.shape)  # one pinhole origin
    # aim at jittered points near the centre so most rays hit
    rng = np.random.default_rng(12)
    lo = np.asarray(scene.aabb_min)
    hi = np.asarray(scene.aabb_max)
    c = 0.5 * (lo + hi)
    tgt = c[:, None] + rng.normal(size=(3, 128)) * (hi - lo)[:, None] * 0.3
    d = jnp.asarray(tgt, jnp.float32) - o
    d = d / jnp.linalg.norm(d, axis=0, keepdims=True)
    t0, prim0, _ = trace_clustered(scene, o, d, interpret=True)
    t1, prim1, _ = trace_clustered(scene, o, d, interpret=True,
                                   shared_origin=o[:, 0])
    t0, t1, prim0, prim1 = map(np.asarray, (t0, t1, prim0, prim1))
    hit = t0 < 1e5
    assert hit.sum() > 20
    np.testing.assert_allclose(np.where(hit, t0, 0.0),
                               np.where(hit, t1, 0.0),
                               rtol=1e-4, atol=1e-4)
    assert (hit == (t1 < 1e5)).all()
    mismatch = hit & (prim0 != prim1)
    assert mismatch.mean() < 0.02


def test_cluster_tmax_bound(sphere_scene):
    """Per-lane tmax seeding (shadow-ray distance bound): hits strictly
    inside the bound are the exact closest hit; hits beyond it report a
    miss (t = INF, prim = -1).  Bounds are placed at 0.5x / 2x the known
    closest t so fp detail can't flip the comparison."""
    scene = sphere_scene
    o, d = _rays(scene, 160, seed=5)
    t0, prim0, _ = trace_clustered(scene, o, d, interpret=True)
    t0, prim0 = np.asarray(t0), np.asarray(prim0)
    hit = t0 < 1e5
    assert hit.sum() > 30

    finite = np.where(hit, t0, 1.0)
    # bound comfortably beyond every hit: identical result
    t1, prim1, _ = trace_clustered(scene, o, d, interpret=True,
                                   tmax=jnp.asarray(finite * 2.0))
    t1, prim1 = np.asarray(t1), np.asarray(prim1)
    np.testing.assert_array_equal(np.where(hit, t1, 0.0),
                                  np.where(hit, t0, 0.0))
    assert (prim1 == prim0).all()
    # unbounded lanes missed -> t reported INF
    assert (t1[~hit] >= C.INF).all()

    # bound in front of every hit: everything misses
    t2, prim2, _ = trace_clustered(scene, o, d, interpret=True,
                                   tmax=jnp.asarray(finite * 0.5))
    t2, prim2 = np.asarray(t2), np.asarray(prim2)
    assert (prim2 == -1).all()
    assert (t2 >= C.INF).all()

    # tmax <= 0 means unbounded
    t3, prim3, _ = trace_clustered(
        scene, o, d, interpret=True,
        tmax=jnp.zeros((o.shape[1],), jnp.float32))
    np.testing.assert_array_equal(np.asarray(t3), t0)
    assert (np.asarray(prim3) == prim0).all()


def test_cluster_active_capacity(sphere_scene):
    """Occupancy compaction (active + cap_frac): active lanes within
    capacity return the exact unmasked result, inactive lanes report
    miss regardless of the ray data they carry, and active lanes beyond
    capacity are cut to misses (the caller-side overflow contract)."""
    scene = sphere_scene
    n = 640
    o, d = _rays(scene, n, seed=7)
    t0, prim0, _ = trace_clustered(scene, o, d, interpret=True,
                                   sort_small=True)
    t0, prim0 = np.asarray(t0), np.asarray(prim0)

    rng = np.random.default_rng(3)
    active = jnp.asarray(rng.random(n) < 0.4)
    n_act = int(np.asarray(active).sum())

    # capacity comfortably above occupancy: actives exact, parked miss
    t1, prim1, _ = trace_clustered(
        scene, o, d, interpret=True, sort_small=True,
        active=active, cap_frac=0.75)
    t1, prim1 = np.asarray(t1), np.asarray(prim1)
    a = np.asarray(active)
    np.testing.assert_array_equal(prim1[a], prim0[a])
    np.testing.assert_array_equal(t1[a], t0[a])
    assert (prim1[~a] == -1).all()
    assert (t1[~a] >= C.INF).all()

    # capacity below occupancy: every surviving active lane still agrees
    # with the unmasked trace, and exactly (n_act - cap) actives are cut
    from ti_raytrace_tpu.ops.cluster_trace import capacity_lanes

    cap = capacity_lanes(n, 0.25)
    assert cap < n_act
    t2, prim2, _ = trace_clustered(
        scene, o, d, interpret=True, sort_small=True,
        active=active, cap_frac=0.25)
    t2, prim2 = np.asarray(t2), np.asarray(prim2)
    kept = a & (prim2 == prim0) & ((t2 == t0) | (prim0 == -1))
    cut = a & (prim2 == -1) & (t2 >= C.INF) & (prim0 != -1)
    # misses stay misses whether kept or cut; hits either match or cut
    assert (kept | cut)[a].all()
    assert cut.sum() <= n_act - min(cap, n_act) + (prim0[a] == -1).sum()
    assert (prim2[~a] == -1).all()


@pytest.fixture(scope="module")
def three_chunk_scene():
    """~40k-tri scene whose cluster count (1,250) is not a whole number of
    superclusters: the last supercluster is part padding clusters, which
    must never produce hits or hide real ones."""
    from ti_raytrace_tpu.io.meshgen import split2
    from ti_raytrace_tpu.io.obj import load_obj

    from ti_raytrace_tpu.examples.scenes import cached_host_build
    from ti_raytrace_tpu.scene.data import device_scene

    def make_host():
        mesh = load_obj(asset_path("model/Teapot.obj"))
        pos = np.concatenate(mesh.tri_pos)
        nrm = np.concatenate(mesh.tri_normal)
        uv = np.concatenate(mesh.tri_uv)
        pos, nrm, uv = split2(pos, nrm, uv)          # 50,400 tris
        pos, nrm, uv = pos[:40000], nrm[:40000], uv[:40000]
        b = SceneBuilder()
        b.add_triangles(pos, nrm, uv,
                        MaterialRec(C.MAT_DISNEY, color=[0.7, 0.7, 0.7]))
        b.add_shape(sphere_shape([0.0, 20.0, 0.0], 5.0),
                    MaterialRec(C.MAT_LIGHT, color=[50.0] * 3))
        return b.build_host()

    return device_scene(cached_host_build("three_chunk_teapot", make_host))


def test_cluster_three_chunk_oracle(three_chunk_scene):
    """Every real cluster of a scene with a part-padding last
    supercluster is swept: all oracle hits are found, at the oracle's
    distance."""
    from ti_raytrace_tpu.accel.clusters import GROUP

    scene = three_chunk_scene
    valid = np.asarray(scene.cluster_bounds[6])
    n_clusters = valid.shape[0]
    assert n_clusters % GROUP == 0
    assert 0 < n_clusters - int(valid.sum()) < GROUP, (
        "fixture must end in a part-padding supercluster")
    o, d = _rays(scene, 192, seed=21)
    t, prim, _ = trace_clustered(scene, o, d, interpret=True)
    t_ref, p_ref = trace_closest(
        scene, jnp.swapaxes(o, 0, 1), jnp.swapaxes(d, 0, 1)
    )
    t, prim = np.asarray(t), np.asarray(prim)
    t_ref, p_ref = np.asarray(t_ref), np.asarray(p_ref)
    hit = t_ref < 1e5
    assert hit.sum() > 30
    # every oracle hit must be found, and nothing else
    assert ((t < 1e5) == hit).all()
    np.testing.assert_allclose(
        np.where(hit, t, 0.0), np.where(hit, t_ref, 0.0),
        rtol=1e-4, atol=1e-4,
    )
    mismatch = hit & (prim != p_ref)
    assert mismatch.mean() < 0.02
    if mismatch.any():
        np.testing.assert_allclose(t[mismatch], t_ref[mismatch],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [1, 45, 77, 200])
def test_cluster_ragged_ray_counts(sphere_scene, n):
    """Ray counts that are not a whole number of ray blocks: the wrapper
    pads to TILE and slices back; results keep shape (n,) and match the
    oracle."""
    from ti_raytrace_tpu.ops import cluster_trace as ct

    assert n % ct.TILE or n < ct.TILE
    o, d = _rays(sphere_scene, n, seed=30 + n)
    t, prim, uv, attr = trace_clustered(sphere_scene, o, d, interpret=True,
                                        want_attr=True)
    assert t.shape == prim.shape == (n,)
    assert uv.shape == (2, n) and attr.shape[1] == n
    t_ref, p_ref = trace_closest(sphere_scene, jnp.swapaxes(o, 0, 1),
                                 jnp.swapaxes(d, 0, 1))
    t, t_ref = np.asarray(t), np.asarray(t_ref)
    hit = t_ref < 1e5
    assert ((t < 1e5) == hit).all()
    np.testing.assert_allclose(np.where(hit, t, 0.0),
                               np.where(hit, t_ref, 0.0), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("platform,interpret", [
    ("gpu", False), ("cpu", True), ("rocm", None), ("metal", None)])
def test_kernel_route_by_platform(platform, interpret):
    """GPU runs the compiled kernel, CPU the interpreter, and any other
    platform is an error rather than a silent fallback."""
    from ti_raytrace_tpu.accel import kernel_interpret

    if interpret is None:
        with pytest.raises(RuntimeError, match="no kernel"):
            kernel_interpret(platform)
    else:
        assert kernel_interpret(platform) is interpret


def test_kernel_route_default_is_this_host():
    """With no platform named, the route follows the first local device
    (the CPU here: the interpreter)."""
    from ti_raytrace_tpu.accel import kernel_interpret

    assert kernel_interpret() is True


@pytest.mark.gpu
def test_compiled_kernel_matches_interpreter(gpu, sphere_scene):
    """On the card: the Triton-compiled kernel reproduces the interpreted
    one (same algebra; only floating-point contraction may differ)."""
    o, d = _rays(sphere_scene, 1024, seed=40)
    t0, p0, _ = trace_clustered(sphere_scene, o, d, interpret=True)
    t1, p1, _ = trace_clustered(sphere_scene, o, d, interpret=False)
    t0, t1, p0, p1 = map(np.asarray, (t0, t1, p0, p1))
    hit = p0 >= 0
    assert ((p1 >= 0) == hit).all()
    np.testing.assert_allclose(t1[hit], t0[hit], rtol=1e-5, atol=1e-5)
    assert (p1 != p0).mean() < 0.001
