"""Acceleration structures + tracer dispatch.

Three tracers share one contract; dispatch is on the *static* scene
size, so each scene jits exactly one of them:

  * dense planar sweep (ops/dense_trace) — every lane against every
    primitive block, one-hot attribute extraction; serves small scenes;
  * cluster-stream Pallas kernel (ops/cluster_trace) — ray blocks vs
    superclusters/clusters of triangles, front to back; the production
    tracer for large scenes;
  * threaded-BVH wavefront traversal (accel/traverse) — the pure-XLA
    reference implementation, kept as the oracle for tests.

`trace` returns (t, prim); `trace_shaded` additionally returns
barycentrics and the packed (A, N) shading attributes (scene/packs.py).
Planar convention: rays are (3, N).
"""

import jax

# Chosen on the previous accelerator; not yet measured on the GPU.
DENSE_MAX_PRIMS = 4096


def kernel_interpret(platform: str | None = None) -> bool:
    """How the cluster kernel runs on `platform` (default: the first
    local device's): compiled on a GPU, in the Pallas interpreter on the
    CPU (tests and rehearsals only).  Any other platform has no kernel
    and is an error, never a silent fallback."""
    platform = platform or jax.local_devices()[0].platform
    if platform == "gpu":
        return False
    if platform == "cpu":
        return True
    raise RuntimeError(
        f"the cluster tracer has no kernel for platform {platform!r}")


def trace(scene, origin, direction, sort_rays: bool = True,
          sort_small: bool = False, tile_order: bool = False, tmax=None,
          active=None, cap_frac=None):
    """Planar closest-hit: origin/direction (3, N) -> (t, prim).

    sort_rays=False skips the cluster tracer's coherence sort/unsort —
    pass it when the wavefront is already morton-sorted (pt_rgb presorts
    the whole carry once per bounce, which is far cheaper than
    sort+unsort gathers around every trace).  sort_small=True sorts even
    sub-SMALL_WAVEFRONT widths (PT's compacted deep phases — incoherent
    survivors; BDPT's natively-small wavefronts keep the skip).

    tmax: optional (N,) shadow-ray distance bound — the CLUSTER tracer
    reports hits at t >= tmax as misses and prunes everything beyond the
    bound (cluster_trace.trace_clustered); the dense tracer IGNORES it
    (no pruning to win, true closest hit returned).  Callers must treat
    the result as exact only for `prim == target` / `t-within-bound`
    predicates, which hold under both behaviors.

    active + cap_frac: occupancy compaction (cluster_trace.trace_clustered
    packs the kernel grid; dense_trace.trace_planar_capped packs the
    block sweep) — inactive lanes' results are UNDEFINED across the
    tracers (miss under cluster/capped-dense, real hits under uncapped
    dense), so callers may only read lanes they marked active."""
    if scene.n_prims <= DENSE_MAX_PRIMS:
        from ti_raytrace_tpu.ops.dense_trace import (trace_planar,
                                                     trace_planar_capped)

        if active is not None and cap_frac is not None:
            # the dense sweep has no dead-lane early exit (every lane
            # pays N x P), so mostly-parked wavefronts need packing
            return trace_planar_capped(scene, origin, direction, active,
                                       cap_frac)
        return trace_planar(scene, origin, direction)
    from ti_raytrace_tpu.ops.cluster_trace import trace_clustered

    t, prim, _ = trace_clustered(
        scene, origin, direction, interpret=kernel_interpret(),
        sort_rays=sort_rays, sort_small=sort_small, tile_order=tile_order,
        tmax=tmax, active=active, cap_frac=cap_frac,
    )
    return t, prim


def trace_shaded(scene, origin, direction, sort_rays: bool = True,
                 sort_small: bool = False, shared_origin=None,
                 tile_order: bool = False, active=None, cap_frac=None):
    """Planar closest-hit + shading pack -> (t, prim, uv_bary, attr).

    shared_origin: (3,) common ray origin (pinhole camera wavefronts) —
    lets the cluster tracer use ONE shared front-to-back order instead
    of per-block ordering.

    active + cap_frac: occupancy compaction (cluster tracer only; see
    `trace` above) — callers may only read lanes they marked active."""
    if scene.n_prims <= DENSE_MAX_PRIMS:
        from ti_raytrace_tpu.ops.dense_trace import trace_shaded as _dense

        return _dense(scene, origin, direction)

    from ti_raytrace_tpu.ops.cluster_trace import trace_clustered

    return trace_clustered(
        scene, origin, direction, interpret=kernel_interpret(),
        want_attr=True, sort_rays=sort_rays, sort_small=sort_small,
        shared_origin=shared_origin, tile_order=tile_order,
        active=active, cap_frac=cap_frac,
    )


def needs_presort(scene) -> bool:
    """Static: does this scene use the cluster tracer (which wants
    morton-presorted wavefronts)?"""
    return scene.n_prims > DENSE_MAX_PRIMS
