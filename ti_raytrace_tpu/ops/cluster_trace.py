"""Pallas (Triton route) kernel: ray-block x cluster-stream closest hit.

For scenes too large for the dense sweep.  One program owns a block of
TILE rays; each thread of the program holds one ray's state (origin,
inverse direction, best hit) in registers and the program walks the
scene's clusters (accel/clusters.py) front to back:

  for each supercluster (GROUP consecutive clusters) in the program's
  front-to-back order:
      skip it unless some ray enters its box before that ray's best t;
      for each of its clusters:
          skip it unless some ray enters its box before its best t;
          intersect every ray with the cluster's B triangles
          (Moller-Trumbore, one triangle per step, triangle data loaded
          once per program and broadcast to all rays).

The per-ray `entry < best t` test is per-ray front-to-back early exit:
as rays find hits, clusters behind those hits stop being visited.  The
kernel returns (t, prim, u, v) only; callers that need the shading pack
gather `scene.prim_attr[:, prim]` once, outside the kernel.

Ray coherence is restored per bounce by sorting the wavefront on a
morton key of (origin, direction octant); dead lanes (zero direction)
start with best t = 0 and never enter a box, and terminated rays parked
far outside the scene miss every box, so all-dead blocks cost only the
supercluster sweep.

Layout: rays planar (8, N) rows [ox oy oz dx dy dz tmax 0]; the cluster
order (rows, S) int32 with one row per program (per-block order) or one
shared row; supercluster bounds (8, S) and cluster bounds (8, C) in
global order with validity in row 6; triangle blocks (10, C*B) planar
[v0 | e1 | e2 | pid].
Output (4, N): t, prim (as f32), u, v.
"""

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from ti_raytrace_tpu.accel.clusters import GROUP
from ti_raytrace_tpu.core import constants as C

TILE = 32        # rays per program: one warp, one ray per thread
NUM_WARPS = 1    # TILE // 32
UNROLL = 4       # triangles intersected per step of the narrow loop
SMALL_WAVEFRONT = 32768  # below this, skip sort + per-block ordering
OUT_ROWS = 4     # t, prim, u, v


def _kernel(rays_ref, order_ref, sb_ref, cb_ref, tri_ref, out_ref, *,
            n_supers, block, per_block_order):
    ox, oy, oz = rays_ref[0, :], rays_ref[1, :], rays_ref[2, :]
    dx, dy, dz = rays_ref[3, :], rays_ref[4, :], rays_ref[5, :]
    tmax = rays_ref[6, :]

    def safe_inv(v):
        return 1.0 / jnp.where(jnp.abs(v) < 1e-12,
                               jnp.where(v >= 0, 1e-12, -1e-12), v)

    ix, iy, iz = safe_inv(dx), safe_inv(dy), safe_inv(dz)
    live = (dx != 0.0) | (dy != 0.0) | (dz != 0.0)
    # per-lane tmax seed (<= 0 means unbounded): shadow rays know their
    # target distance, so everything beyond it prunes from the start.
    # Dead lanes start at 0 and never become candidates.
    best_t = jnp.where(live, jnp.where(tmax > 0.0, tmax, C.INF), 0.0)
    zeros = jnp.zeros_like(ox)
    state = (best_t, zeros - 1.0, zeros, zeros)
    row = pl.program_id(0) if per_block_order else 0

    def any_candidate(ref, c, best):
        """Does some ray enter box c of a (8, n) bounds ref before its
        best hit?  Row 6 is the validity flag (accel/clusters.py
        _empty_bounds)."""
        t1x = (ref[0, c] - ox) * ix
        t2x = (ref[3, c] - ox) * ix
        t1y = (ref[1, c] - oy) * iy
        t2y = (ref[4, c] - oy) * iy
        t1z = (ref[2, c] - oz) * iz
        t2z = (ref[5, c] - oz) * iz
        tn = jnp.maximum(jnp.maximum(jnp.minimum(t1x, t2x),
                                     jnp.minimum(t1y, t2y)),
                         jnp.maximum(jnp.minimum(t1z, t2z), 0.0))
        tf = jnp.minimum(jnp.minimum(jnp.maximum(t1x, t2x),
                                     jnp.maximum(t1y, t2y)),
                         jnp.maximum(t1z, t2z))
        cand = (tn <= tf) & (tn < best)
        return (jnp.max(cand.astype(jnp.int32)) > 0) & (ref[6, c] > 0.0)

    def triangle(col, st):
        best, prim, bu, bv = st
        pid = tri_ref[9, col]
        v0x, v0y, v0z = tri_ref[0, col], tri_ref[1, col], tri_ref[2, col]
        e1x, e1y, e1z = tri_ref[3, col], tri_ref[4, col], tri_ref[5, col]
        e2x, e2y, e2z = tri_ref[6, col], tri_ref[7, col], tri_ref[8, col]
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        sgn = jnp.sign(det)
        tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
        u = (tx * px + ty * py + tz * pz) * sgn
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        v = (dx * qx + dy * qy + dz * qz) * sgn
        t = (e2x * qx + e2y * qy + e2z * qz) * sgn
        adet = jnp.abs(det)
        ok = ((adet > 1e-12) & (u >= 0.0) & (u <= adet) & (v >= 0.0)
              & (u + v <= adet))
        inv = 1.0 / jnp.where(ok, adet, 1.0)
        t = t * inv
        closer = ok & (t > 0.0) & (t < best)
        return (jnp.where(closer, t, best), jnp.where(closer, pid, prim),
                jnp.where(closer, u * inv, bu), jnp.where(closer, v * inv, bv))

    def narrow(cid, st):
        def body(j, st):
            col = cid * block + j * UNROLL
            for k in range(UNROLL):
                st = triangle(col + k, st)
            return st

        return jax.lax.fori_loop(0, block // UNROLL, body, st)

    def cluster_body(sid, g, st):
        cid = sid * GROUP + g
        return jax.lax.cond(any_candidate(cb_ref, cid, st[0]),
                            functools.partial(narrow, cid),
                            lambda s: s, st)

    def super_body(k, st):
        sid = order_ref[row, k]

        def clusters(st):
            return jax.lax.fori_loop(
                0, GROUP, functools.partial(cluster_body, sid), st)

        return jax.lax.cond(any_candidate(sb_ref, sid, st[0]), clusters,
                            lambda s: s, st)

    best, prim, bu, bv = jax.lax.fori_loop(0, n_supers, super_body, state)
    out_ref[0, :] = best
    out_ref[1, :] = prim
    out_ref[2, :] = bu
    out_ref[3, :] = bv


@functools.partial(jax.jit, static_argnames=("block", "interpret"))
def _run_kernel(rays, order, sb, cb, tri, block: int, interpret: bool):
    """rays (8, n) with n a multiple of TILE -> (OUT_ROWS, n) records."""
    n = rays.shape[1]
    assert n % TILE == 0, (n, TILE)
    assert block % UNROLL == 0, (block, UNROLL)
    n_supers = int(sb.shape[1])
    per_block_order = int(order.shape[0]) > 1
    whole = pl.no_block_spec
    return pl.pallas_call(
        functools.partial(_kernel, n_supers=n_supers, block=block,
                          per_block_order=per_block_order),
        grid=(n // TILE,),
        in_specs=[pl.BlockSpec((8, TILE), lambda i: (0, i)),
                  whole, whole, whole, whole],
        out_specs=pl.BlockSpec((OUT_ROWS, TILE), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct((OUT_ROWS, n), jnp.float32),
        compiler_params=pl_triton.CompilerParams(num_warps=NUM_WARPS,
                                                 num_stages=1),
        backend="triton",
        interpret=interpret,
        name="cluster_trace",
    )(rays, order, sb, cb, tri)


def _coherence_key(scene, o, d):
    """Sort key restoring ray-block spatial coherence: origin-major,
    direction-minor morton mix.  Bounced wavefronts are incoherent;
    sorting groups rays that will enter the same clusters into the same
    block (and parks terminated rays — origins far outside — into
    all-dead blocks that cost nothing).  The direction bits matter most
    for camera rays: all share one origin, and without them the sort
    degenerates to scanline order."""
    from ti_raytrace_tpu.utils.morton import morton3d

    lo = scene.aabb_min
    span = jnp.maximum(scene.aabb_max - scene.aabb_min, 1e-12)
    q = [(o[k] - lo[k]) / span[k] for k in range(3)]
    code_o = morton3d(q[0], q[1], q[2])                  # 30 bits
    code_d = morton3d(
        d[0] * 0.5 + 0.5, d[1] * 0.5 + 0.5, d[2] * 0.5 + 0.5
    )                                                    # 30 bits
    return code_o, code_d


def _super_bounds(cb):
    """(8, S) supercluster boxes: the union of each run of GROUP
    consecutive clusters (spatially adjacent by median-split
    construction), validity in row 6."""
    S = cb.shape[1] // GROUP
    bmin = cb[0:3].reshape(3, S, GROUP).min(axis=2)
    bmax = cb[3:6].reshape(3, S, GROUP).max(axis=2)
    valid = cb[6].reshape(S, GROUP).max(axis=1)
    return jnp.concatenate(
        [bmin, bmax, valid[None], jnp.zeros((1, S), jnp.float32)], 0)


def _front_to_back(sb, cent):
    """(T, S) supercluster order for each of T reference points (T, 3):
    by point-to-box distance, a conservative front-to-back order for
    rays starting near the point."""
    p = jnp.clip(cent[:, None, :], sb[0:3].T[None], sb[3:6].T[None])
    dist = jnp.sum((p - cent[:, None, :]) ** 2, axis=-1)
    return jnp.argsort(dist, axis=1).astype(jnp.int32)


def capacity_lanes(N: int, cap_frac: float) -> int:
    """Static kernel capacity for an `active`-masked trace: cap_frac of
    N rounded UP to a whole ray block (callers use this to count
    overflow kills with the exact same rounding the tracer applies)."""
    n_pad = ((N + TILE - 1) // TILE) * TILE
    return min(n_pad, max(TILE, ((int(N * cap_frac) + TILE - 1) // TILE) * TILE))


def trace_clustered(
    scene, o, d, interpret: bool = False, sort_rays: bool = True,
    want_attr: bool = False, sort_small: bool = False, shared_origin=None,
    tile_order: bool = False, tmax=None, active=None, cap_frac=None,
):
    """Closest hit via the cluster kernel + dense analytic-shape tail.

    o, d: planar (3, N).  Returns (t, prim, uv_bary (2,N)) or, with
    want_attr, (t, prim, uv_bary, attr (A,N)) where attr is
    scene.prim_attr[:, prim] (zeros on a miss).

    sort_rays: morton-sort the wavefront into coherent ray blocks (and
    unsort the result); skipped below SMALL_WAVEFRONT lanes unless
    sort_small.  tile_order: a presorted wavefront still gets a per-block
    front-to-back cluster order.  shared_origin: (3,) common origin of
    every ray (pinhole camera) — one shared front-to-back order.

    tmax: optional (N,) per-lane upper bound on the hit distance (shadow
    rays know their target distance).  Hits at t >= tmax are reported as
    misses (t = INF, prim = -1); hits below it are the exact closest
    hit.  Lanes with tmax <= 0 are unbounded.

    active + cap_frac: occupancy compaction for sparse wavefronts.
    Inactive lanes report a miss.  With the sorted path, inactive lanes
    take the padding sort key, so active lanes pack into a prefix and the
    kernel grid covers only capacity_lanes(N, cap_frac) lanes; active
    lanes beyond capacity are CUT (reported as misses) — callers size
    cap_frac with headroom and count kills via capacity_lanes.
    """
    N = o.shape[1]
    n_pad = ((N + TILE - 1) // TILE) * TILE
    if N <= SMALL_WAVEFRONT and not sort_small:
        # small wavefronts (BDPT walks/connections): the sort and the
        # per-block ordering cost more than they save
        sort_rays = False

    cap = None
    if active is not None and cap_frac is not None and sort_rays:
        cap = capacity_lanes(N, cap_frac)
        if cap >= n_pad:
            cap = None

    if active is not None:
        # zero direction = dead lane: best t starts at 0 in the kernel
        d = d * active[None, :].astype(d.dtype)
    row6 = tmax[None] if tmax is not None else jnp.zeros((1, N), jnp.float32)
    rays = jnp.concatenate([o, d, row6, jnp.zeros((1, N), jnp.float32)], 0)
    rays = jnp.pad(rays, ((0, 0), (0, n_pad - N)))

    if sort_rays:
        key_o, key_d = _coherence_key(scene, o, d)
        if active is not None:
            # parked lanes sort with the padding (morton keys are 30-bit,
            # 0xFFFFFFFF is reserved): actives pack into a dense prefix
            key_o = jnp.where(active, key_o, jnp.uint32(0xFFFFFFFF))
            key_d = jnp.where(active, key_d, jnp.uint32(0xFFFFFFFF))
        pad = (0, n_pad - N)
        key_o = jnp.pad(key_o, pad, constant_values=jnp.uint32(0xFFFFFFFF))
        key_d = jnp.pad(key_d, pad, constant_values=jnp.uint32(0xFFFFFFFF))
        idx = jnp.arange(n_pad, dtype=jnp.int32)
        _, _, order = jax.lax.sort((key_o, key_d, idx), num_keys=2,
                                   is_stable=True)
        rays = jnp.take(rays, order, axis=1)
        if cap is not None:
            rays = rays[:, :cap]

    cb = scene.cluster_bounds
    tri = scene.cluster_tri
    n_clusters = int(cb.shape[1])
    block = int(tri.shape[1]) // n_clusters
    sb = _super_bounds(cb)

    n_run = rays.shape[1]
    if shared_origin is not None:
        # single-origin wavefront (camera rays): one shared order,
        # whether or not the lanes are sorted
        cluster_order = _front_to_back(sb, shared_origin[None])
    elif sort_rays or tile_order:
        # per-block order from each block's mean origin (padding zeros
        # only skew the last partial block's heuristic order; pruning
        # stays exact)
        cent = rays[0:3].reshape(3, n_run // TILE, TILE).mean(axis=2).T
        cluster_order = _front_to_back(sb, cent)
    else:
        cluster_order = jnp.arange(sb.shape[1], dtype=jnp.int32)[None]

    out = _run_kernel(rays, cluster_order, sb, cb, tri, block, interpret)
    if sort_rays:
        if cap is not None:
            # lanes beyond capacity unsort as misses.  t = 0 (not INF) so
            # the analytic-shape tail below can't resurrect a cut lane
            # with a sphere-only hit; the final miss restore reports INF
            miss = jnp.zeros((OUT_ROWS, n_pad - cap), out.dtype)
            miss = miss.at[1].set(-1.0)
            out = jnp.concatenate([out, miss], axis=1)
        inv = jnp.zeros((n_pad,), jnp.int32).at[order].set(
            jnp.arange(n_pad, dtype=jnp.int32))
        out = jnp.take(out, inv, axis=1)
    t = out[0, :N]
    prim = out[1, :N].astype(jnp.int32)
    uv = out[2:4, :N]

    # analytic shapes: dense tail over the (few) PRIM_SHAPE prims
    P = scene.n_prims
    T_est = scene.vtx_pos.shape[0] // 3
    for pid in range(min(T_est, P), P):
        sid = jnp.clip(scene.prim_vidx[pid], 0, scene.shape_type.shape[0] - 1)
        stype = scene.shape_type[sid]
        centre = scene.shape_pos[sid]
        radius = scene.shape_param[sid, 0]
        ocx = centre[0] - o[0]
        ocy = centre[1] - o[1]
        ocz = centre[2] - o[2]
        oc2 = ocx * ocx + ocy * ocy + ocz * ocz
        dop = d[0] * ocx + d[1] * ocy + d[2] * ocz
        disc2 = oc2 - dop * dop
        a = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        b = -2.0 * dop
        cc = oc2 - radius * radius
        discr = jnp.maximum(b * b - 4.0 * a * cc, 0.0)
        ts = (-b - jnp.sqrt(discr)) / (2.0 * jnp.maximum(a, 1e-12))
        hit = (
            (stype == C.SHAPE_SPHERE) & (disc2 < radius * radius) & (ts > 0.0) & (ts < t)
        )
        if active is not None:
            hit = hit & active
        t = jnp.where(hit, ts, t)
        prim = jnp.where(hit, pid, prim)
        uv = jnp.where(hit[None, :], 0.0, uv)

    if tmax is not None or active is not None:
        # restore the miss contract: bounded lanes whose closest hit lay
        # beyond tmax carry t == tmax with prim == -1, dead and cut lanes
        # carry t == 0; report t = INF
        t = jnp.where(prim < 0, C.INF, t)

    if want_attr:
        attr = jnp.take(scene.prim_attr, jnp.maximum(prim, 0), axis=1)
        return t, prim, uv, jnp.where(prim[None] >= 0, attr, 0.0)
    return t, prim, uv
