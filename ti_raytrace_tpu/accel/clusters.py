"""Cluster acceleration structure: spatially ordered triangle blocks.

A shallow replacement for deep-tree traversal on large scenes.
Primitives are ordered by a recursive longest-axis median split (morton
order as the fallback) and chopped into fixed-size clusters of B
triangles.  Each cluster stores its AABB and a planar (10, B) triangle
block:

  rows 0:2 v0, 3:5 e1, 6:8 e2, 9 prim_id (float)

GROUP consecutive clusters form a supercluster.  Traversal
(ops/cluster_trace.py) is a two-level sweep per ray block: box-test the
superclusters front to back, box-test the clusters of every supercluster
some ray enters, and run Möller-Trumbore only on clusters some ray
entered before its current best hit.

Analytic-shape primitives are excluded (handled by a dense tail pass);
padding triangles are degenerate (e1 = e2 = 0 -> zero determinant ->
guaranteed miss).
"""

import numpy as np

from ti_raytrace_tpu.core import constants as C

CLUSTER_B = 32   # triangles per cluster; 16/32/64 swept on an H100 (PERF.md)
GROUP = 32       # clusters per supercluster; the cluster count is padded
                 # to a whole number of superclusters
CLUSTER_METHOD = "median"  # "median" | "sah" (see build_clusters)
TRI_ROWS = 10    # [v0 | e1 | e2 | pid]


def _expand_bits_np(x):
    x = x.astype(np.uint32)
    x = (x | (x << 16)) & np.uint32(0x030000FF)
    x = (x | (x << 8)) & np.uint32(0x0300F00F)
    x = (x | (x << 4)) & np.uint32(0x030C30C3)
    x = (x | (x << 2)) & np.uint32(0x09249249)
    return x


def _morton3d_np(q):
    qi = np.clip(q * 1024.0, 0.0, 1023.0).astype(np.uint32)
    return (
        _expand_bits_np(qi[:, 0])
        | (_expand_bits_np(qi[:, 1]) << 1)
        | (_expand_bits_np(qi[:, 2]) << 2)
    )


def _median_split_order(pmin, pmax, block: int) -> np.ndarray:
    """Recursive longest-axis median split into runs of <= block tris.

    Produces tighter cluster boxes than fixed morton-range slicing (the
    split adapts to the geometry), which directly cuts the number of
    clusters a ray tile enters during traversal."""
    n = pmin.shape[0]
    centroid = 0.5 * (pmin + pmax)
    order = np.arange(n)
    out = []
    stack = [order]
    while stack:
        ids = stack.pop()
        if ids.shape[0] <= block:
            out.append(ids)
            continue
        c = centroid[ids]
        axis = int(np.argmax(c.max(0) - c.min(0)))
        half = (ids.shape[0] // (2 * block) + (ids.shape[0] % (2 * block) > 0)) * block
        half = min(half, ids.shape[0] - 1)
        part = np.argpartition(c[:, axis], half)
        stack.append(ids[part[half:]])
        stack.append(ids[part[:half]])
    # left-to-right: internal splits are block multiples, so every leaf
    # except the global tail starts at a block-aligned offset and clusters
    # never straddle leaf boundaries
    return np.concatenate(out)


def _sah_leaves(pmin, pmax, block: int, n_bins: int = 16):
    """Binned-SAH recursive split into leaves of <= block tris.

    Unlike the centroid median split, the SAH criterion minimizes
    expected intersection cost, which yields tighter, less-overlapping
    cluster boxes on curved/dense geometry — the direct driver of how
    many clusters a ray tile's narrow phase must visit.  Returns a list
    of index arrays in DFS order (spatially coherent, so GROUP-runs of
    consecutive clusters still form meaningful superclusters)."""
    n = pmin.shape[0]
    centroid = 0.5 * (pmin + pmax)
    leaves = []
    stack = [np.arange(n)]
    while stack:
        ids = stack.pop()
        m = ids.shape[0]
        if m <= block:
            leaves.append(ids)
            continue
        c = centroid[ids]
        best = None  # (cost, axis, bins, k)
        for a in range(3):
            ca = c[:, a]
            lo, hi = float(ca.min()), float(ca.max())
            if hi - lo < 1e-12:
                continue
            b = np.minimum(
                ((ca - lo) * (n_bins / (hi - lo))).astype(np.int32), n_bins - 1
            )
            cnt = np.bincount(b, minlength=n_bins)
            bmin = np.full((n_bins, 3), np.inf)
            bmax = np.full((n_bins, 3), -np.inf)
            np.minimum.at(bmin, b, pmin[ids])
            np.maximum.at(bmax, b, pmax[ids])
            pre_min = np.minimum.accumulate(bmin, 0)
            pre_max = np.maximum.accumulate(bmax, 0)
            suf_min = np.minimum.accumulate(bmin[::-1], 0)[::-1]
            suf_max = np.maximum.accumulate(bmax[::-1], 0)[::-1]
            pre_n = np.cumsum(cnt)
            ext_l = np.maximum(pre_max[:-1] - pre_min[:-1], 0.0)
            ext_r = np.maximum(suf_max[1:] - suf_min[1:], 0.0)
            sa_l = (ext_l[:, 0] * ext_l[:, 1] + ext_l[:, 1] * ext_l[:, 2]
                    + ext_l[:, 2] * ext_l[:, 0])
            sa_r = (ext_r[:, 0] * ext_r[:, 1] + ext_r[:, 1] * ext_r[:, 2]
                    + ext_r[:, 2] * ext_r[:, 0])
            nl = pre_n[:-1]
            nr = m - nl
            cost = np.where(
                (nl > 0) & (nr > 0), sa_l * nl + sa_r * nr, np.inf
            )
            k = int(np.argmin(cost))
            if np.isfinite(cost[k]) and (best is None or cost[k] < best[0]):
                best = (float(cost[k]), a, b, k)
        if best is None:  # degenerate: all centroids coincide
            stack.append(ids[: m // 2])
            stack.append(ids[m // 2:])
            continue
        _, a, b, k = best
        mask = b <= k
        stack.append(ids[~mask])
        stack.append(ids[mask])
    return leaves


def build_clusters(host: dict, block: int = CLUSTER_B,
                   method: str = None) -> dict:
    """Build cluster arrays from the host scene dict.

    Returns dict(cluster_bounds (8, C), cluster_tri (TRI_ROWS, C*block))
    with C a multiple of GROUP.  Always at least one supercluster
    (degenerate if the scene has no tris).

    method: "median" (longest-axis centroid median split, full slot
    occupancy) or "sah" (binned-SAH leaves padded to full blocks,
    tighter boxes).  None -> CLUSTER_METHOD.
    """
    method = method or CLUSTER_METHOD
    ptype = host["prim_type"]
    tri_ids = np.nonzero(ptype == C.PRIM_TRI)[0]
    T = tri_ids.shape[0]

    if T == 0:
        bounds = _empty_bounds(GROUP)
        tri = np.zeros((TRI_ROWS, GROUP * block), np.float32)
        tri[9, :] = -1.0
        return dict(cluster_bounds=bounds, cluster_tri=tri)

    v0 = host["tri_v0"][tri_ids]
    e1 = host["tri_e1"][tri_ids]
    e2 = host["tri_e2"][tri_ids]
    v1 = v0 + e1
    v2 = v0 + e2
    pmin = np.minimum(np.minimum(v0, v1), v2)
    pmax = np.maximum(np.maximum(v0, v1), v2)
    centroid = 0.5 * (pmin + pmax)
    lo = centroid.min(0)
    hi = centroid.max(0)
    # median-split ordering (tighter boxes); morton kept as fallback
    order = None
    if method != "sah":
        try:
            order = _median_split_order(pmin, pmax, block)
        except Exception:
            codes = None
            try:  # native fast path (native/tiray_native.cpp)
                from ti_raytrace_tpu.io.native import morton3d_native

                codes = morton3d_native(centroid, lo, hi)
            except Exception:
                codes = None
            if codes is None:
                q = (centroid - lo) / np.maximum(hi - lo, 1e-12)
                codes = _morton3d_np(q)
            order = np.argsort(codes, kind="stable")

    # slot: cluster-slot -> local tri index (-1 = padding slot).  The
    # median path fills slots contiguously (full occupancy); the SAH
    # path pads each leaf to a full block (tighter boxes at ~75-95%
    # occupancy).
    if method == "sah":
        leaves = _sah_leaves(pmin, pmax, block)
        # greedy run-merge: consecutive DFS leaves are spatial siblings;
        # packing them into shared blocks recovers slot occupancy
        # (~0.67 -> ~0.9) at a small box-tightness cost
        merged, cur = [], None
        for leaf in leaves:
            if cur is None:
                cur = leaf
            elif cur.shape[0] + leaf.shape[0] <= block:
                cur = np.concatenate([cur, leaf])
            else:
                merged.append(cur)
                cur = leaf
        if cur is not None:
            merged.append(cur)
        leaves = merged
        n_real = len(leaves)
    else:
        leaves = [order[i:i + block] for i in range(0, T, block)]
        n_real = len(leaves)
    n_clusters = ((n_real + GROUP - 1) // GROUP) * GROUP
    P_pad = n_clusters * block
    slot = np.full(P_pad, -1, np.int64)
    for i, leaf in enumerate(leaves):
        slot[i * block:i * block + leaf.shape[0]] = leaf

    valid = slot >= 0
    src = np.where(valid, slot, 0)
    vm = valid.astype(np.float32)
    tri = np.zeros((TRI_ROWS, P_pad), np.float32)
    tri[0:3] = v0[src].T * vm
    tri[3:6] = e1[src].T * vm
    tri[6:9] = e2[src].T * vm
    tri[9] = np.where(valid, tri_ids[src].astype(np.float32), -1.0)

    bounds = _empty_bounds(n_clusters)
    for c in range(n_real):
        sel = leaves[c]
        bounds[0:3, c] = pmin[sel].min(0)
        bounds[3:6, c] = pmax[sel].max(0)
    bounds[6, :n_real] = 1.0
    return dict(cluster_bounds=bounds, cluster_tri=tri)


def _empty_bounds(n: int) -> np.ndarray:
    """Padding-cluster bounds.  IMPORTANT: a branchless slab test cannot
    represent 'never hit' with min > max — the per-axis [min(t1,t2),
    max(t1,t2)] intervals make box [1,-1] behave exactly like [-1,1], a
    unit box at the origin that rays through the scene centre 'hit'.
    Row 6 is an explicit validity flag the traversal masks on; the inf
    extents additionally keep padding out of supercluster boxes."""
    bounds = np.zeros((8, n), np.float32)
    bounds[0:3, :] = 1e30
    bounds[3:6, :] = -1e30
    bounds[6, :] = 0.0  # invalid
    return bounds
