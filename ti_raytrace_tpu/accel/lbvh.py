"""Linear BVH (Karras 2012) built on device with XLA primitives.

Array-native re-design of the reference's one "systems" component
(accel/LBvh.py).  Structural differences, by stage:

  reference (Taichi)                          this module (JAX/XLA)
  ------------------------------------------  ------------------------------
  30-pass hand-rolled radix sort + Blelloch   one `jax.lax.sort` call
    scan, ~30*(2 log n + 2) kernel launches     (LBvh.py:55-94,340-386)
  per-node Karras determineRange/findSplit    same math, vectorized over all
    with data-dependent while loops             internal nodes with masked
    (LBvh.py:230-314)                           fixed-trip loops
  bottom-up AABB fit via host polling of a    device-side fixpoint
    done-counter (LBvh.py:206-218,454-467)      `lax.while_loop`, <= height
                                                iterations, no host syncs
  host recursive DFS flatten to PBRT          host iterative DFS flatten to
    compact nodes (left=idx+1, right=offset)    *threaded* nodes
    consumed by a per-pixel stack               (descend -> idx+1, skip ->
    (LBvh.py:138-173)                           escape[idx]) so traversal
                                                needs no stack at all

Duplicate morton codes: the reference runs an explicit equal-code scan
(LBvh.py:240-251); we use the standard augmented delta —
delta(i,j) = clz(code_i ^ code_j), plus 32 + clz(i ^ j) on ties — which is
equivalent and branch-free.
"""

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ti_raytrace_tpu.utils.morton import clz32, morton3d


def _delta(codes, i, j, n):
    """Karras delta with index augmentation on equal codes; -1 outside
    [0, n-1].  i, j: int32 arrays."""
    valid = (j >= 0) & (j < n) & (i >= 0) & (i < n)
    jc = jnp.clip(j, 0, n - 1)
    ic = jnp.clip(i, 0, n - 1)
    ci = codes[ic]
    cj = codes[jc]
    base = clz32(jnp.bitwise_xor(ci, cj))
    tie = 32 + clz32(jnp.bitwise_xor(ic.astype(jnp.uint32), jc.astype(jnp.uint32)))
    d = jnp.where(ci == cj, tie, base)
    return jnp.where(valid, d, -1)


@partial(jax.jit, static_argnames=("n",))
def _karras_topology(codes, n: int):
    """Children of the n-1 internal nodes.

    Node id convention (matches reference LBvh.py:390-450): internal nodes
    are [0, n-2], leaf k is node (n-1) + k.
    Returns (left_child, right_child) as node ids, each (n-1,).
    """
    K = max(1, math.ceil(math.log2(max(n, 2))))
    i = jnp.arange(n - 1, dtype=jnp.int32)

    d_next = _delta(codes, i, i + 1, n)
    d_prev = _delta(codes, i, i - 1, n)
    d = jnp.where(d_next > d_prev, 1, -1).astype(jnp.int32)
    dmin = _delta(codes, i, i - d, n)

    # exponential expansion of the range length upper bound
    l_max = jnp.full_like(i, 2)
    grow = jnp.ones_like(i, dtype=bool)
    for _ in range(K + 2):
        c = grow & (_delta(codes, i, i + l_max * d, n) > dmin)
        l_max = jnp.where(c, l_max * 2, l_max)
        grow = c

    # binary search for the exact other end
    l = jnp.zeros_like(i)
    for k in range(K + 1, -1, -1):
        t = jnp.int32(1 << k)
        use = (2 * t) <= l_max
        c = use & (_delta(codes, i, i + (l + t) * d, n) > dmin)
        l = jnp.where(c, l + t, l)
    j = i + l * d
    first = jnp.minimum(i, j)
    last = jnp.maximum(i, j)

    # findSplit: highest differing bit within [first, last]
    d_node = _delta(codes, first, last, n)
    split = first
    stride = last - first
    active = jnp.ones_like(i, dtype=bool)
    for _ in range(K + 1):
        stride = (stride + 1) >> 1
        cand = split + stride
        c = active & (cand < last) & (_delta(codes, first, cand, n) > d_node)
        split = jnp.where(c, cand, split)
        active = active & (stride > 1)

    leaf_base = jnp.int32(n - 1)
    left = jnp.where(split == first, leaf_base + split, split)
    right = jnp.where(split + 1 == last, leaf_base + split + 1, split + 1)
    return left, right


@partial(jax.jit, static_argnames=("n",))
def _fit_aabbs(left, right, leaf_min, leaf_max, n: int):
    """Bottom-up AABB fit as a device fixpoint loop (<= tree height
    iterations; the reference polls a done-counter from the host,
    LBvh.py:206-218)."""
    n_int = n - 1
    big = jnp.float32(3.4e38)

    def child_box(c, int_min, int_max, ready):
        is_leaf = c >= n_int
        li = jnp.clip(c - n_int, 0, n - 1)
        ii = jnp.clip(c, 0, max(n_int - 1, 0))
        cmin = jnp.where(is_leaf[:, None], leaf_min[li], int_min[ii])
        cmax = jnp.where(is_leaf[:, None], leaf_max[li], int_max[ii])
        cready = jnp.where(is_leaf, True, ready[ii])
        return cmin, cmax, cready

    def cond(state):
        ready, _, _, it = state
        return (~jnp.all(ready)) & (it < n_int + 1)

    def body(state):
        ready, int_min, int_max, it = state
        lmin, lmax, lready = child_box(left, int_min, int_max, ready)
        rmin, rmax, rready = child_box(right, int_min, int_max, ready)
        now = lready & rready & (~ready)
        new_min = jnp.where(now[:, None], jnp.minimum(lmin, rmin), int_min)
        new_max = jnp.where(now[:, None], jnp.maximum(lmax, rmax), int_max)
        return ready | now, new_min, new_max, it + 1

    init = (
        jnp.zeros((n_int,), dtype=bool),
        jnp.full((n_int, 3), big),
        jnp.full((n_int, 3), -big),
        jnp.int32(0),
    )
    ready, int_min, int_max, _ = jax.lax.while_loop(cond, body, init)
    return int_min, int_max, ready


def build_lbvh_device(prim_min, prim_max, scene_min, scene_max):
    """Device portion of the build.

    prim_min/prim_max: (n,3) per-primitive AABBs.
    Returns dict with sorted prim order, children and all node AABBs
    (fat tree, pre-flatten).
    """
    n = int(prim_min.shape[0])
    centroid = 0.5 * (prim_min + prim_max)
    extent = jnp.maximum(scene_max - scene_min, 1e-12)
    q = (centroid - scene_min) / extent
    codes = morton3d(q[..., 0], q[..., 1], q[..., 2])

    idx = jnp.arange(n, dtype=jnp.int32)
    sorted_codes, sorted_idx = jax.lax.sort((codes, idx), num_keys=1, is_stable=True)

    leaf_min = prim_min[sorted_idx]
    leaf_max = prim_max[sorted_idx]

    if n == 1:
        return dict(
            n=1,
            sorted_idx=sorted_idx,
            left=jnp.zeros((0,), jnp.int32),
            right=jnp.zeros((0,), jnp.int32),
            leaf_min=leaf_min,
            leaf_max=leaf_max,
            int_min=jnp.zeros((0, 3), jnp.float32),
            int_max=jnp.zeros((0, 3), jnp.float32),
        )

    left, right = _karras_topology(sorted_codes, n)
    int_min, int_max, ready = _fit_aabbs(left, right, leaf_min, leaf_max, n)
    return dict(
        n=n,
        sorted_idx=sorted_idx,
        left=left,
        right=right,
        leaf_min=leaf_min,
        leaf_max=leaf_max,
        int_min=int_min,
        int_max=int_max,
        ready=ready,
    )


def flatten_threaded(tree) -> dict:
    """Host-side DFS flatten of the fat tree into threaded compact nodes.

    Output arrays, all length 2n-1 (DFS preorder):
      node_min/node_max: (K,3) f32
      node_prim:  int32, original primitive id at leaves, -1 at inner nodes
      node_escape:int32, DFS index of the next subtree (K = traversal end)

    One-time O(n) startup work, same placement as the reference's host
    flatten (LBvh.py:138-173).
    """
    n = int(tree["n"])
    sorted_idx = np.asarray(tree["sorted_idx"])
    leaf_min = np.asarray(tree["leaf_min"])
    leaf_max = np.asarray(tree["leaf_max"])

    K = 2 * n - 1
    node_min = np.zeros((K, 3), np.float32)
    node_max = np.zeros((K, 3), np.float32)
    node_prim = np.full((K,), -1, np.int32)
    node_escape = np.zeros((K,), np.int32)

    if n == 1:
        node_min[0] = leaf_min[0]
        node_max[0] = leaf_max[0]
        node_prim[0] = sorted_idx[0]
        node_escape[0] = 1
        return dict(
            bvh_min=node_min,
            bvh_max=node_max,
            bvh_prim=node_prim,
            bvh_escape=node_escape,
        )

    left = np.asarray(tree["left"])
    right = np.asarray(tree["right"])
    int_min = np.asarray(tree["int_min"])
    int_max = np.asarray(tree["int_max"])
    n_int = n - 1

    sizes = _subtree_sizes(left, right, n_int)

    out = 0
    # Preorder walk with the escape index carried down:
    #   escape(left child)  = DFS start of the right child
    #   escape(right child) = escape(parent)
    pending: list = [(0, K)]  # (node_id, escape_index)
    while pending:
        node_id, esc = pending.pop()
        my = out
        out += 1
        node_escape[my] = esc
        if node_id >= n_int:  # leaf
            k = node_id - n_int
            node_min[my] = leaf_min[k]
            node_max[my] = leaf_max[k]
            node_prim[my] = sorted_idx[k]
        else:
            node_min[my] = int_min[node_id]
            node_max[my] = int_max[node_id]
            l, r = int(left[node_id]), int(right[node_id])
            l_size = 1 if l >= n_int else int(sizes[l])
            right_start = my + 1 + l_size
            pending.append((r, esc))
            pending.append((l, right_start))
    assert out == K, (out, K)
    return dict(
        bvh_min=node_min,
        bvh_max=node_max,
        bvh_prim=node_prim,
        bvh_escape=node_escape,
    )


def _subtree_sizes(left, right, n_int: int) -> np.ndarray:
    """Node count of every internal subtree, via one iterative post-order
    pass (handles degenerate morton-chain trees without recursion)."""
    sizes = np.zeros((max(n_int, 1),), np.int64)
    stack = [(0, False)]
    while stack:
        nd, expanded = stack.pop()
        if nd >= n_int:
            continue
        l, r = int(left[nd]), int(right[nd])
        if expanded:
            ls = 1 if l >= n_int else sizes[l]
            rs = 1 if r >= n_int else sizes[r]
            sizes[nd] = 1 + ls + rs
        else:
            stack.append((nd, True))
            stack.append((l, False))
            stack.append((r, False))
    return sizes


def _build_device():
    try:
        return jax.local_devices(backend="cpu")[0]
    except RuntimeError:  # the CPU backend is not among JAX_PLATFORMS
        return jax.local_devices()[0]


def build_bvh(prim_min, prim_max, scene_min, scene_max) -> dict:
    """Full build: device morton/sort/topology/fit + host threaded flatten.
    Inputs are numpy or jnp (n,3) arrays; returns numpy compact arrays.

    The build runs on the host CPU backend where JAX has one: it is
    one-time scene prep, and compiling its per-scene-size programs for
    the accelerator buys nothing for the render loop (the reference's
    equivalent is its host-orchestrated startup path, LBvh.py:192-226).
    With the CPU backend excluded (JAX_PLATFORMS=cuda) it runs on the
    default device; the result is the same.
    """
    with jax.default_device(_build_device()):
        prim_min = jnp.asarray(np.asarray(prim_min), jnp.float32)
        prim_max = jnp.asarray(np.asarray(prim_max), jnp.float32)
        scene_min = jnp.asarray(np.asarray(scene_min), jnp.float32)
        scene_max = jnp.asarray(np.asarray(scene_max), jnp.float32)
        tree = build_lbvh_device(prim_min, prim_max, scene_min, scene_max)
    tree = {k: (np.asarray(v) if hasattr(v, "shape") else v) for k, v in tree.items()}
    return flatten_threaded(tree)


# ---------------------------------------------------------------------------
# validation helpers: the reference's printf checks (LBvh.py:97-123,75-94)
# as pure predicates for pytest.
# ---------------------------------------------------------------------------

def check_containment(compact) -> bool:
    """Parent box contains both children (print_node_info equivalent)."""
    bmin = compact["bvh_min"]
    bmax = compact["bvh_max"]
    esc = compact["bvh_escape"]
    prim = compact["bvh_prim"]
    K = bmin.shape[0]
    eps = 1e-4
    for i in range(K):
        if prim[i] >= 0:
            continue
        l = i + 1
        r = int(esc[l])  # escape of left child = start of right child
        for c in (l, r):
            if not (
                np.all(bmin[i] <= bmin[c] + eps) and np.all(bmax[i] >= bmax[c] - eps)
            ):
                return False
    return True


def check_coverage(compact, n_prims: int) -> bool:
    """Every primitive appears exactly once in a leaf."""
    prim = compact["bvh_prim"]
    leaves = np.sort(prim[prim >= 0])
    return leaves.shape[0] == n_prims and np.array_equal(
        leaves, np.arange(n_prims, dtype=leaves.dtype)
    )


def dump_nodes(compact, path: str) -> None:
    """Write every compact node to a text file for inspection — the
    reference dumps nodelist.txt at build (LBvh.py:164-172)."""
    bmin = np.asarray(compact["bvh_min"])
    bmax = np.asarray(compact["bvh_max"])
    prim = np.asarray(compact["bvh_prim"])
    esc = np.asarray(compact["bvh_escape"])
    with open(path, "w") as f:
        for i in range(prim.shape[0]):
            kind = "leaf" if prim[i] >= 0 else "node"
            f.write(
                f"{i} {kind} prim={prim[i]} escape={esc[i]} "
                f"min=({bmin[i,0]:.6f},{bmin[i,1]:.6f},{bmin[i,2]:.6f}) "
                f"max=({bmax[i,0]:.6f},{bmax[i,1]:.6f},{bmax[i,2]:.6f})\n"
            )
