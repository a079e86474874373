"""Stackless BVH traversal over whole ray wavefronts.

The reference walks a per-pixel stack in a megakernel
(Scene.closet_hit, Scene.py:703-744).  Here XLA traverses the *threaded*
compact BVH (see accel/lbvh.py): every ray carries a single node cursor;
descending moves to idx+1 (left child is next in DFS order, same layout
trick as the reference's compact node), and skipping a subtree jumps to
escape[idx].  State per ray is 3 scalars — no stack memory, no scatters,
no overflow — and one `lax.while_loop` iteration advances every ray one
node in lockstep.  This plain-XLA tracer is the oracle that the cluster
kernel (ops/cluster_trace.py) is tested against.

Early-out: a subtree is skipped when the box entry distance exceeds the
current best hit (an optimization the reference lacks).
"""

import jax
import jax.numpy as jnp

from ti_raytrace_tpu.core import constants as C
from ti_raytrace_tpu.scene.intersect import intersect_prim_any
from ti_raytrace_tpu.utils.geometry import slabs


def trace_closest(scene, origin, direction):
    """Closest-hit over the scene BVH.

    origin/direction: (N, 3).  Returns (t, prim_id): t = INF and
    prim_id = -1 on miss.  Matches the reference's acceptance rule
    `t > 0 and t < best` (Scene.py:723).
    """
    n_nodes = scene.n_nodes
    N = origin.shape[0]

    def cond(state):
        idx, _, _ = state
        return jnp.any(idx < n_nodes)

    def body(state):
        idx, best_t, best_prim = state
        active = idx < n_nodes
        nidx = jnp.clip(idx, 0, n_nodes - 1)

        nmin = scene.bvh_min[nidx]
        nmax = scene.bvh_max[nidx]
        prim = scene.bvh_prim[nidx]
        esc = scene.bvh_escape[nidx]
        is_leaf = prim >= 0

        box_hit, _ = slabs(origin, direction, nmin, nmax, t_max=best_t)

        # leaf: distance-only primitive test
        t = intersect_prim_any(scene, origin, direction, jnp.maximum(prim, 0))
        closer = active & is_leaf & box_hit & (t > 0.0) & (t < best_t)
        best_t = jnp.where(closer, t, best_t)
        best_prim = jnp.where(closer, prim, best_prim)

        descend = active & (~is_leaf) & box_hit
        nxt = jnp.where(descend, nidx + 1, esc)
        idx = jnp.where(active, nxt, idx)
        return idx, best_t, best_prim

    init = (
        jnp.zeros((N,), jnp.int32),
        jnp.full((N,), C.INF, jnp.float32),
        jnp.full((N,), -1, jnp.int32),
    )
    _, t, prim = jax.lax.while_loop(cond, body, init)
    return t, prim


def trace_closest_masked(scene, origin, direction, mask):
    """trace_closest for a subset of lanes; inactive lanes return a miss
    immediately (their cursor starts at the end)."""
    n_nodes = scene.n_nodes
    N = origin.shape[0]

    t, prim = trace_closest(
        scene,
        jnp.where(mask[:, None], origin, jnp.zeros_like(origin)),
        jnp.where(mask[:, None], direction, jnp.ones_like(direction)),
    )
    return jnp.where(mask, t, C.INF), jnp.where(mask, prim, -1)


def trace_brute_force(scene, origin, direction):
    """Reference oracle: test every primitive for every ray.

    Used by tests (traversal == brute force) and efficient for tiny scenes
    where (N_rays x P) is small.  Blocked over primitives to bound memory.
    """
    N = origin.shape[0]
    P = scene.n_prims
    block = 512

    def body(p0, state):
        best_t, best_prim = state
        pid = p0 + jnp.arange(block, dtype=jnp.int32)  # (B,)
        pvalid = pid < P
        pid_c = jnp.clip(pid, 0, P - 1)
        t = intersect_prim_any(
            scene,
            origin[:, None, :],
            direction[:, None, :],
            jnp.broadcast_to(pid_c[None, :], (N, block)),
        )  # (N, B)
        t = jnp.where(pvalid[None, :] & (t > 0.0), t, C.INF)
        arg = jnp.argmin(t, axis=1)
        tmin = jnp.take_along_axis(t, arg[:, None], axis=1)[:, 0]
        closer = tmin < best_t
        best_t = jnp.where(closer, tmin, best_t)
        best_prim = jnp.where(closer, pid_c[arg], best_prim)
        return best_t, best_prim

    n_blocks = (P + block - 1) // block
    best_t = jnp.full((N,), C.INF, jnp.float32)
    best_prim = jnp.full((N,), -1, jnp.int32)
    for b in range(n_blocks):
        best_t, best_prim = body(jnp.int32(b * block), (best_t, best_prim))
    return best_t, best_prim
