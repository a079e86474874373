"""Dense planar tracer + one-hot shading-attribute extraction.

Every lane is tested against every primitive, in blocks of BLOCK
primitives: dense Möller-Trumbore in planar layout, no pointer chasing.
For scenes up to a few thousand primitives this is the production tracer
(`ti_raytrace_tpu.accel.trace` dispatches on the static primitive count;
the cut-over was chosen on the previous accelerator and has not been
measured on the GPU).

The winning primitive's shading data (normals, uvs, material, emitter
info — a column of scene.prim_attr) is extracted with a one-hot matmul,
(A, B) @ (B, N) at Precision.HIGHEST, instead of a gather: one small
matmul per primitive block.

All wavefront tensors are planar: rays are (3, N), attributes (A, N),
with the wavefront on the minor axis.
"""

import jax
import jax.numpy as jnp

from ti_raytrace_tpu.core import constants as C

BLOCK = 128


def scene_has_shapes(scene) -> bool:
    """Static: does the scene contain analytic-shape primitives?  The
    builder emits exactly one prim per triangle corner-triple, so shape
    prims exist iff P exceeds the triangle count."""
    tri_count = scene.vtx_pos.shape[0] // 3
    return scene.n_prims != tri_count



def _block_t_uv(scene, o, d, p0: int, blk: int, with_shapes: bool = True):
    """Hit distances for prims [p0, p0+blk) x rays, planar (blk, N).

    Triangles: two-sided Möller-Trumbore (reference Scene.py:604-638).
    PRIM_SHAPE spheres: nearest-root quadratic (Scene.py:565-596).
    Returns (t, u, v): t = INF invalid, sign of t NOT yet filtered.
    """
    ox, oy, oz = o[0][None, :], o[1][None, :], o[2][None, :]
    dx, dy, dz = d[0][None, :], d[1][None, :], d[2][None, :]
    sl = slice(p0, p0 + blk)

    v0 = scene.tri_v0[sl]
    e1 = scene.tri_e1[sl]
    e2 = scene.tri_e2[sl]
    v0x, v0y, v0z = v0[:, 0:1], v0[:, 1:2], v0[:, 2:3]
    e1x, e1y, e1z = e1[:, 0:1], e1[:, 1:2], e1[:, 2:3]
    e2x, e2y, e2z = e2[:, 0:1], e2[:, 1:2], e2[:, 2:3]

    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    s = jnp.sign(det)
    adet = jnp.abs(det)
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    u = (tx * px + ty * py + tz * pz) * s
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * s
    t_tri = (e2x * qx + e2y * qy + e2z * qz) * s
    ok = (adet > 1e-12) & (u >= 0.0) & (u <= adet) & (v >= 0.0) & (u + v <= adet)
    inv = 1.0 / jnp.where(adet > 1e-12, adet, 1.0)
    t_tri = jnp.where(ok, t_tri * inv, C.INF)
    u = jnp.where(ok, u * inv, 0.0)
    v = jnp.where(ok, v * inv, 0.0)

    ptype = scene.prim_type[sl][:, None]
    is_tri = ptype == C.PRIM_TRI

    if not with_shapes:
        # statically shape-free scene: skip the sphere branch entirely
        return jnp.where(is_tri, t_tri, C.INF), u, v

    has_shape = ptype == C.PRIM_SHAPE
    sid = jnp.clip(scene.prim_vidx[sl], 0, scene.shape_type.shape[0] - 1)
    stype = scene.shape_type[sid][:, None]
    cpos = scene.shape_pos[sid]
    rad = scene.shape_param[sid, 0][:, None]
    ocx = cpos[:, 0:1] - ox
    ocy = cpos[:, 1:2] - oy
    ocz = cpos[:, 2:3] - oz
    oc2 = ocx * ocx + ocy * ocy + ocz * ocz
    dop = dx * ocx + dy * ocy + dz * ocz
    disc2 = oc2 - dop * dop
    a = dx * dx + dy * dy + dz * dz
    b = -2.0 * dop
    cc = oc2 - rad * rad
    discr = jnp.maximum(b * b - 4.0 * a * cc, 0.0)
    t_sph = (-b - jnp.sqrt(discr)) / (2.0 * jnp.maximum(a, 1e-12))
    sph_ok = has_shape & (stype == C.SHAPE_SPHERE) & (disc2 < rad * rad)

    t = jnp.where(is_tri, t_tri, jnp.where(sph_ok, t_sph, C.INF))
    return t, u, v


def trace_planar(scene, o, d):
    """Closest hit, planar rays (3, N) -> (t, prim)."""
    t, prim, _, _ = _sweep(scene, o, d, want_uv=False)
    return t, prim


def trace_planar_capped(scene, o, d, active, cap_frac: float):
    """Closest hit with active-lane packing: the dense sweep costs
    N x P for EVERY lane (no early exit exists in a full block sweep),
    so wavefronts that are mostly parked — BDPT's fused shadow batch is
    6.8% active on prism_rainbow — pay ~15x their useful work.  Packs
    the active lanes to a static-capacity prefix (alive-first stable
    sort, the pt_rgb._compact contract), sweeps only the prefix, and
    scatters (t, prim) back; inactive and over-capacity lanes report
    miss (INF, -1), matching the cluster tracer's cap_frac contract
    (accel.trace: callers may only read lanes they marked active, and
    actives cut at capacity read as misses — "occluded" to the shadow
    consumers — so caps need measured headroom)."""
    N = o.shape[1]
    W = int(N * float(cap_frac))
    W = min(N, max(128, (W + 127) // 128 * 128))
    key = jnp.where(active, jnp.uint32(0), jnp.uint32(1))
    idx = jnp.arange(N, dtype=jnp.int32)
    _, order = jax.lax.sort((key, idx), num_keys=1, is_stable=True)
    sel = order[:W]
    rows = jnp.concatenate([o, d], axis=0)                     # (6, N)
    rows = jnp.swapaxes(jnp.take(jnp.swapaxes(rows, 0, 1), sel, axis=0), 0, 1)
    t_c, prim_c = trace_planar(scene, rows[0:3], rows[3:6])
    t = jnp.full((N,), C.INF, jnp.float32).at[sel].set(t_c)
    prim = jnp.full((N,), -1, jnp.int32).at[sel].set(prim_c)
    return t, prim


def trace_shaded(scene, o, d):
    """Closest hit + full shading pack.

    Returns (t, prim, uv_bary, attr):
      t (N,), prim (N,) int32 (-1 miss), uv_bary (2, N) barycentrics,
      attr (32, N) — the winning primitive's scene.prim_attr column
      (zeros on miss).
    """
    t, prim, uvw, attr = _sweep(scene, o, d, want_uv=True)
    return t, prim, uvw, attr


def _sweep(scene, o, d, want_uv: bool):
    """Block sweep as a `lax.fori_loop` over padded prim blocks — graph
    size stays O(1) in the prim count (the BDPT frame graph contains ~50
    traces; a Python-unrolled block loop would explode compile time)."""
    N = o.shape[1]
    P = scene.n_prims
    A = scene.prim_attr.shape[0]
    # one fixed block size for every scene (not yet tuned on the GPU)
    blk_rows = BLOCK
    with_shapes = scene_has_shapes(scene)
    n_blocks = (P + blk_rows - 1) // blk_rows
    P_pad = n_blocks * blk_rows
    pad = P_pad - P

    # pad the hot arrays so every dynamic block slice is in-bounds;
    # padded prims are degenerate (type NONE -> INF)
    sc = dict(
        tri_v0=jnp.pad(scene.tri_v0, ((0, pad), (0, 0))),
        tri_e1=jnp.pad(scene.tri_e1, ((0, pad), (0, 0))),
        tri_e2=jnp.pad(scene.tri_e2, ((0, pad), (0, 0))),
        prim_type=jnp.pad(scene.prim_type, (0, pad)),
        prim_vidx=jnp.pad(scene.prim_vidx, (0, pad)),
        shape_type=scene.shape_type,
        shape_pos=scene.shape_pos,
        shape_param=scene.shape_param,
    )
    attr_pad = jnp.pad(scene.prim_attr, ((0, 0), (0, pad)))
    blk_iota = jnp.arange(blk_rows, dtype=jnp.int32)[:, None]

    def body(b, state):
        best_t, best_prim, best_uv, best_attr = state
        p0 = b * blk_rows
        blk = {
            k: jax.lax.dynamic_slice_in_dim(v, p0, blk_rows, axis=0)
            for k, v in sc.items()
            if k.startswith(("tri_", "prim_"))
        }
        blk.update(
            shape_type=sc["shape_type"],
            shape_pos=sc["shape_pos"],
            shape_param=sc["shape_param"],
        )
        view = _BlockView(**blk)
        t, u, v = _block_t_uv(view, o, d, 0, blk_rows, with_shapes)
        t = jnp.where(t > 0.0, t, C.INF)
        tmin = jnp.min(t, axis=0)
        closer = tmin < best_t
        arg = jnp.argmin(t, axis=0)
        best_t = jnp.where(closer, tmin, best_t)
        best_prim = jnp.where(closer, p0 + arg.astype(jnp.int32), best_prim)

        if want_uv:
            oh_f = (blk_iota == arg[None, :]).astype(jnp.float32)
            u_win = jnp.sum(u * oh_f, axis=0)
            v_win = jnp.sum(v * oh_f, axis=0)
            best_uv = jnp.where(closer[None, :], jnp.stack([u_win, v_win]), best_uv)
            # HIGHEST: a reduced-precision (bf16/TF32) product would
            # round the attrs
            attr_blk = jnp.dot(
                jax.lax.dynamic_slice_in_dim(attr_pad, p0, blk_rows, axis=1),
                oh_f,
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST,
            )
            best_attr = jnp.where(closer[None, :], attr_blk, best_attr)
        return best_t, best_prim, best_uv, best_attr

    init = (
        jnp.full((N,), C.INF, jnp.float32),
        jnp.full((N,), -1, jnp.int32),
        jnp.zeros((2, N), jnp.float32),
        jnp.zeros((A, N), jnp.float32),
    )
    if n_blocks <= 4:
        state = init
        for b in range(n_blocks):
            state = body(jnp.int32(b), state)
        return state
    return jax.lax.fori_loop(0, n_blocks, body, init)


class _BlockView:
    """Duck-typed scene view holding one prim block (for _block_t_uv)."""

    def __init__(self, tri_v0, tri_e1, tri_e2, prim_type, prim_vidx,
                 shape_type, shape_pos, shape_param):
        self.tri_v0 = tri_v0
        self.tri_e1 = tri_e1
        self.tri_e2 = tri_e2
        self.prim_type = prim_type
        self.prim_vidx = prim_vidx
        self.shape_type = shape_type
        self.shape_pos = shape_pos
        self.shape_param = shape_param


def trace_dense(scene, origin_rows, direction_rows):
    """Row-layout compatibility wrapper: (N, 3) rays -> (t, prim), same
    contract as accel.traverse.trace_closest."""
    o = jnp.swapaxes(origin_rows, 0, 1)
    d = jnp.swapaxes(direction_rows, 0, 1)
    return trace_planar(scene, o, d)
