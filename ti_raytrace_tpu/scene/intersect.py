"""Ray-primitive intersection, vectorized over wavefronts.

Replaces the reference's per-lane routines (Scene.py:530-669) with
whole-batch math.  Key structural change: traversal only computes
the hit distance `t` per candidate; the full hit record (position, normals,
uv, material) is reconstructed *once per bounce* from the winning
primitive id (`hit_attributes`), instead of per BVH leaf visit like the
reference's intersect_prim (Scene.py:530-560).
"""

import jax.numpy as jnp

from ti_raytrace_tpu.core import constants as C
from ti_raytrace_tpu.utils import vec


def intersect_tri_soup(origin, direction, v0, e1, e2):
    """Möller-Trumbore, two-sided (reference Scene.py:604-638).

    origin/direction: (..., 3); v0/e1/e2: (..., 3) gathered per-lane.
    Returns (t, u, v) with t = INF on miss; t may be any sign on hit —
    callers filter t > 0 exactly like the reference's closest-hit loop.
    """
    p = vec.cross(direction, e2)
    det = vec.dot(e1, p)
    # two-sided: fold the determinant sign into T
    tvec = jnp.where(det[..., None] > 0.0, origin - v0, v0 - origin)
    adet = jnp.abs(det)
    u = vec.dot(tvec, p)
    q = vec.cross(tvec, e1)
    v = vec.dot(direction, q)
    t = vec.dot(e2, q)
    ok = (adet > 1e-12) & (u >= 0.0) & (u <= adet) & (v >= 0.0) & (u + v <= adet)
    inv = 1.0 / jnp.where(adet > 1e-12, adet, 1.0)
    return (
        jnp.where(ok, t * inv, C.INF),
        jnp.where(ok, u * inv, 0.0),
        jnp.where(ok, v * inv, 0.0),
    )


def intersect_sphere(origin, direction, centre, radius):
    """Nearest-root ray/sphere hit (reference Scene.py:565-596).
    Returns t (INF on miss; negative t possible when origin is past the
    centre — filtered by t > 0 downstream, same as the reference)."""
    oc = centre - origin
    dis_oc_sq = vec.dot(oc, oc)
    dis_op = vec.dot(direction, oc)
    disc = dis_oc_sq - dis_op * dis_op
    inside_cyl = disc < radius * radius
    a = vec.dot(direction, direction)
    b = -2.0 * dis_op
    c = dis_oc_sq - radius * radius
    discr = jnp.maximum(b * b - 4.0 * a * c, 0.0)
    t = (-b - jnp.sqrt(discr)) / (2.0 * jnp.maximum(a, 1e-12))
    return jnp.where(inside_cyl, t, C.INF)


def intersect_prim_any(scene, origin, direction, prim_id):
    """Distance-only intersection against primitive `prim_id` (per lane).

    Used by the traversal inner loop (both closest and shadow passes).
    Shape prims other than spheres are non-intersectable, like the
    reference (Scene.py:642-669).
    """
    pid = jnp.clip(prim_id, 0, scene.n_prims - 1)
    ptype = scene.prim_type[pid]

    t_tri, _, _ = intersect_tri_soup(
        origin, direction, scene.tri_v0[pid], scene.tri_e1[pid], scene.tri_e2[pid]
    )

    sid = jnp.clip(scene.prim_vidx[pid], 0, max(scene.shape_type.shape[0] - 1, 0))
    stype = scene.shape_type[sid]
    t_sph = intersect_sphere(
        origin, direction, scene.shape_pos[sid], scene.shape_param[sid, ..., 0]
    )
    t_shape = jnp.where(stype == C.SHAPE_SPHERE, t_sph, C.INF)

    return jnp.where(ptype == C.PRIM_TRI, t_tri, t_shape)


def hit_attributes(scene, origin, direction, t, prim_id):
    """Reconstruct the full hit record from the winning primitive.

    Returns dict(pos, gnormal, normal, uv, mat_id, valid).
    Mirrors the attribute math of Scene.intersect_prim (Scene.py:537-600)
    but runs once per bounce.  Sphere normals use the centre (the reference
    subtracts a scalar quadratic coefficient at Scene.py:595 — a bug we fix;
    documented in PARITY.md).
    """
    valid = (t < C.INF) & (prim_id >= 0)
    pid = jnp.clip(prim_id, 0, scene.n_prims - 1)
    ptype = scene.prim_type[pid]

    # --- triangle attributes ------------------------------------------
    v0 = scene.tri_v0[pid]
    e1 = scene.tri_e1[pid]
    e2 = scene.tri_e2[pid]
    _, u, v = intersect_tri_soup(origin, direction, v0, e1, e2)
    a = 1.0 - u - v
    vi = jnp.clip(scene.prim_vidx[pid], 0, max(scene.vtx_pos.shape[0] - 3, 0))
    n1 = scene.vtx_normal[vi + 0]
    n2 = scene.vtx_normal[vi + 1]
    n3 = scene.vtx_normal[vi + 2]
    t1 = scene.vtx_uv[vi + 0]
    t2 = scene.vtx_uv[vi + 1]
    t3 = scene.vtx_uv[vi + 2]
    aa, bb, cc = a[..., None], u[..., None], v[..., None]
    tri_pos = v0 + bb * e1 + cc * e2
    tri_gn = vec.cross(e1, e2)
    tri_n = aa * n1 + bb * n2 + cc * n3
    tri_uv = aa * t1 + bb * t2 + cc * t3

    # --- sphere attributes --------------------------------------------
    sid = jnp.clip(scene.prim_vidx[pid], 0, max(scene.shape_type.shape[0] - 1, 0))
    centre = scene.shape_pos[sid]
    sph_pos = origin + t[..., None] * direction
    sph_n = sph_pos - centre

    is_tri = (ptype == C.PRIM_TRI)[..., None]
    pos = jnp.where(is_tri, tri_pos, sph_pos)
    gnormal = vec.normalize(jnp.where(is_tri, tri_gn, sph_n))
    normal = vec.normalize(jnp.where(is_tri, tri_n, sph_n))
    uv = jnp.where((ptype == C.PRIM_TRI)[..., None], tri_uv, jnp.zeros_like(tri_uv))

    mat_id = jnp.where(valid, scene.prim_mat[pid], 0)
    return dict(
        pos=pos, gnormal=gnormal, normal=normal, uv=uv, mat_id=mat_id, valid=valid
    )
