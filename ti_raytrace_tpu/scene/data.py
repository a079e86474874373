"""Scene representation: a frozen pytree of SoA `jnp` arrays.

This is the array-native replacement for the reference's Taichi dense fields
(Scene.py:36-45 + SceneData.py record layouts).  Differences by design:

  * Typed, named arrays instead of float lanes with getter functions
    (UtilsFunc.py:126-198) — XLA lays each array out independently.
  * Triangle geometry is pre-gathered per primitive (v0, e1, e2) so the
    traversal inner loop only touches 9 floats per candidate; shading
    attributes (normals/uv) are fetched once per bounce from the vertex
    arrays, not per BVH leaf visit like the reference (Scene.py:530-600).
  * The BVH is stored in threaded/escape-index form: traversal follows a
    single index per ray (descend -> idx+1, skip -> escape[idx]) instead of
    a per-pixel stack field (reference Scene.py:703-744).  No scatter ops,
    no stack memory, no overflow.
  * Light data is pre-flattened (areas, emission) for vectorized NEE.

All counts are static shapes -> everything jits once per scene size.
"""

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np


class SceneData(NamedTuple):
    # --- materials --------------------------------------------------- (M,)
    mat_type: jnp.ndarray      # int32: MAT_DISNEY/GLASS/LIGHT/SPECTRAL
    mat_tex: jnp.ndarray       # int32: albedo texture id, -1 = none
    mat_color: jnp.ndarray     # (M,3) f32: color / emission (sRGB like ref)
    mat_p0: jnp.ndarray        # f32: metallic (disney) | ior (glass)
    mat_p1: jnp.ndarray        # f32: roughness (disney) | extinction (glass)

    # --- primitives -------------------------------------------------- (P,)
    prim_type: jnp.ndarray     # int32: PRIM_TRI / PRIM_SHAPE
    prim_vidx: jnp.ndarray     # int32: base vertex index (tri) | shape index
    prim_mat: jnp.ndarray      # int32: material index
    prim_area: jnp.ndarray     # f32: surface area (Heron / pi r^2)

    # --- triangle hot data (pre-gathered; zero rows for shape prims) --
    tri_v0: jnp.ndarray        # (P,3) f32
    tri_e1: jnp.ndarray        # (P,3) f32: v1 - v0
    tri_e2: jnp.ndarray        # (P,3) f32: v2 - v0

    # --- vertices (3 per triangle, duplicated per corner like the ref) (V,)
    vtx_pos: jnp.ndarray       # (V,3) f32
    vtx_normal: jnp.ndarray    # (V,3) f32
    vtx_uv: jnp.ndarray        # (V,2) f32

    # --- analytic shapes --------------------------------------------- (S,)
    shape_type: jnp.ndarray    # int32: SHAPE_SPHERE/QUAD/SPOT/LASER
    shape_pos: jnp.ndarray     # (S,3) f32
    shape_param: jnp.ndarray   # (S,6) f32 (radius | v1 v2 | x1 x2 scale n)

    # --- lights ------------------------------------------------------ (L,)
    light_prim: jnp.ndarray    # int32: primitive index of each emitter

    # --- environment map ---------------------------------------------
    env_img: jnp.ndarray       # (Eh,Ew,3) f32 sRGB-encoded texels in [0,1]
    env_power: jnp.ndarray     # f32 scalar

    # --- acceleration structure (threaded compact BVH, DFS order) ---- (K,)
    bvh_min: jnp.ndarray       # (K,3) f32
    bvh_max: jnp.ndarray       # (K,3) f32
    bvh_prim: jnp.ndarray      # int32: primitive id at leaf, -1 for inner
    bvh_escape: jnp.ndarray    # int32: DFS index after this subtree (K = end)

    # --- planar packed attribute tables (see scene/packs.py) ---------
    prim_attr: jnp.ndarray     # (32, P) f32: per-prim shading pack
    light_attr: jnp.ndarray    # (32, L) f32: per-light sampling pack

    # --- cluster acceleration (see accel/clusters.py) ----------------
    cluster_bounds: jnp.ndarray  # (8, C) f32 cluster AABBs
    cluster_tri: jnp.ndarray     # (10, C*B) f32 planar triangle blocks

    # --- global ------------------------------------------------------
    aabb_min: jnp.ndarray      # (3,) f32 scene bounds
    aabb_max: jnp.ndarray      # (3,) f32

    @property
    def n_prims(self) -> int:
        return int(self.prim_type.shape[0])

    @property
    def n_lights(self) -> int:
        return int(self.light_prim.shape[0])

    @property
    def n_materials(self) -> int:
        return int(self.mat_type.shape[0])

    @property
    def n_nodes(self) -> int:
        return int(self.bvh_prim.shape[0])


def device_scene(host: dict) -> SceneData:
    """Assemble a SceneData pytree from a dict of numpy arrays."""
    def arr(x, dt):
        return jnp.asarray(np.asarray(x), dtype=dt)

    return SceneData(
        mat_type=arr(host["mat_type"], jnp.int32),
        mat_tex=arr(host["mat_tex"], jnp.int32),
        mat_color=arr(host["mat_color"], jnp.float32),
        mat_p0=arr(host["mat_p0"], jnp.float32),
        mat_p1=arr(host["mat_p1"], jnp.float32),
        prim_type=arr(host["prim_type"], jnp.int32),
        prim_vidx=arr(host["prim_vidx"], jnp.int32),
        prim_mat=arr(host["prim_mat"], jnp.int32),
        prim_area=arr(host["prim_area"], jnp.float32),
        tri_v0=arr(host["tri_v0"], jnp.float32),
        tri_e1=arr(host["tri_e1"], jnp.float32),
        tri_e2=arr(host["tri_e2"], jnp.float32),
        vtx_pos=arr(host["vtx_pos"], jnp.float32),
        vtx_normal=arr(host["vtx_normal"], jnp.float32),
        vtx_uv=arr(host["vtx_uv"], jnp.float32),
        shape_type=arr(host["shape_type"], jnp.int32),
        shape_pos=arr(host["shape_pos"], jnp.float32),
        shape_param=arr(host["shape_param"], jnp.float32),
        light_prim=arr(host["light_prim"], jnp.int32),
        env_img=arr(host["env_img"], jnp.float32),
        env_power=arr(host["env_power"], jnp.float32),
        bvh_min=arr(host["bvh_min"], jnp.float32),
        bvh_max=arr(host["bvh_max"], jnp.float32),
        bvh_prim=arr(host["bvh_prim"], jnp.int32),
        bvh_escape=arr(host["bvh_escape"], jnp.int32),
        prim_attr=arr(host["prim_attr"], jnp.float32),
        light_attr=arr(host["light_attr"], jnp.float32),
        cluster_bounds=arr(host["cluster_bounds"], jnp.float32),
        cluster_tri=arr(host["cluster_tri"], jnp.float32),
        aabb_min=arr(host["aabb_min"], jnp.float32),
        aabb_max=arr(host["aabb_max"], jnp.float32),
    )
