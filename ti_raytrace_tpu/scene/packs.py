"""Packed per-primitive / per-light attribute tables.

The render loop never does per-lane gathers: instead, all shading data of
a primitive lives in one column of a planar (A, P) table, and the winning
primitive's column is extracted with a one-hot matmul
(ops/dense_trace.trace_shaded) or gathered once per trace
(ops/cluster_trace).  The one-hot trick also serves light sampling.

Column layouts (float32):

PRIM_ATTR (A = 32) — everything needed at a hit point:
   0: 2 unit geometric normal (zeros for sphere prims -> derived)
   3: 5 corner shading normal n1
   6: 8 corner shading normal n2
   9:11 corner shading normal n3
  12:14 uv1.u, uv1.v, uv2.u
  15:17 uv2.v, uv3.u, uv3.v
  18    mat_type
  19:21 mat_color (sRGB, as authored)
  22    mat_p0 (metallic | ior)
  23    mat_p1 (roughness | extinction)
  24    prim area
  25    is_shape (1.0 if PRIM_SHAPE)
  26:28 shape position (sphere centre / emitter pos)
  29    shape radius (param0)
  30    mat index
  31    mat_tex (albedo texture id)
  -- spectral extension (filled when the builder runs with spectral=True;
     per-MATERIAL rgb2spec fetches happen on the host at build time so the
     render loop never touches the 64^3 table) --
  32:34 rgb2spec sigmoid coefficients of srgb_to_lrgb(mat_color)
  35:37 rgb2spec coefficients of the emission tint (emission/|emission|)
  38    emission scale |emission|  (PT_Spec.emission_to_rad)
  39    measured-SPD selector: mat_tex for MAT_SPECTRAL, else -1

LIGHT_ATTR (B = 32) — everything needed to sample an emitter:
   0: 2 v1 (tri corner) | shape position
   3: 5 v3 - v1
   6: 8 v2 - v1
   9:11 n1   12:14 n2   15:17 n3
  18:20 emission (mat_color)
  21    area
  22    prim id
  23    prim type
  24    shape type
  25:27 shape normal (param 3:6)
  28    param0 (radius | x1)
  29    param1 (x2)
  30    param2 (scale)
  31    pad
  32:34 rgb2spec coefficients of the emission tint (spectral ext.)
  35    emission scale
"""

import numpy as np

from ti_raytrace_tpu.core import constants as C

PRIM_A = 40
LIGHT_A = 40


def build_prim_attr(host: dict, spectral: bool = False) -> np.ndarray:
    """(PRIM_A, P) float32 from the host scene dict (see scene/build.py)."""
    P = host["prim_type"].shape[0]
    A = np.zeros((PRIM_A, P), np.float32)

    ptype = host["prim_type"]
    vidx = host["prim_vidx"]
    pmat = host["prim_mat"]
    is_tri = ptype == C.PRIM_TRI

    e1 = host["tri_e1"]
    e2 = host["tri_e2"]
    gn = np.cross(e1, e2)
    gn /= np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-20)
    A[0:3, :] = np.where(is_tri[None, :], gn.T, 0.0)

    vtx_n = host["vtx_normal"]
    vtx_uv = host["vtx_uv"]
    tri_ids = np.where(is_tri, vidx, 0)
    for c in range(3):
        A[3 + 3 * c : 6 + 3 * c, :] = np.where(
            is_tri[None, :], vtx_n[tri_ids + c].T, 0.0
        )
    uv_cat = np.concatenate(
        [vtx_uv[tri_ids + 0], vtx_uv[tri_ids + 1], vtx_uv[tri_ids + 2]], axis=-1
    )  # (P, 6)
    A[12:18, :] = np.where(is_tri[None, :], uv_cat.T, 0.0)

    A[18, :] = host["mat_type"][pmat]
    A[19:22, :] = host["mat_color"][pmat].T
    A[22, :] = host["mat_p0"][pmat]
    A[23, :] = host["mat_p1"][pmat]
    A[24, :] = host["prim_area"]
    A[25, :] = (~is_tri).astype(np.float32)

    sidx = np.where(~is_tri, vidx, 0)
    sidx = np.clip(sidx, 0, host["shape_pos"].shape[0] - 1)
    A[26:29, :] = np.where(is_tri[None, :], 0.0, host["shape_pos"][sidx].T)
    A[29, :] = np.where(is_tri, 0.0, host["shape_param"][sidx, 0])
    A[30, :] = pmat
    A[31, :] = host["mat_tex"][pmat]
    if spectral:
        refl_c, em_c, em_s = _material_spectral_rows(host)
        A[32:35, :] = refl_c[pmat].T
        A[35:38, :] = em_c[pmat].T
        A[38, :] = em_s[pmat]
        A[39, :] = np.where(
            host["mat_type"][pmat] == C.MAT_SPECTRAL,
            host["mat_tex"][pmat].astype(np.float32),
            -1.0,
        )
    return A


def _material_spectral_rows(host):
    """Per-material rgb2spec coefficients (host-side fetch;
    reference Hero.srgb_to_spec + PT_Spec.emission_to_rad)."""
    from ti_raytrace_tpu.spectral.rgb2spec import load_table

    table = load_table()
    color = host["mat_color"].astype(np.float64)

    def s2l(c):
        c = np.clip(c, 0.0, None)
        return np.where(c < 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)

    refl_c = table.fetch(s2l(np.clip(color, 0.0, 1.0)))
    scale = np.linalg.norm(color, axis=-1)
    tint = np.where(scale[:, None] > 0.0, color / np.maximum(scale[:, None], 1e-20), 0.0)
    # Emission tint: fetched WITHOUT the sRGB decode, so the effective
    # emission luminance (|emission| * tint) matches the RGB pipeline.
    # The reference decodes (PT_Spec.py:116 -> srgb_to_spec) but its lost
    # table was fitted with inconsistent lambda units and an unnormalized
    # white point (JakobSpecTable.py:268-281 vs Rgb2Spec.py:135-138), and
    # its published render matches the undecoded brightness (PARITY.md).
    em_c = table.fetch(tint)
    return refl_c.astype(np.float32), em_c.astype(np.float32), scale.astype(np.float32)


def build_light_attr(host: dict, spectral: bool = False) -> np.ndarray:
    """(LIGHT_A, L) float32."""
    lp = host["light_prim"]
    L = lp.shape[0]
    B = np.zeros((LIGHT_A, L), np.float32)

    ptype = host["prim_type"][lp]
    vidx = host["prim_vidx"][lp]
    pmat = host["prim_mat"][lp]
    is_tri = ptype == C.PRIM_TRI

    vtx = host["vtx_pos"]
    vtx_n = host["vtx_normal"]
    tri_ids = np.where(is_tri, vidx, 0)
    v1 = vtx[tri_ids + 0]
    v2 = vtx[tri_ids + 1]
    v3 = vtx[tri_ids + 2]

    sidx = np.clip(np.where(~is_tri, vidx, 0), 0, host["shape_pos"].shape[0] - 1)
    spos = host["shape_pos"][sidx]
    sparam = host["shape_param"][sidx]

    B[0:3, :] = np.where(is_tri[None, :], v1.T, spos.T)
    B[3:6, :] = np.where(is_tri[None, :], (v3 - v1).T, 0.0)
    B[6:9, :] = np.where(is_tri[None, :], (v2 - v1).T, 0.0)
    for c, arr in enumerate((vtx_n[tri_ids + 0], vtx_n[tri_ids + 1], vtx_n[tri_ids + 2])):
        B[9 + 3 * c : 12 + 3 * c, :] = np.where(is_tri[None, :], arr.T, 0.0)
    B[18:21, :] = host["mat_color"][pmat].T
    B[21, :] = host["prim_area"][lp]
    B[22, :] = lp
    B[23, :] = ptype
    B[24, :] = np.where(is_tri, 0.0, host["shape_type"][sidx])
    B[25:28, :] = np.where(is_tri[None, :], 0.0, sparam[:, 3:6].T)
    B[28, :] = np.where(is_tri, 0.0, sparam[:, 0])
    B[29, :] = np.where(is_tri, 0.0, sparam[:, 1])
    B[30, :] = np.where(is_tri, 0.0, sparam[:, 2])
    if spectral:
        _, em_c, em_s = _material_spectral_rows(host)
        B[32:35, :] = em_c[pmat].T
        B[35, :] = em_s[pmat]
    return B
