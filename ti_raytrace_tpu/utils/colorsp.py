"""Color-space transforms and tone mapping.

Re-implements the reference's color substrate (UtilsFunc.py:45-120 and the
tone_map kernel at UtilsFunc.py:583-586) as pure vectorized functions.
"""

import jax
import jax.numpy as jnp
import numpy as np

from ti_raytrace_tpu.core import constants as C


def srgb_to_lrgb(srgb):
    """Gamma-decode sRGB -> linear RGB (reference UtilsFunc.py:77-84)."""
    return jnp.where(
        srgb < 0.04045,
        srgb / 12.92,
        jnp.power(jnp.maximum(srgb + 0.055, 0.0) / 1.055, 2.4),
    )


def lrgb_to_srgb(lrgb):
    """Gamma-encode linear RGB -> sRGB, clamped (UtilsFunc.py:86-94)."""
    out = jnp.where(
        lrgb < 0.0031308,
        lrgb * 12.92,
        1.055 * jnp.power(jnp.maximum(lrgb, 1e-12), 1.0 / 2.4) - 0.055,
    )
    return jnp.clip(out, 0.0, 1.0)


def xyz_to_srgb(xyz):
    """CIE XYZ -> linear sRGB via the reference's matrix (UtilsFunc.py:42)."""
    m = jnp.asarray(C.XYZ_TO_SRGB)
    return jnp.matmul(xyz, m.T, precision=jax.lax.Precision.HIGHEST)


def srgb_to_xyz(rgb):
    m = jnp.asarray(C.SRGB_TO_XYZ)
    return jnp.matmul(rgb, m.T, precision=jax.lax.Precision.HIGHEST)


def xyz_to_Yxy(xyz):
    """(UtilsFunc.py:96-103); returns zeros when X+Y+Z == 0."""
    s = jnp.sum(xyz, axis=-1, keepdims=True)
    safe = jnp.where(s > 0.0, 1.0 / jnp.where(s > 0.0, s, 1.0), 0.0)
    Y = xyz[..., 1:2]
    x = xyz[..., 0:1] * safe
    y = xyz[..., 1:2] * safe
    out = jnp.concatenate([Y, x, y], axis=-1)
    return jnp.where(s > 0.0, out, jnp.zeros_like(out))


def Yxy_to_xyz(yxy):
    """(UtilsFunc.py:104-110)."""
    Y, x, y = yxy[..., 0:1], yxy[..., 1:2], yxy[..., 2:3]
    valid = y > 0.0
    k = Y / jnp.where(valid, y, 1.0)
    out = jnp.concatenate([k * x, Y, k * (1.0 - x - y)], axis=-1)
    return jnp.where(valid, out, jnp.zeros_like(out))


def tone_aces(x):
    """Narkowicz ACES filmic curve (UtilsFunc.py:113-120)."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return jnp.clip((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def tone_map(hdr, exposure=0.5):
    """exposure -> ACES -> sRGB encode; the reference's only standalone
    kernel (UtilsFunc.py:583-586), applied to the whole film at once."""
    return lrgb_to_srgb(tone_aces(hdr * exposure))


def planck(lambda_nm, temperature):
    """Planck's law spectral radiance, per-nm (UtilsFunc.py:63-73).
    Host-side helper (numpy) like the reference."""
    lam = np.asarray(lambda_nm, dtype=np.float64) * 1.0e-9
    c1 = 2.0 * C.PLANCK_H * C.LIGHT_C * C.LIGHT_C
    c2 = C.PLANCK_H * C.LIGHT_C / C.BOLTZMANN_K
    denom = np.power(lam, 5.0) * (np.exp(c2 / (lam * temperature)) - 1.0)
    return c1 / denom * 1.0e-9


def calc_matr_rgb_to_xyz(xy_r, xy_g, xy_b, xyz_white):
    """Build an RGB->XYZ matrix from primaries + white point
    (Lindbloom method; reference UtilsFunc.py:48-58).  Host-side numpy."""
    xy = np.array([xy_r, xy_g, xy_b], dtype=np.float64)
    x_rgb, y_rgb = xy[:, 0], xy[:, 1]
    X = x_rgb / y_rgb
    Y = np.ones(3)
    Z = (1.0 - x_rgb - y_rgb) / y_rgb
    M = np.stack([X, Y, Z])
    S = np.linalg.inv(M) @ np.asarray(xyz_white, dtype=np.float64)
    return (M * S[None, :]).astype(np.float32)
