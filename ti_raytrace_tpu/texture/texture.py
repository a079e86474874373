"""Image texture sampling on device (reference texture/Texture.py).

The texture lives as a (H, W, 3) float array in scene memory, row 0 at the
*bottom* (the reference V-flips on load, Texture.py:34).  Nearest and
bilinear fetches are whole-wavefront gathers.
"""

import jax.numpy as jnp

from ti_raytrace_tpu.io.image import read_image


def load_texture(path: str):
    """Host load -> (H, W, 3) float32, row 0 at bottom."""
    img = read_image(path)  # row 0 = top
    return img[::-1].copy()


def sample_nearest(tex, x, y):
    """Integer-texel fetch with clamp (Texture.py:41-49).
    tex: (H, W, 3) row-0-bottom; x, y in texel units."""
    h, w = tex.shape[0], tex.shape[1]
    xi = jnp.clip(x.astype(jnp.int32), 0, w - 1)
    yi = jnp.clip(y.astype(jnp.int32), 0, h - 1)
    return tex[yi, xi]


def texture2d(tex, u, v):
    """Bilinear fetch, uv in [0,1] (Texture.py:51-69).

    Matches the reference's footprint: sample points at floor(u*w) and
    floor(u*w)+1 with fractional weights, coordinates clamped to the edge.
    """
    h, w = tex.shape[0], tex.shape[1]
    x = jnp.clip(u * w, 0.0, w - 1.0)
    y = jnp.clip(v * h, 0.0, h - 1.0)
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    wx = x - x0
    wy = y - y0
    c00 = sample_nearest(tex, x0, y0)
    c10 = sample_nearest(tex, x0 + 1.0, y0)
    c01 = sample_nearest(tex, x0, y0 + 1.0)
    c11 = sample_nearest(tex, x0 + 1.0, y0 + 1.0)
    wx = wx[..., None]
    wy = wy[..., None]
    return (c00 * (1 - wx) + c10 * wx) * (1 - wy) + (c01 * (1 - wx) + c11 * wx) * wy


def pack_blocks(tex):
    """Host: (H, W, 3) -> (H, W, 12) 2x2-block texture for texture2d_packed.
    blocks[y, x] = [tex[y,x], tex[y,x+1], tex[y+1,x], tex[y+1,x+1]]
    (edge-clamped), so one gather fetches a full bilinear footprint."""
    import numpy as np

    t = np.asarray(tex)
    xp = np.concatenate([t[:, 1:], t[:, -1:]], axis=1)   # x+1 clamped
    yp = np.concatenate([t[1:], t[-1:]], axis=0)         # y+1 clamped
    xyp = np.concatenate([yp[:, 1:], yp[:, -1:]], axis=1)
    return np.concatenate([t, xp, yp, xyp], axis=2).astype(np.float32)


def texture2d_packed(blocks, u, v):
    """Bilinear fetch from a pack_blocks texture: ONE gather instead of
    four (one wide record per lane instead of four narrow ones).
    Footprint and weights identical to texture2d."""
    h, w = blocks.shape[0], blocks.shape[1]
    x = jnp.clip(u * w, 0.0, w - 1.0)
    y = jnp.clip(v * h, 0.0, h - 1.0)
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    xi = jnp.clip(x0.astype(jnp.int32), 0, w - 1)
    yi = jnp.clip(y0.astype(jnp.int32), 0, h - 1)
    c = blocks[yi, xi]  # (..., 12)
    c00, c10, c01, c11 = c[..., 0:3], c[..., 3:6], c[..., 6:9], c[..., 9:12]
    return (c00 * (1 - wx) + c10 * wx) * (1 - wy) + (c01 * (1 - wx) + c11 * wx) * wy
