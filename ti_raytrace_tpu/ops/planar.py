"""Planar (structure-of-arrays) wavefront math.

Layout rule: the wavefront lives on the minor-most axis.  Stored (3, N),
every component row is a contiguous (N,) vector (coalesced loads, no
stride-3 access).  This
module is the planar twin of utils/vec.py and is what the hot render loop
uses; 3-vectors are jnp arrays of shape (3, ...) with components on axis 0.
"""

import jax
import jax.numpy as jnp


def p3(x, y, z):
    return jnp.stack([x, y, z], axis=0)


def splat(v, n):
    """Constant 3-vector -> (3, n) planar."""
    return jnp.broadcast_to(jnp.asarray(v, jnp.float32)[:, None], (3, n))


def dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross(a, b):
    return jnp.stack(
        [
            a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0],
        ],
        axis=0,
    )


def length(a):
    return jnp.sqrt(jnp.maximum(dot(a, a), 0.0))


def normalize(a, eps=1e-20):
    inv = jax.lax.rsqrt(jnp.maximum(dot(a, a), eps))
    return a * inv[None]


def reflect(i, n):
    return i - (2.0 * dot(i, n))[None] * n


def where(mask, a, b):
    """Select planar vectors by a (...,) lane mask."""
    return jnp.where(mask[None], a, b)


def scale(a, s):
    return a * s[None]


def from_rows(origin_nx3):
    """(N, 3) -> (3, N)."""
    return jnp.swapaxes(origin_nx3, 0, 1)


def to_rows(a):
    """(3, N) -> (N, 3)."""
    return jnp.swapaxes(a, 0, 1)


def sign_nonzero(x):
    return jnp.where(x >= 0.0, 1.0, -1.0)


# ---------------------------------------------------------------- sampling

def cosine_sample_hemisphere(u1, u2):
    """Planar cosine hemisphere (z-up local); see utils/sampling.py."""
    from ti_raytrace_tpu.core.constants import TWO_PI

    r = jnp.sqrt(u1)
    phi = TWO_PI * u2
    x = r * jnp.cos(phi)
    y = r * jnp.sin(phi)
    z = jnp.sqrt(jnp.maximum(0.0, 1.0 - x * x - y * y))
    return normalize(p3(x, y, z))


def uniform_sample_sphere(u1, u2):
    from ti_raytrace_tpu.core.constants import TWO_PI

    z = 1.0 - 2.0 * u1
    r = jnp.sqrt(jnp.clip(1.0 - z * z, 0.0, 1.0))
    phi = TWO_PI * u2
    return p3(r * jnp.cos(phi), r * jnp.sin(phi), z)


def onb(n):
    """Tangent frame of the reference (UtilsFunc.py:374-387), planar."""
    n = normalize(n)
    use_x = jnp.abs(n[0]) > jnp.abs(n[2])
    zeros = jnp.zeros_like(n[0])
    b = where(use_x, p3(-n[1], n[0], zeros), p3(zeros, -n[2], n[1]))
    b = normalize(b)
    t = normalize(cross(b, n))
    return t, b


def to_world(local3, n):
    n_unit = normalize(n)
    t, b = onb(n)
    return t * local3[0][None] + b * local3[1][None] + n_unit * local3[2][None]


def faceforward(n, i, nref):
    s = sign_nonzero(dot(i, nref))
    return n * s[None]


def offset_ray(p, n):
    """Integer-ulp self-intersection offset, planar
    (see utils/geometry.offset_ray)."""
    int_scale = 256.0
    float_scale = 1.0 / 2048.0
    origin = 1.0 / 256.0
    i_of = (int_scale * n).astype(jnp.int32)
    i_p = jax.lax.bitcast_convert_type(p, jnp.int32)
    i_p = jnp.where(p < 0.0, i_p - i_of, i_p + i_of)
    f_p = jax.lax.bitcast_convert_type(i_p, jnp.float32)
    return jnp.where(jnp.abs(p) < origin, p + float_scale * n, f_p)


def refract(in_dir, n, eta):
    """Planar Snell refraction; eta is (...,)."""
    n_dot_i = dot(n, in_dir)
    k = 1.0 - eta * eta * (1.0 - n_dot_i * n_dot_i)
    ok = k > 0.0
    r = in_dir * eta[None] - n * (eta * n_dot_i + jnp.sqrt(jnp.maximum(k, 0.0)))[None]
    return where(ok, r, jnp.zeros_like(r)), ok
