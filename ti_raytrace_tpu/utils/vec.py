"""Small vector algebra over the last axis.

Every routine broadcasts over arbitrary leading (batch) axes; 3-vectors
live in the trailing axis.  This is the whole-wavefront replacement for the
reference's per-lane `ti.Vector` math (UtilsFunc.py): the batch axes
vectorize, one lane per ray.
"""

import jax.numpy as jnp


def dot(a, b):
    return jnp.sum(a * b, axis=-1)


def dot3(a, b):
    """dot with a kept trailing axis of size 1 (for broadcasting back)."""
    return jnp.sum(a * b, axis=-1, keepdims=True)


def cross(a, b):
    return jnp.cross(a, b)


def length(a):
    return jnp.sqrt(jnp.maximum(dot(a, a), 0.0))


def normalize(a, eps=1e-20):
    return a / jnp.sqrt(jnp.maximum(dot3(a, a), eps))


def reflect(i, n):
    """GLSL-convention reflect: `i` points toward the surface."""
    return i - 2.0 * dot3(i, n) * n


def max_component(v):
    return jnp.max(v, axis=-1)


def min_component(v):
    return jnp.min(v, axis=-1)


def sign_nonzero(x):
    """sign() that maps 0 to +1 (a true 0 would kill the ray offset the
    reference applies at PT_RGB.py:115)."""
    return jnp.where(x >= 0.0, 1.0, -1.0)
