"""Planar emitter sampling via one-hot selection from the light pack.

The wavefront twin of scene/sample.py: instead of gathering light data
per lane, the chosen light's 32-float column is extracted from
scene.light_attr (32, L) with a one-hot matmul — for typical light counts
a small product and zero gather traffic.
"""

import jax
import jax.numpy as jnp

from ti_raytrace_tpu.core import constants as C
from ti_raytrace_tpu.ops import planar as pv
from ti_raytrace_tpu.utils.sampling import map_to_disk


def _pick_light(scene, u_pick):
    """(N,) uniform -> (32, N) light column + (N,) index."""
    L = scene.n_lights
    idx = jnp.minimum((u_pick * L).astype(jnp.int32), L - 1)
    onehot = (
        jnp.arange(L, dtype=jnp.int32)[:, None] == idx[None, :]
    ).astype(jnp.float32)
    # HIGHEST: a reduced-precision (bf16/TF32) product rounds the
    # extracted column — prim ids come back off-by-rounding and light
    # positions shift ~0.4%, which displaced veach's spot-lamp shadow
    # origins into the shade and killed its NEE
    col = jnp.dot(scene.light_attr, onehot, preferred_element_type=jnp.float32,
                  precision=jax.lax.Precision.HIGHEST)
    return col, idx


def _point_on_light(col, a, b):
    """Uniform point + normal from a light column
    (reference Scene.get_prim_random_point_normal:382-420, including its
    swapped normal-weight quirk)."""
    is_tri = col[23] == C.PRIM_TRI
    is_sphere = (~is_tri) & (col[24] == C.SHAPE_SPHERE)

    flip = (a + b) > 1.0
    ta = jnp.where(flip, 1.0 - a, a)
    tb = jnp.where(flip, 1.0 - b, b)
    v1 = col[0:3]
    e31 = col[3:6]
    e21 = col[6:9]
    tri_pos = v1 + e31 * ta[None] + e21 * tb[None]
    tri_n = pv.normalize(
        col[9:12] * (1.0 - ta - tb)[None] + col[12:15] * ta[None] + col[15:18] * tb[None]
    )

    sph_n = pv.uniform_sample_sphere(a, b)
    radius = col[28]
    sph_pos = col[0:3] + sph_n * radius[None]

    fixed_n = col[25:28]
    pos = pv.where(is_tri, tri_pos, pv.where(is_sphere, sph_pos, col[0:3]))
    nrm = pv.where(is_tri, tri_n, pv.where(is_sphere, sph_n, fixed_n))
    return pos, pv.normalize(nrm), is_tri


def sample_li(scene, shade_pos, u3):
    """Receiver-side NEE (reference Scene.sample_li:478-518), planar.

    shade_pos: (3, N); u3: (3, N) uniforms.
    Returns dict(pos, normal, direction, emission, dist, prim, choice_pdf,
    dir_pdf) — direction points from the light toward the receiver.
    """
    col, _ = _pick_light(scene, u3[0])
    pos, nrm, is_tri = _point_on_light(col, u3[1], u3[2])

    emission = col[18:21]
    area = col[21]
    prim = col[22].astype(jnp.int32)
    L = jnp.float32(scene.n_lights)
    choice_pdf = 1.0 / (L * jnp.maximum(area, 1e-12))

    d = shade_pos - pos
    dist = jnp.maximum(pv.length(d), 1e-12)
    direction = d * (1.0 / dist)[None]
    n_dot_l = jnp.abs(pv.dot(direction, nrm))
    dir_pdf_std = n_dot_l / C.PI  # unfloored (corrected BDPT estimator)
    dir_pdf = jnp.maximum(0.01, dir_pdf_std)
    vis = jnp.ones_like(dist)

    stype = col[24]
    is_shape = ~is_tri
    is_spot = is_shape & (stype == C.SHAPE_SPOT)
    x1, x2 = col[28], col[29]
    x = jnp.arccos(jnp.clip(n_dot_l, -1.0, 1.0))
    spot_vis = jnp.where(
        x > x2, 0.0, jnp.where(x > x1, 1.0 - (x - x1) / jnp.maximum(x2 - x1, 1e-12), 1.0)
    )
    vis = jnp.where(is_spot, vis * spot_vis, vis)
    dir_pdf = jnp.where(is_spot, 1.0, dir_pdf)
    dir_pdf_std = jnp.where(is_spot, 1.0, dir_pdf_std)

    is_laser = is_shape & (stype == C.SHAPE_LASER)
    proj = pv.dot(direction, nrm) * dist
    r_off = jnp.sqrt(jnp.maximum(dist * dist - proj * proj, 0.0))
    vis = jnp.where(is_laser & (r_off > col[28]), 0.0, vis)
    dir_pdf = jnp.where(is_laser, 1.0, dir_pdf)
    dir_pdf_std = jnp.where(is_laser, 1.0, dir_pdf_std)
    choice_pdf = jnp.where(is_laser, 1.0 / L, choice_pdf)

    return dict(
        pos=pos,
        normal=nrm,
        direction=direction,
        emission=emission * vis[None],
        dist=dist,
        prim=prim,
        choice_pdf=choice_pdf,
        dir_pdf=dir_pdf,
        dir_pdf_std=dir_pdf_std,
        # spectral rows (zeros unless the scene was built spectral=True)
        em_c0=col[32],
        em_c1=col[33],
        em_c2=col[34],
        em_scale=col[35],
        vis=vis,
    )


def sample_light(scene, u6):
    """Emitter-side sampling for BDPT light subpaths
    (reference Scene.sample_light:431-474), planar.  u6: (6, N)."""
    col, _ = _pick_light(scene, u6[0])
    pos, nrm, is_tri = _point_on_light(col, u6[1], u6[2])

    emission = col[18:21]
    area = col[21]
    prim = col[22].astype(jnp.int32)
    L = jnp.float32(scene.n_lights)
    choice_pdf = 1.0 / (L * jnp.maximum(area, 1e-12))

    local = pv.cosine_sample_hemisphere(u6[3], u6[4])
    # the reference floors the emission-direction pdf at 0.01
    # (Scene.py:447 cos_pdf); the unfloored standard value rides along
    # for the corrected BDPT estimator (bdpt_rgb corrected=True)
    dir_pdf_std = local[2] / C.PI
    dir_pdf = jnp.maximum(0.01, dir_pdf_std)
    direction = pv.to_world(local, nrm)

    stype = col[24]
    is_shape = ~is_tri
    is_spot = is_shape & (stype == C.SHAPE_SPOT)
    x1, x2, scale = col[28], col[29], col[30]
    r_u, phi = map_to_disk(u6[3], u6[4])
    r1 = scale * jnp.tan(x1)
    r2 = scale * jnp.tan(x2)
    r = r_u * r2
    spot_fade = jnp.where(r > r1, 1.0 - (r - r1) / jnp.maximum(r2 - r1, 1e-12), 1.0)
    spot_pt = pv.p3(
        r * jnp.cos(phi),
        r * jnp.sin(phi),
        jnp.sqrt(jnp.maximum(0.0, scale * scale - r * r)),
    )
    spot_dir = pv.to_world(spot_pt, nrm)
    emission = pv.where(is_spot, emission * spot_fade[None], emission)
    direction = pv.where(is_spot, spot_dir, direction)
    dir_pdf = jnp.where(is_spot, 1.0, dir_pdf)
    dir_pdf_std = jnp.where(is_spot, 1.0, dir_pdf_std)

    is_laser = is_shape & (stype == C.SHAPE_LASER)
    radius = col[28]
    phi_l = u6[5] * C.TWO_PI
    disk_pt = pv.p3(
        radius * jnp.cos(phi_l), radius * jnp.sin(phi_l), jnp.zeros_like(phi_l)
    )
    disk_off = pv.to_world(disk_pt, nrm)
    pos = pv.where(is_laser, pos + disk_off, pos)
    direction = pv.where(is_laser, nrm, direction)
    dir_pdf = jnp.where(is_laser, 1.0, dir_pdf)
    dir_pdf_std = jnp.where(is_laser, 1.0, dir_pdf_std)
    choice_pdf = jnp.where(is_laser, 1.0 / L, choice_pdf)

    return dict(
        pos=pos,
        normal=nrm,
        direction=direction,
        emission=emission,
        prim=prim,
        choice_pdf=choice_pdf,
        dir_pdf=dir_pdf,
        dir_pdf_std=dir_pdf_std,
        # spectral rows (zeros unless the scene was built spectral=True)
        em_c0=col[32],
        em_c1=col[33],
        em_c2=col[34],
        em_scale=col[35],
    )
