"""Spectral bidirectional path tracer — single stochastic wavelength.

Re-architecture of reference integrator/BDPT_SPEC.py: the full BDPT
machinery of bdpt_rgb.py runs with a scalar per-pixel `power` throughput
at one wavelength per frame (lambda uniform over the sensor range,
BDPT_SPEC.py:668), dispersive BK7 glass (Glass.sample_lambda), light and
reflectance power via rgb2spec + D65 (get_reflect_power:136 /
get_light_power:148), and a CIE-sensor splat to sRGB
(AddSplat:178-182, rgb clamped to [0,1000] and scaled by the 470nm
sensor span — the MC normalization for pdf(lambda) = 1/span).

This drives the prism dispersion demo — the scene the reference could
only run on its CPU backend (example/prism_rainbow.py:15); here it runs
on the accelerator like everything else.
"""

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ti_raytrace_tpu.camera import CameraSpec
from ti_raytrace_tpu.core import constants as C
from ti_raytrace_tpu.integrators import bdpt_rgb


class SpecCtx(NamedTuple):
    """Per-frame single-wavelength spectral context for the BDPT walks."""
    lam: jnp.ndarray         # (N,) wavelength per lane
    d65_val: jnp.ndarray     # (N,) normalized D65 at lam
    sensor_rgb: jnp.ndarray  # (3, N) clamp(M @ cie(lam), 0, 1000) * span

    def reflect_power(self, attr):
        """Reflectance at lam from the packed rgb2spec coefficient rows
        (scene/packs.py 32:35); (1, N)."""
        x = (attr[32] * self.lam + attr[33]) * self.lam + attr[34]
        s = 0.5 * x * jax.lax.rsqrt(x * x + 1.0) + 0.5
        return s[None]

    def light_power_attr(self, attr):
        """Emission power at lam from the packed emission-tint rows
        (get_light_power: d65 * tint_spectrum * |emission|); (1, N)."""
        x = (attr[35] * self.lam + attr[36]) * self.lam + attr[37]
        s = 0.5 * x * jax.lax.rsqrt(x * x + 1.0) + 0.5
        return (self.d65_val * s * attr[38])[None]

    def light_power_sample(self, ls):
        """Same, from a light-sample dict (scene/sample_planar rows)."""
        x = (ls["em_c0"] * self.lam + ls["em_c1"]) * self.lam + ls["em_c2"]
        s = 0.5 * x * jax.lax.rsqrt(x * x + 1.0) + 0.5
        vis = ls.get("vis")
        p = self.d65_val * s * ls["em_scale"]
        if vis is not None:
            p = p * vis
        return p[None]

    def to_rgb(self, power):
        """Scalar spectral radiance (1, N) -> linear sRGB (3, N) via the
        per-lane CIE sensor response (AddSplat)."""
        return self.sensor_rgb * power


def _sensor_tables():
    """Host: (3, NB) CIE response over the sensor range + metadata."""
    from ti_raytrace_tpu.spectral.cie import load_cie_sensor

    sensor = load_cie_sensor()
    return sensor


def make_spec_ctx_fn(emitter_scale: float = 1.0):
    """Host-closes the sensor/D65 tables; returns f(key, N) -> SpecCtx
    drawing one wavelength per lane (BDPT_SPEC.py:668).

    emitter_scale: per-scene golden-parity factor on every emission term
    (folded into the D65 table, which feeds ONLY light_power_attr /
    light_power_sample).  The committed spectral goldens embody a
    ||Ke||_1 lamp normalization where the reference code's emission path
    caps at ||Ke||_2 (proved by tools/spectral_direct_oracle.py, PARITY.md
    'spectral emitter scale') — sqrt(3) for gray emitters.  The
    physically-consistent estimator is emitter_scale = 1."""
    sensor = _sensor_tables()
    lam_min = sensor.lambda_min
    span = sensor.lambda_max - sensor.lambda_min
    NB = len(sensor.lambdas)
    cie = jnp.asarray(sensor.xyz.T, jnp.float32)           # (3, NB)
    m = jnp.asarray(C.XYZ_TO_SRGB)

    from ti_raytrace_tpu.spectral.cie import normalized_d65

    d65 = normalized_d65(sensor)
    d65_tab = jnp.asarray(d65.sample(sensor.lambdas), jnp.float32) \
        * jnp.float32(emitter_scale)  # (NB,)

    def spec_ctx(key, N):
        u = jax.random.uniform(key, (N,), dtype=jnp.float32)
        # lambda ~ uniform over the sensor range (BDPT_SPEC.py:668)
        lam = lam_min + u * span
        bins = jnp.minimum((u * NB).astype(jnp.int32), NB - 1)
        onehot = (
            jnp.arange(NB, dtype=jnp.int32)[:, None] == bins[None, :]
        ).astype(jnp.float32)
        hi = jax.lax.Precision.HIGHEST  # bf16 default would round tables
        xyz = jnp.dot(cie, onehot, preferred_element_type=jnp.float32,
                      precision=hi)  # (3,N)
        rgb = jnp.clip(jnp.einsum("rc,cn->rn", m, xyz, precision=hi),
                       0.0, 1000.0) * span
        d65_val = jnp.dot(d65_tab[None, :], onehot, precision=hi)[0]
        return SpecCtx(lam=lam, d65_val=d65_val, sensor_rgb=rgb)

    return spec_ctx


def make_render_frame(emitter_scale: float = 1.0, walk_compaction=None,
                      shadow_cap=None):
    spec_ctx = make_spec_ctx_fn(emitter_scale)

    @partial(jax.jit, static_argnames=("spec",))
    def render_frame(scene, spec: CameraSpec, cam, frame, key):
        N = spec.width * spec.height
        k_lam, k_path = jax.random.split(key)
        ctx = spec_ctx(k_lam, N)
        return bdpt_rgb.render_paths(scene, spec, cam, frame, k_path, ctx,
                                     walk_compaction=walk_compaction,
                                     shadow_cap=shadow_cap)

    return render_frame
