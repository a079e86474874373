"""Spectral stack tests: SPD tables, CIE integration, rgb2spec round trip,
hero machinery, Hosek-Wilkie sky values (SURVEY.md §7.2 step 7)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ti_raytrace_tpu.core import constants as C
from ti_raytrace_tpu.io.assets import asset_path
from ti_raytrace_tpu.spectral import spd as spd_mod
from ti_raytrace_tpu.spectral.cie import (
    load_cie_sensor,
    normalized_d65,
    white_point,
)
from ti_raytrace_tpu.spectral.rgb2spec import eval_np, load_table
from ti_raytrace_tpu.sky.hosek import build_sky, sky_radiance_hero, sky_radiance_np


def test_cie_sensor_loads():
    s = load_cie_sensor()
    assert s.lambda_min == 360.0 and s.lambda_max == 830.0
    assert s.xyz.shape == (471, 3)
    # y-bar peaks at 555nm
    peak = s.lambdas[np.argmax(s.xyz[:, 1])]
    assert 550 <= peak <= 560


def test_d65_normalization():
    s = load_cie_sensor()
    d65 = normalized_d65(s)
    wp = white_point(s, d65)
    np.testing.assert_allclose(wp[1], 1.0, rtol=1e-6)
    # D65 white point chromaticity ~ (0.3127, 0.3290)
    x = wp[0] / wp.sum()
    y = wp[1] / wp.sum()
    assert abs(x - 0.3127) < 0.01 and abs(y - 0.3290) < 0.01


def test_spd_sample_interp():
    sp = spd_mod.Spd(np.array([400.0, 500.0, 600.0]), np.array([1.0, 3.0, 2.0]))
    np.testing.assert_allclose(sp.sample(450.0), 2.0)
    np.testing.assert_allclose(sp.sample(399.0), 0.0)  # outside -> 0
    np.testing.assert_allclose(sp.sample(601.0), 0.0)


def test_hero_matrix_and_select():
    sp = spd_mod.Spd(
        np.linspace(360, 760, 401), np.linspace(0.0, 1.0, 401)
    )
    H = spd_mod.hero_matrix(sp.sample)
    assert H.shape == (4, spd_mod.HERO_BINS)
    u = jnp.asarray([0.0, 0.5, 0.999])
    oh = spd_mod.hero_onehot(u)
    vals = np.asarray(spd_mod.hero_select(H, oh))  # (4, 3)
    # hero wavelengths of u=0.5: 410, 510, 610, 710 -> spd = (lam-360)/400
    np.testing.assert_allclose(vals[:, 1], (np.array([410, 510, 610, 710]) - 360) / 400,
                               atol=5e-3)


@pytest.mark.slow
def test_rgb2spec_roundtrip():
    from ti_raytrace_tpu.spectral.jakob_fit import _Integrator

    table = load_table()  # cached (generated by jakob_fit if absent)
    integ = _Integrator()
    rng = np.random.default_rng(0)
    rgb = rng.uniform(0.05, 0.95, (100, 3))
    coeffs = table.fetch(rgb)
    S = eval_np(coeffs[:, None, :], integ.lam[None, :])
    back = (S @ integ.R.T) @ integ.M.T
    err = np.abs(back - rgb)
    assert err.mean() < 2e-3 and err.max() < 0.05
    # spectra are physical reflectances
    assert S.min() >= 0.0 and S.max() <= 1.0


def test_sky_band_values_reasonable():
    sky = build_sky(3.0, 0.5, 0.17)
    assert sky.configs.shape == (11, 9)
    assert np.all(np.isfinite(sky.configs))
    assert np.all(sky.radiances > 0)
    # sky radiance looking near the sun should exceed radiance away from it
    near = sky_radiance_np(sky, theta=np.pi / 2 - 0.17, gamma=0.05, lam=550.0)
    far = sky_radiance_np(sky, theta=np.pi / 2 - 0.17, gamma=2.5, lam=550.0)
    assert near > far > 0


def test_sky_device_matches_numpy_oracle():
    sky = build_sky(3.0, 0.5, 0.17)
    rng = np.random.default_rng(1)
    N = 64
    theta = rng.uniform(0.0, np.pi / 2 - 0.01, N)
    gamma = rng.uniform(0.0, np.pi, N)
    lam0 = rng.uniform(360.0, 460.0, N)
    lam4 = lam0[None, :] + np.arange(4)[:, None] * 100.0

    got = np.asarray(
        sky_radiance_hero(
            jnp.asarray(sky.configs, jnp.float32),
            jnp.asarray(sky.radiances, jnp.float32),
            jnp.asarray(theta, jnp.float32),
            jnp.asarray(gamma, jnp.float32),
            jnp.asarray(lam4, jnp.float32),
        )
    )
    want = np.stack([sky_radiance_np(sky, theta, gamma, lam4[i]) for i in range(4)])
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-4)


def test_simpson_weights_integrate_constant():
    from ti_raytrace_tpu.spectral.cie import simpson38_weights

    # weights should integrate f == 1 over the range to ~ (b - a)
    n = 471
    w = simpson38_weights(n, 360.0, 830.0)
    np.testing.assert_allclose(w.sum(), 470.0, rtol=0.01)


def test_spec_pack_pixel_row_is_value_encoded():
    """Regression (r5): pixel ids stored as f32 VALUES, never bitcast bits.

    ids < 2^23 bitcast int32->f32 are denormals, and an accelerator
    fusion that flushes denormals to zero scatters every compacted lane's
    radiance to pixel 0 (seen on sky_dome at 512^2 on the previous
    accelerator; exact in eager and on CPU, so only this encoding check
    can run in the CPU suite)."""
    from ti_raytrace_tpu.integrators import pt_spec

    N = 256
    key = jax.random.PRNGKey(0)
    sdata = pt_spec.make_spectral_data()
    o = jnp.zeros((3, N), jnp.float32)
    d = jnp.concatenate(
        [jnp.zeros((2, N), jnp.float32), jnp.ones((1, N), jnp.float32)]
    )
    carry = pt_spec._new_carry_spec(sdata, o, d, key)
    carry["pixel"] = carry["pixel"] + 1000  # distinct, still < 2^23
    m = pt_spec._pack_spec(carry)
    np.testing.assert_array_equal(
        np.asarray(m[40]), np.arange(N, dtype=np.float32) + 1000.0
    )
    rt = pt_spec._unpack_spec(m)
    np.testing.assert_array_equal(np.asarray(rt["pixel"]), np.asarray(carry["pixel"]))
