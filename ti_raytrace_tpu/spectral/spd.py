"""Spectral power distribution tables (host load + hero-sampled device use).

Covers reference spectrum/Spectrum.py (CSV table + lerp sample + scale)
and the hero-wavelength machinery of spectrum/HeroSample.py: 4 correlated
wavelengths lambda_i = lambda0 + i*100nm, lambda0 in [360, 460).

Design: instead of per-lane table gathers, every SPD an integrator
needs is pre-evaluated on the host into a *hero matrix* H of shape
(4, NB): column b holds the SPD at the 4 hero wavelengths of
lambda0-bin b.  At render time a lane's 4-vector is one one-hot matmul
(4, NB) @ (NB, N) — no gathers.  lambda0 is quantized to NB bins
(default 512 over the 100nm hero window, ~0.2nm — far below any visible
difference; the reference interpolates continuously, PARITY.md).
"""

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ti_raytrace_tpu.core import constants as C

N_HERO = C.N_HERO                      # 4 (reference HeroSample.py:5)
LAMBDA_MIN = C.LAMBDA_MIN              # 360
LAMBDA_MAX = C.LAMBDA_MAX              # 760
LAMBDA_STEP = (LAMBDA_MAX - LAMBDA_MIN) / N_HERO  # 100nm
HERO_BINS = 512


@dataclass
class Spd:
    """Host-side SPD: regular wavelength grid + linear interpolation."""
    lambdas: np.ndarray  # (S,)
    values: np.ndarray   # (S,)

    @property
    def lambda_min(self):
        return float(self.lambdas[0])

    @property
    def lambda_max(self):
        return float(self.lambdas[-1])

    @property
    def step(self):
        return (self.lambda_max - self.lambda_min) / (len(self.values) - 1)

    def sample(self, lam):
        """Reference-parity sample (Spectrum.py:43-51): note the reference
        weights by fract(offset) — the *nanometre* fraction — not
        fract(offset/step); for 1nm tables they coincide.  We use the
        correct sub-bin weight (PARITY.md)."""
        lam = np.asarray(lam, np.float64)
        inside = (lam >= self.lambda_min) & (lam <= self.lambda_max)
        off = (lam - self.lambda_min) / self.step
        idx = np.clip(off.astype(np.int64), 0, len(self.values) - 2)
        w = off - idx
        v = self.values[idx] * (1 - w) + self.values[idx + 1] * w
        return np.where(inside, v, 0.0)

    def scale(self, coeff: float):
        self.values = self.values * coeff


def load_spd_csv(path: str) -> Spd:
    """Two-column CSV: wavelength, value (reference Spectrum.load_table)."""
    lams, vals = [], []
    with open(path) as f:
        for line in f:
            parts = line.strip().split(",")
            if len(parts) < 2 or not parts[0]:
                continue
            lams.append(float(parts[0]))
            vals.append(float(parts[1]))
    return Spd(np.asarray(lams, np.float64), np.asarray(vals, np.float64))


def hero_lambdas(lambda0):
    """The 4 correlated wavelengths for a hero lambda0 (HeroSample.py:11-16)."""
    lambda0 = np.asarray(lambda0, np.float64)
    return lambda0[..., None] + np.arange(N_HERO) * LAMBDA_STEP


def hero_bin_centers():
    """lambda0 value of each hero bin."""
    u = (np.arange(HERO_BINS) + 0.5) / HERO_BINS
    return LAMBDA_MIN + u * LAMBDA_STEP


def hero_matrix(fn) -> np.ndarray:
    """(4, HERO_BINS) matrix of fn(lambda) evaluated at the hero
    wavelengths of every lambda0 bin.  fn maps (K,) lambdas -> (K,)."""
    lam = hero_lambdas(hero_bin_centers())  # (NB, 4)
    return np.asarray(fn(lam.reshape(-1)), np.float64).reshape(HERO_BINS, N_HERO).T


def hero_onehot(u):
    """(NB, N) float one-hot of the lambda0 bin for uniform u in [0,1)."""
    b = jnp.minimum((u * HERO_BINS).astype(jnp.int32), HERO_BINS - 1)
    return (
        jnp.arange(HERO_BINS, dtype=jnp.int32)[:, None] == b[None, :]
    ).astype(jnp.float32)


def hero_select(matrix, onehot):
    """(R, NB) @ (NB, N) -> (R, N) per-lane hero values (one-hot matmul)."""
    # HIGHEST: exact table values through the one-hot (bf16 would round)
    return jnp.dot(
        jnp.asarray(matrix, jnp.float32), onehot,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
