"""RGB -> reflectance-spectrum upsampling (Jakob & Hanika 2019 model).

The model represents a reflectance spectrum as a smooth sigmoid of a
quadratic in wavelength; a 3x64^3 coefficient table maps linear RGB to
(c0, c1, c2).  Covers reference spectrum/Rgb2Spec.py: max-component
reordering, non-uniform z lattice with binary-search interval lookup,
trilinear interpolation, sigmoid eval (Rgb2Spec.py:48-138).

Host/device split:
  * `fetch` runs on the HOST (vectorized numpy): materials are few, so
    the scene builder bakes per-material coefficients into the packed
    attribute tables (scene/packs.py) — the render loop never touches
    the 64^3 table;
  * `eval_hero` is the device-side sigmoid evaluation on planar lanes.

The reference's `spectrum/spec_table` blob is missing upstream, so the
table is regenerated by spectral/jakob_fit.py and cached under assets/.
"""

import os
from dataclasses import dataclass

import jax
import numpy as np

N_COEFFS = 3
RES = 64


def smoothstep(x):
    return x * x * (3.0 - 2.0 * x)


def scale_lattice(res: int = RES) -> np.ndarray:
    """Non-uniform z grid: smoothstep(smoothstep(i/(res-1))) — matches the
    reference's table_scale so fetch logic is interchangeable."""
    return smoothstep(smoothstep(np.arange(res, dtype=np.float64) / (res - 1)))


@dataclass
class Rgb2SpecTable:
    res: int
    scale: np.ndarray  # (res,)
    data: np.ndarray   # (3, res, res, res, 3): [maxcomp, z, y, x, coeff]

    def fetch(self, rgb: np.ndarray) -> np.ndarray:
        """Linear RGB (..., 3) in [0,1] -> sigmoid coefficients (..., 3)
        in *nanometre* lambda units (reference fetch, Rgb2Spec.py:97-132).
        """
        rgb = np.clip(np.asarray(rgb, np.float64), 0.0, 1.0)
        flat = rgb.reshape(-1, 3)
        k = np.argmax(flat, axis=-1)
        # the reference's tie-breaking (argmax of strict > chains) differs
        # on exact ties only; measure-zero
        z = np.maximum(flat[np.arange(len(flat)), k], 1e-5)
        a = flat[np.arange(len(flat)), (k + 1) % 3]
        b = flat[np.arange(len(flat)), (k + 2) % 3]
        s = (self.res - 1) / z
        x = a * s
        y = b * s

        xi = np.minimum(x.astype(np.int64), self.res - 2)
        yi = np.minimum(y.astype(np.int64), self.res - 2)
        zi = np.clip(
            np.searchsorted(self.scale, z, side="right") - 1, 0, self.res - 2
        )

        x0 = x - xi
        y0 = y - yi
        z0 = (z - self.scale[zi]) / (self.scale[zi + 1] - self.scale[zi])

        def corner(dz, dy, dx):
            return self.data[k, zi + dz, yi + dy, xi + dx]  # (n, 3)

        w = lambda c0, c1, t: c0 * (1 - t)[:, None] + c1 * t[:, None]  # noqa: E731
        out = w(
            w(w(corner(0, 0, 0), corner(0, 0, 1), x0),
              w(corner(0, 1, 0), corner(0, 1, 1), x0), y0),
            w(w(corner(1, 0, 0), corner(1, 0, 1), x0),
              w(corner(1, 1, 0), corner(1, 1, 1), x0), y0),
            z0,
        )
        return out.reshape(rgb.shape)


def eval_np(coeffs, lam):
    """sigmoid(c0 lam^2 + c1 lam + c2), lam in nm (Rgb2Spec.eval)."""
    c = np.asarray(coeffs, np.float64)
    x = (c[..., 0] * lam + c[..., 1]) * lam + c[..., 2]
    return 0.5 * x / np.sqrt(x * x + 1.0) + 0.5


def eval_hero(c0, c1, c2, lam):
    """Device eval on planar lanes: coefficient rows (N,), lam (K, N) or
    (N,) -> spectrum values of the same shape."""
    x = (c0 * lam + c1) * lam + c2
    return 0.5 * x * jax.lax.rsqrt(x * x + 1.0) + 0.5



_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "assets",
    "spec_table.npz",
)
_LOADED: Rgb2SpecTable | None = None


def load_table(path: str | None = None, generate: bool = True) -> Rgb2SpecTable:
    """Load the cached coefficient table; generate + cache it if absent."""
    global _LOADED
    if _LOADED is not None and path is None:
        return _LOADED
    p = path or _CACHE
    if os.path.exists(p):
        z = np.load(p)
        t = Rgb2SpecTable(int(z["res"]), z["scale"], z["data"])
    elif generate:
        from ti_raytrace_tpu.spectral.jakob_fit import fit_table

        t = fit_table(RES)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        np.savez_compressed(p, res=t.res, scale=t.scale, data=t.data)
    else:
        raise FileNotFoundError(p)
    if path is None:
        _LOADED = t
    return t


def load_reference_format(path: str) -> Rgb2SpecTable:
    """Read the reference's text format (spectrum/spec_table layout,
    Rgb2Spec.load_table:15-37): res, res scale lines, then res^3*3 lines
    of 9 floats (3 coefficient triples per line)."""
    with open(path) as f:
        res = int(f.readline())
        scale = np.array([float(f.readline()) for _ in range(res)])
        vals = np.loadtxt(f).reshape(-1)[: res * res * res * 9]
    data = vals.reshape(3, res, res, res, 3)
    return Rgb2SpecTable(res, scale, data)
