"""Native (C++) host runtime vs pure-Python oracle equivalence.

The library is built from native/tiray_native.cpp at first use; where
no C++ toolchain exists the tests skip (decided inside each test, so
every test worker collects the same tests)."""

import numpy as np
import pytest

from ti_raytrace_tpu.io.assets import asset_path
from ti_raytrace_tpu.io.native import get_lib, load_obj_native, morton3d_native
from ti_raytrace_tpu.io.obj import _load_obj_py


def _require_lib():
    if get_lib() is None:
        pytest.skip("native toolchain unavailable")


@pytest.mark.parametrize("model", ["cornell_box.obj", "Teapot.obj", "bdpt.obj"])
def test_native_obj_matches_python(model):
    _require_lib()
    path = asset_path(f"model/{model}")
    a = load_obj_native(path)
    b = _load_obj_py(path)
    assert [m.name for m in a.materials] == [m.name for m in b.materials]
    for ma, mb in zip(a.materials, b.materials):
        np.testing.assert_allclose(ma.diffuse, mb.diffuse, rtol=1e-6)
        np.testing.assert_allclose(ma.emissive, mb.emissive, rtol=1e-6)
        assert ma.shininess == pytest.approx(mb.shininess)
        assert ma.optical_density == pytest.approx(mb.optical_density)
        assert ma.transparency == pytest.approx(mb.transparency)
    for pa, pb in zip(a.tri_pos, b.tri_pos):
        np.testing.assert_array_equal(pa, pb)
    for na, nb in zip(a.tri_normal, b.tri_normal):
        np.testing.assert_array_equal(na, nb)
    for ua, ub in zip(a.tri_uv, b.tri_uv):
        np.testing.assert_array_equal(ua, ub)


def test_native_morton_matches_numpy():
    _require_lib()
    from ti_raytrace_tpu.accel.clusters import _morton3d_np

    rng = np.random.default_rng(0)
    c = rng.uniform(-3, 7, (5000, 3)).astype(np.float32)
    lo = c.min(0)
    hi = c.max(0)
    got = morton3d_native(c, lo, hi)
    q = (c - lo) / np.maximum(hi - lo, 1e-12)
    want = _morton3d_np(q.astype(np.float64))
    mism = (got != want).mean()
    assert mism < 0.001  # float rounding at quantization boundaries
