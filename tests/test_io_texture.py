"""IO + texture + meshgen unit tests."""

import glob
import os

import numpy as np
import jax.numpy as jnp
import pytest

from ti_raytrace_tpu.io.image import (decode_png, encode_png, film_to_image,
                                      image_to_film, read_image, write_png)
from ti_raytrace_tpu.io.meshgen import densify_to, split2, subdivide4
from ti_raytrace_tpu.texture.texture import sample_nearest, texture2d


def test_png_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.random((16, 24, 3)).astype(np.float32)
    p = str(tmp_path / "x.png")
    write_png(p, img)
    back = read_image(p)
    assert back.shape == (16, 24, 3)
    np.testing.assert_allclose(back, img, atol=1.0 / 255.0)


def test_png_encode_decode_exact():
    img = np.random.default_rng(2).integers(0, 256, (7, 5, 3), np.uint8)
    np.testing.assert_array_equal(decode_png(encode_png(img)), img)


_ASSETS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets", "image")
# shape (H, W, C) and a few pixels (y, x) -> value of every vendored PNG,
# as any conforming decoder reads them
_PINNED = {
    "env.png": ((402, 804, 4), {(0, 0): (255, 255, 255, 255),
                                (201, 268): (0, 0, 0, 255)}),
    "glass.png": ((512, 512, 3), {(0, 0): (199, 177, 155),
                                  (256, 170): (106, 110, 54)}),
    "metal.png": ((512, 512, 3), {(256, 170): (135, 118, 75)}),
    "non-metal.png": ((512, 512, 3), {(256, 170): (166, 158, 134)}),
    "rainbow-far.png": ((512, 512, 3), {(256, 170): (168, 162, 170)}),
    "rainbow-reference.png": ((810, 1440, 3), {(405, 480): (8, 0, 137)}),
    "rainbow.png": ((512, 512, 3), {(0, 0): (0, 0, 0)}),
    "skydome.png": ((512, 512, 3), {(0, 0): (20, 41, 54),
                                    (256, 170): (71, 73, 52)}),
    "spectral-cornellbox.png": ((512, 512, 3), {(256, 170): (144, 132, 134)}),
    "veach-bdpt-TungstenRender.png": ((1024, 1024, 3),
                                      {(512, 341): (123, 111, 101)}),
    "veach-bdpt512.png": ((512, 512, 3), {(0, 0): (211, 211, 211),
                                          (256, 170): (123, 112, 103)}),
    "veach-pt512.png": ((512, 512, 3), {(256, 170): (76, 67, 58)}),
}


@pytest.mark.parametrize("name", sorted(_PINNED))
def test_png_decode_vendored(name):
    with open(os.path.join(_ASSETS, name), "rb") as f:
        px = decode_png(f.read())
    shape, pins = _PINNED[name]
    assert px.shape == shape
    for (y, x), want in pins.items():
        assert tuple(px[y, x].tolist()) == want, (name, y, x)


def test_png_pins_cover_every_vendored_image():
    assert sorted(os.path.basename(p) for p in
                  glob.glob(os.path.join(_ASSETS, "*.png"))) == sorted(_PINNED)


def test_film_image_transpose_roundtrip():
    rng = np.random.default_rng(1)
    film = rng.random((8, 6, 3)).astype(np.float32)  # (W, H, 3)
    img = film_to_image(film)
    assert img.shape == (6, 8, 3)
    np.testing.assert_array_equal(image_to_film(img), film)
    # y=0 (film bottom) must land on the last image row
    np.testing.assert_array_equal(img[-1, 3], film[3, 0])


def test_texture_bilinear():
    tex = jnp.asarray(
        np.array([[[0, 0, 0], [1, 1, 1]], [[1, 1, 1], [0, 0, 0]]], np.float32)
    )  # 2x2 checker
    # the reference samples at floor(u*w) and +1 (no half-texel centering,
    # Texture.py:51-69): u=v=0.25 -> x=y=0.5 -> equal mix of all 4 texels
    v = np.asarray(texture2d(tex, jnp.asarray([0.25]), jnp.asarray([0.25])))
    np.testing.assert_allclose(v[0], [0.5, 0.5, 0.5], atol=1e-6)
    # u=v=0.5 lands exactly on texel (1,1) under that convention
    v = np.asarray(texture2d(tex, jnp.asarray([0.5]), jnp.asarray([0.5])))
    np.testing.assert_allclose(v[0], [0.0, 0.0, 0.0], atol=1e-6)
    # clamped corners
    v00 = np.asarray(sample_nearest(tex, jnp.asarray([-5.0]), jnp.asarray([-5.0])))
    np.testing.assert_allclose(v00[0], [0, 0, 0])


def test_subdivision_preserves_area():
    rng = np.random.default_rng(2)
    pos = rng.random((10, 3, 3)).astype(np.float32)
    nrm = rng.random((10, 3, 3)).astype(np.float32)
    uv = rng.random((10, 3, 2)).astype(np.float32)

    def area(p):
        e1 = p[:, 1] - p[:, 0]
        e2 = p[:, 2] - p[:, 0]
        return 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1).sum()

    a0 = area(pos)
    p4, n4, u4 = subdivide4(pos, nrm, uv)
    assert p4.shape[0] == 40
    np.testing.assert_allclose(area(p4), a0, rtol=1e-5)
    p2, _, _ = split2(pos, nrm, uv)
    assert p2.shape[0] == 20
    np.testing.assert_allclose(area(p2), a0, rtol=1e-5)

    pd, _, _ = densify_to(pos, nrm, uv, 100)
    assert pd.shape[0] >= 100
    np.testing.assert_allclose(area(pd), a0, rtol=1e-4)


def test_metrics_meter():
    from ti_raytrace_tpu.metrics import RenderMeter

    m = RenderMeter(512 * 512)
    m.tick(10.0)  # warmup (compile)
    for _ in range(5):
        m.tick(0.1)
    assert abs(m.fps - 10.0) < 1e-6
    rep = m.report()
    assert rep["frames"] == 5 and rep["compile_s"] == 10.0
    assert abs(rep["mrays_per_s"] - 512 * 512 * 10 / 1e6) < 1e-3
