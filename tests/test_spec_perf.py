"""Spectral integrator perf machinery: compaction
phases and multi-frame dispatch for pt_spec must preserve the estimator.

Compaction changes per-lane RNG stream widths (same property as
pt_rgb.trace_paths), so the check is statistical: same mean at matched
sample counts with zero overflow kills.  The KF film dispatch, by
contrast, replays the film key chain exactly and must be bit-identical
to the frame-by-frame loop."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ti_raytrace_tpu import film as film_mod
from ti_raytrace_tpu.examples.scenes import example_cached, make_camera
from ti_raytrace_tpu.integrators import pt_spec

SIZE = 32


@pytest.fixture(scope="module")
def setup():
    """One scene build + spectral-table precompute for the module (the
    per-test rebuild was ~15 s of this file's runtime)."""
    scene, cfg = example_cached("spectral_box")
    spec, cam = make_camera(scene, cfg, SIZE, SIZE)
    sdata = pt_spec.make_spectral_data(**(cfg.sky or {}))
    return scene, spec, cam, sdata, cfg.sky or {}


def test_spec_compaction_matches_exact(setup):
    scene, spec, cam, sdata, sky = setup

    def render(compaction, n=6):
        # max_depth 6 (vs the production 10): the parity property is
        # depth-independent and compile dominates this test's cost
        fl = film_mod.new_film(SIZE, SIZE, seed=5)
        render_frame = pt_spec.make_render_frame(**sky, compaction=compaction,
                                                 max_depth=6)
        for _ in range(n):
            fl = film_mod.accumulate(
                fl, render_frame(scene, spec, cam, fl.frame, fl.key)
            )
        return np.asarray(fl.hdr)

    exact = render(None)
    compacted = render(((2, 2), (5, 8)))
    assert abs(compacted.mean() - exact.mean()) / max(exact.mean(), 1e-9) < 0.02


def test_spec_compaction_overflow_zero(setup):
    scene, spec, cam, sdata, _ = setup
    from ti_raytrace_tpu.camera import ray_directions, ray_origins

    k_cam, k_path = jax.random.split(jax.random.PRNGKey(3))
    o = jnp.swapaxes(ray_origins(spec, cam), 0, 1)
    d = jnp.swapaxes(ray_directions(spec, cam, jnp.int32(1), k_cam), 0, 1)
    _, ov = pt_spec.trace_paths_spec(
        scene, sdata, o, d, k_path, compaction=((2, 2), (5, 8)),
        return_overflow=True, max_depth=6,
    )
    assert int(ov) == 0


def test_spec_film_frames_matches_loop(setup):
    """One KF-frame dispatch == n single-frame accumulate() calls: same
    film key chain, same per-frame RNG — equal up to XLA fusion-order
    rounding (measured 4e-6 abs on CPU)."""
    scene, spec, cam, sdata, sky = setup
    compaction = ((2, 2),)

    render_frame = pt_spec.make_render_frame(**sky, compaction=compaction,
                                             max_depth=6)
    fl_loop = film_mod.new_film(SIZE, SIZE, seed=9)
    for _ in range(3):
        fl_loop = film_mod.accumulate(
            fl_loop, render_frame(scene, spec, cam, fl_loop.frame, fl_loop.key)
        )

    fl_kf = film_mod.new_film(SIZE, SIZE, seed=9)
    fl_kf, ov = pt_spec.render_film_frames_spec(
        scene, sdata, spec, cam, fl_kf, n_frames=3, compaction=compaction,
        max_depth=6
    )
    assert int(ov) == 0
    assert int(fl_kf.frame) == 3
    np.testing.assert_allclose(
        np.asarray(fl_kf.hdr), np.asarray(fl_loop.hdr), rtol=1e-4, atol=1e-5
    )
