"""Golden statistical regression: every scene, fixed seed, low res.

The reference's fidelity instruments are committed PNGs
(/root/reference/image/*, README.md:29-53); the full-resolution
mean-abs-diff check against them runs on the card via tools/golden.py
(chip_smoke.py phase 5).
This CPU-suite counterpart renders each scene small and asserts the
image statistics recorded in golden_stats.json (generated by
scripts/gen_golden_stats.py).  An integrator regression — MIS weights,
pdf floors, spectral tables, emission scaling — moves the scene mean
far beyond the allowed drift; RNG-assignment changes (compaction,
lane permutation) stay well inside it.
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import ti_raytrace_tpu.accel as accel
from ti_raytrace_tpu.examples.run import get_integrator
from ti_raytrace_tpu.examples.scenes import EXAMPLES, make_camera

STATS = json.load(
    open(os.path.join(os.path.dirname(__file__), "golden_stats.json"))
)

MEAN_RTOL = 0.08       # scene-mean drift budget
QUAD_RTOL = 0.18       # per-quadrant drift budget (noisier)
ABS_FLOOR = 2e-3       # ignore drift below this absolute radiance


@pytest.fixture(autouse=True)
def _dense_everywhere(monkeypatch):
    # CPU suite: the dense sweep traces every scene (the cluster kernel
    # has its own oracle test in test_cluster.py; interpret mode at
    # golden sizes would be minutes per scene)
    monkeypatch.setattr(accel, "DENSE_MAX_PRIMS", 10 ** 9)


def _render(name):
    rec = STATS[name]
    scene, cfg = EXAMPLES[name]()
    spec, cam = make_camera(scene, cfg, rec["size"], rec["size"])
    render = get_integrator(cfg.integrator, cfg.sky, None, scene)
    if cfg.integrator == "bdpt_rgb":
        from ti_raytrace_tpu.integrators import bdpt_rgb

        render = bdpt_rgb.render_frame
    acc = None
    for f in range(rec["frames"]):
        img = np.asarray(
            render(scene, spec, cam, jnp.int32(f + 1),
                   jax.random.PRNGKey(100 + f))
        )
        acc = img if acc is None else acc + img
    return acc / rec["frames"], rec


def _check(img, rec):
    for c in range(3):
        got = img[..., c].mean()
        want = rec["mean"][c]
        assert abs(got - want) <= max(MEAN_RTOL * abs(want), ABS_FLOOR), (
            f"channel {c}: got {got:.5f}, golden {want:.5f}"
        )
    w, h, _ = img.shape
    quads = [
        img[: w // 2, : h // 2].mean(),
        img[: w // 2, h // 2:].mean(),
        img[w // 2:, : h // 2].mean(),
        img[w // 2:, h // 2:].mean(),
    ]
    for i, (got, want) in enumerate(zip(quads, rec["quadrants"])):
        assert abs(got - want) <= max(QUAD_RTOL * abs(want), ABS_FLOOR), (
            f"quadrant {i}: got {got:.5f}, golden {want:.5f}"
        )


# cornell_box runs in the QUICK tier (mid-tier coverage: the default
# run must catch estimator regressions); the other
# scenes stay behind the slow marker
@pytest.mark.parametrize(
    "name",
    [n if n == "cornell_box" else pytest.param(n, marks=pytest.mark.slow)
     for n in sorted(STATS)],
)
def test_golden_stats(name):
    img, rec = _render(name)
    assert np.isfinite(img).all()
    _check(img, rec)


@pytest.mark.slow
def test_pt_bdpt_convergence():
    """PT and the CORRECTED bidirectional estimator must agree — the
    reference's own validation instrument (veach-pt512 vs veach-bdpt512,
    README.md:31-33), executable here because corrected=True removes the
    reference's strategy overcounting (PARITY.md 'BDPT estimator').
    Runs on the quirk-free single-material box so the replicated
    material-index MIS quirk can't mask a real regression."""
    from ti_raytrace_tpu.examples.scenes import make_camera
    from ti_raytrace_tpu.integrators import bdpt_rgb, pt_rgb
    from ti_raytrace_tpu.tools.bdpt_decompose import _diag_box

    scene, cfg = _diag_box()
    spec, cam = make_camera(scene, cfg, 32, 32)
    frames = 8

    pt = 0.0
    bd = 0.0
    for f in range(frames):
        key = jax.random.PRNGKey(50 + f)
        pt += float(
            np.asarray(
                pt_rgb.render_frame(scene, spec, cam, jnp.int32(f + 1), key)
            ).mean()
        )
        bd += float(
            np.asarray(
                bdpt_rgb.render_frame(scene, spec, cam, jnp.int32(f + 1), key,
                                      corrected=True)
            ).mean()
        )
    pt /= frames
    bd /= frames
    assert pt > 0.01
    # With corrected contributions (true sampler densities) AND the
    # standard corrected-MIS weights, BDPT/PT measures 1.061 at 8 frames
    # (per-frame ratios 1.005-1.11) — a small systematic residual from
    # the differing depth truncations (PT walks 15 bounces; BDPT eye 5 +
    # light 4 with strategy-grid cutoffs), down from 3.3x (quirk mode)
    # and 0.8x (corrected contributions with quirk weights).
    assert abs(bd - pt) / pt < 0.08, f"PT {pt:.5f} vs corrected BDPT {bd:.5f}"
