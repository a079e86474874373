"""Generate tests/golden_stats.json: low-res CPU statistical goldens.

Renders each scene at a small fixed size/seed on the CPU backend and
records image statistics (mean per channel + 2x2 quadrant means).
tests/test_golden.py asserts future renders stay within tolerance —
an integrator regression (MIS weights, pdf floors, spectral tables)
moves these numbers far more than the allowed drift.

Run: JAX_PLATFORMS=cpu python scripts/gen_golden_stats.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def stats(img: np.ndarray) -> dict:
    w, h, _ = img.shape
    q = [
        float(img[: w // 2, : h // 2].mean()),
        float(img[: w // 2, h // 2:].mean()),
        float(img[w // 2:, : h // 2].mean()),
        float(img[w // 2:, h // 2:].mean()),
    ]
    return dict(
        mean=[float(img[..., c].mean()) for c in range(3)],
        quadrants=q,
    )


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    import ti_raytrace_tpu.accel as accel
    accel.DENSE_MAX_PRIMS = 10 ** 9  # CPU: dense sweep for every scene

    from ti_raytrace_tpu.examples.scenes import EXAMPLES, make_camera
    from ti_raytrace_tpu.examples.run import get_integrator

    plan = [
        # (scene, size, frames)
        ("cornell_box", 48, 3),
        ("single_model", 48, 3),
        ("sky_dome", 32, 2),
        ("spectral_box", 32, 2),
        ("veach_bdpt", 32, 1),
        ("prism_rainbow", 32, 1),
    ]
    out = {}
    for name, size, frames in plan:
        t0 = time.time()
        scene, cfg = EXAMPLES[name]()
        spec, cam = make_camera(scene, cfg, size, size)
        render = get_integrator(cfg.integrator, cfg.sky, None, scene)
        if cfg.integrator == "bdpt_rgb":
            from ti_raytrace_tpu.integrators import bdpt_rgb
            render = bdpt_rgb.render_frame  # unsliced at this size
        acc = None
        for f in range(frames):
            img = np.asarray(
                render(scene, spec, cam, jnp.int32(f + 1),
                       jax.random.PRNGKey(100 + f))
            )
            acc = img if acc is None else acc + img
        acc = acc / frames
        out[name] = dict(size=size, frames=frames, seed=100, **stats(acc))
        print(f"{name}: {time.time()-t0:.1f}s mean={out[name]['mean']}",
              flush=True)

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "tests", "golden_stats.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=2, sort_keys=True)
    print("wrote", path)


if __name__ == "__main__":
    main()
