"""Full-resolution golden-image regression vs the reference's PNGs.

The reference commits its fidelity targets (README.md:29-53):
out.png (cornell PT), image/veach-bdpt512.png, image/skydome.png,
image/spectral-cornellbox.png, image/rainbow-far.png.  This script
renders the matching scene, tone-maps with the reference's pipeline
(exposure 0.5 ACES + sRGB, Example.py:43), computes the mean absolute
difference in 8-bit-normalized space, and checks it against the
recorded bound — so the numbers quoted in README.md are reproducible
and regression-checked instead of one-off manual measurements.

Run:  python -m ti_raytrace_tpu.tools.golden [--scene NAME]
      [--frames N] [--size PX] [--update]
--update rewrites tools' golden_bounds.json with measured + 25% slack.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

BOUNDS_PATH = os.path.join(os.path.dirname(__file__), "golden_bounds.json")

# name -> (scene, integrator override, reference image, frames)
TARGETS = {
    "cornell_box": ("cornell_box", None, "out.png", 64),
    "sky_dome": ("sky_dome", None, "image/skydome.png", 32),
    # 256 frames: the concave ACES display transform turns 64-spp noise
    # into a ~0.015 diff inflation vs the 512-spp golden (0.0806 at 64
    # frames -> 0.0644 at 256)
    "spectral_box": ("spectral_box", None, "image/spectral-cornellbox.png", 256),
    "veach_bdpt": ("veach_bdpt", None, "image/veach-bdpt512.png", 32),
    # the reference's own PT-vs-BDPT cross-check pair (README.md:31-33):
    # the veach scene rendered unidirectionally against veach-pt512.png.
    # 256 frames: the concave ACES transform turns residual noise into a
    # diff inflation (an apparent left-wall NEE spill was exactly this —
    # mad 0.087 at 64 frames vs 0.051 at 512)
    "veach_pt": ("veach_bdpt", "pt_rgb", "image/veach-pt512.png", 256),
    # 64 frames: a 16-frame bound was the least-converged target
    "prism_rainbow": ("prism_rainbow", None, "image/rainbow-far.png", 64),
}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def render_scene(name: str, frames: int, size: int = 512,
                 integrator: str = None) -> np.ndarray:
    import jax

    from ti_raytrace_tpu import film as film_mod
    from ti_raytrace_tpu.examples.run import get_integrator
    from ti_raytrace_tpu.examples.scenes import EXAMPLES, make_camera

    scene, cfg = EXAMPLES[name]()
    spec, cam = make_camera(scene, cfg, size, size)
    compaction = cfg.compaction if cfg.compaction != "auto" else None
    integ = integrator or cfg.integrator
    fl = film_mod.new_film(size, size)
    t0 = time.time()
    if integ == "pt_rgb":
        # multi-frame dispatch: bit-identical to the per-frame loop
        # (same film key chain), 8x fewer dispatches
        from ti_raytrace_tpu.integrators import pt_rgb

        nee = pt_rgb.has_nee_materials(scene)
        done = 0
        while done < frames:
            n = min(8, frames - done)
            fl, _ = pt_rgb.render_film_frames(
                scene, spec, cam, fl, n_frames=n, compaction=compaction,
                nee=nee,
            )
            fl.hdr.block_until_ready()
            done += n
    else:
        # pass cfg so the gate validates the SHIPPED per-scene config
        # (bdpt walk compaction / shadow cap included)
        render = get_integrator(integ, cfg.sky, compaction, scene, cfg)
        for _ in range(frames):
            rad = render(scene, spec, cam, fl.frame, fl.key)
            rad.block_until_ready()
            fl = film_mod.accumulate(fl, rad)
    log(f"{name}: {frames} frames in {time.time()-t0:.1f}s")
    srgb = np.asarray(film_mod.to_srgb(fl, cfg.exposure))
    # film is (W, H); reference images are row-major with y down
    return np.clip(srgb, 0.0, 1.0)


def load_reference(rel: str) -> np.ndarray:
    from ti_raytrace_tpu.io.assets import asset_path
    from ti_raytrace_tpu.io.image import read_image

    return read_image(asset_path(rel))


def mean_abs_diff(img: np.ndarray, ref: np.ndarray) -> float:
    from ti_raytrace_tpu.io.image import film_to_image

    img_rows = film_to_image(img)
    ref = ref[..., :3]
    if img_rows.shape != ref.shape:
        # nearest-resize the reference to the rendered resolution
        h, w = img_rows.shape[:2]
        yi = (np.arange(h) * ref.shape[0] // h).clip(0, ref.shape[0] - 1)
        xi = (np.arange(w) * ref.shape[1] // w).clip(0, ref.shape[1] - 1)
        ref = ref[yi][:, xi]
    return float(np.abs(img_rows - ref).mean())


def main(argv=None):
    from ti_raytrace_tpu.core.runtime import setup_compile_cache

    setup_compile_cache()
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scene", default=None, choices=sorted(TARGETS))
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--update", action="store_true")
    args = ap.parse_args(argv)

    bounds = {}
    if os.path.exists(BOUNDS_PATH):
        bounds = json.load(open(BOUNDS_PATH))

    names = [args.scene] if args.scene else sorted(TARGETS)
    results, failures = {}, []
    for name in names:
        scene_name, integrator, rel, frames = TARGETS[name]
        try:
            from ti_raytrace_tpu.io.assets import asset_path

            asset_path(rel)
        except FileNotFoundError:
            log(f"{name}: reference image {rel} missing, skipped")
            continue
        img = render_scene(scene_name, args.frames or frames, args.size,
                           integrator=integrator)
        ref = load_reference(rel)
        diff = mean_abs_diff(img, ref)
        log(f"{name}: mean {img.mean():.4f} vs reference {ref[..., :3].mean():.4f} "
            f"(ratio {img.mean()/max(ref[..., :3].mean(), 1e-9):.3f})")
        results[name] = diff
        bound = bounds.get(name)
        status = ""
        if bound is not None and not args.update:
            status = "OK" if diff <= bound else "REGRESSION"
            if diff > bound:
                failures.append(name)
        print(f"{name:16s} diff {diff:.4f}  bound {bound}  {status}")

    if args.update:
        for name, diff in results.items():
            bounds[name] = round(diff * 1.25, 4)
        json.dump(bounds, open(BOUNDS_PATH, "w"), indent=2, sort_keys=True)
        print("updated", BOUNDS_PATH)
        return 0
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
