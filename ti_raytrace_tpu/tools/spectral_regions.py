"""Region-wise comparison of the spectral_box render vs the reference
golden (image/spectral-cornellbox.png) — the instrument for spectral
box parity.

The lamp region isolates the EMISSION path (D65 x rgb2spec tint of the
light color, reference PT_Spec.emission_to_rad:110-116); the white/red/
green wall regions isolate the measured-SPD REFLECTANCE path
(get_spec_power:120-135).  A uniform deficit points at emission or the
white-point normalization; a per-wall deficit points at the SPD tables.

Run: python -m ti_raytrace_tpu.tools.spectral_regions [--frames N]
"""

import argparse
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# (name, x0, x1, y0, y1) in 512-render row-major image coordinates
# (y down); scaled for other sizes.  Chosen off the reference layout:
# lamp = bright ceiling patch, walls at the left/right image borders.
REGIONS = [
    ("lamp",      220, 290, 20, 60),
    ("ceiling",   100, 410, 70, 110),
    ("left_wall",  10,  60, 180, 380),
    ("right_wall", 450, 500, 180, 380),
    ("back_wall", 180, 330, 180, 330),
    ("floor",     150, 360, 440, 500),
]


def region_stats(img, size):
    out = {}
    s = size / 512.0
    for name, x0, x1, y0, y1 in REGIONS:
        r = img[int(y0 * s):int(y1 * s), int(x0 * s):int(x1 * s), :3]
        out[name] = (r.mean(axis=(0, 1)), r.mean())
    return out


def main(argv=None):
    from ti_raytrace_tpu.core.runtime import setup_compile_cache

    setup_compile_cache()

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--scene", default="spectral_box")
    ap.add_argument("--ref", default="image/spectral-cornellbox.png")
    ap.add_argument("--save", default="spectral_box.png")
    args = ap.parse_args(argv)

    from ti_raytrace_tpu.io.image import film_to_image
    from ti_raytrace_tpu.tools.golden import load_reference, render_scene

    t0 = time.time()
    img = render_scene(args.scene, args.frames, args.size)
    log(f"rendered in {time.time()-t0:.1f}s")
    img_rows = film_to_image(img)
    if args.save:
        from ti_raytrace_tpu.io.image import write_png

        write_png(args.save, img_rows)
        log(f"saved {args.save}")

    ref = load_reference(args.ref)[..., :3]
    if ref.shape[0] != args.size:
        yi = (np.arange(args.size) * ref.shape[0] // args.size)
        ref = ref[yi][:, yi]

    ours = region_stats(img_rows, args.size)
    theirs = region_stats(ref, args.size)
    print(f"{'region':<11s} {'ours rgb':<24s} {'ref rgb':<24s} ratio")
    for name, *_ in REGIONS:
        o_rgb, o_m = ours[name]
        r_rgb, r_m = theirs[name]
        fmt = lambda v: "[" + " ".join(f"{x:.3f}" for x in v) + "]"
        print(f"{name:<11s} {fmt(o_rgb):<24s} {fmt(r_rgb):<24s} "
              f"{o_m / max(r_m, 1e-9):.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
