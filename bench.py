"""Benchmark: progressive path tracing on the reference's headline
workload (README.md:56-58 — 30 fps at 1 spp on a 100k-triangle mesh,
512x512, RTX 2070 Super).

`model/mc.obj` is a missing blob upstream, so the 100k-triangle scene is
a densified Teapot (>= 100k tris) with the single_model material setup
(glass override + sphere light + env map, example/single_model.py:27-34).

    python bench.py [--out PNG]

Needs a GPU: without one it stops before rendering.  Prints ONE JSON
line on stdout: {"metric", "value", "unit", "vs_baseline", "device"};
context lines go to stderr.  The compaction schedule is the constant
scenes.BENCH_SCHEDULE_MERGED, verified at runtime by the overflow
counter: a nonzero kill count means the schedule biases the estimator.
"""

import argparse
import json
import os
import sys
import time

BASELINE_FPS = 30.0  # reference on RTX 2070 Super (BASELINE.md)
SIZE = 512
KF = 128     # frames per dispatch
GROUP = 16   # frames per merged group (shared compacted deep phases)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def setup(size: int = SIZE):
    """(scene, spec, cam, nee) of the benchmark scene at size x size."""
    import numpy as np

    from ti_raytrace_tpu.camera import CameraSpec, orbit_camera
    from ti_raytrace_tpu.examples.scenes import benchmark_100k
    from ti_raytrace_tpu.integrators import pt_rgb

    scene, _ = benchmark_100k()
    lo = np.asarray(scene.aabb_min)
    hi = np.asarray(scene.aabb_max)
    centre = 0.5 * (lo + hi)
    scale = float(np.linalg.norm(hi - lo)) * 0.8
    cam = orbit_camera(centre, 0.0, 0.0, scale)
    # all-glass scene: NEE contributes exactly zero -> compile it out
    return scene, CameraSpec(size, size), cam, pt_rgb.has_nee_materials(scene)


def make_step(scene, spec, cam, nee, kf: int = KF, group: int = GROUP,
              render=None):
    """One dispatch of `kf` merged frames: step(film) -> (film, kills).

    render: the merged renderer (default pt_rgb.render_film_frames_merged);
    a caller may pass another compiled instance of the same function."""
    from ti_raytrace_tpu.examples.scenes import (BENCH_PAY_DIVISORS,
                                                 BENCH_SCHEDULE_MERGED)
    from ti_raytrace_tpu.integrators import pt_rgb

    render = render or pt_rgb.render_film_frames_merged

    def step(fl):
        return render(scene, spec, cam, fl, kf, group, BENCH_SCHEDULE_MERGED,
                      nee, pay_divisors=BENCH_PAY_DIVISORS)

    return step


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), ".cache",
        "bench_render.png"))
    args = ap.parse_args(argv)

    from ti_raytrace_tpu.core.runtime import require_gpu, setup_compile_cache

    setup_compile_cache()
    device = require_gpu()

    import numpy as np

    from ti_raytrace_tpu import film as film_mod

    t0 = time.time()
    scene, spec, cam, nee = setup()
    log(f"scene build: {time.time() - t0:.1f}s, prims={scene.n_prims}, "
        f"nee={nee} kf={KF} group={GROUP}")
    step = make_step(scene, spec, cam, nee)

    fl = film_mod.new_film(SIZE, SIZE)
    t0 = time.time()
    fl, ov_total = step(fl)
    fl.hdr.block_until_ready()
    log(f"compile + first {KF} frames: {time.time() - t0:.1f}s")

    n_disp = 5
    times = []
    for _ in range(n_disp):
        tf = time.perf_counter()
        fl, ov = step(fl)
        ov_total = ov_total + ov
        fl.hdr.block_until_ready()
        times.append(time.perf_counter() - tf)
    med = sorted(times)[n_disp // 2]
    fps = KF / med
    overflow_total = int(np.asarray(ov_total))
    log(f"{n_disp * KF} frames in {sum(times):.2f}s ({n_disp} dispatches, "
        f"best {min(times) / KF * 1e3:.3f} ms/frame, median "
        f"{med / KF * 1e3:.3f} ms/frame); "
        f"compaction overflow kills: {overflow_total}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    film_mod.save_png(fl, args.out)

    print(json.dumps(dict(
        metric="pt_progressive_fps_100k_tri_512px",
        value=round(fps, 3),
        unit="fps_at_1spp",
        vs_baseline=round(fps / BASELINE_FPS, 3),
        overflow_kills=overflow_total,
        device=device,
    )))
    if overflow_total:
        raise SystemExit("compaction overflow kills: the estimator is biased")


if __name__ == "__main__":
    main()
