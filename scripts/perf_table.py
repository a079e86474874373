"""Per-scene performance table: one measured ms/frame + fps line for
every example at 512^2 on the GPU, printed as a markdown block stamped
with the card's name and power limit.

One process, scenes sequential; per scene the first dispatch (compile +
first frames) is reported separately from the steady-state median.
Progressive 1 spp frames throughout.  Spectral PT runs the KF
multi-frame dispatch (render_film_frames_spec); the 100k benchmark runs
the production merged path (same config as bench.py).

    python scripts/perf_table.py [--quick] [--scenes NAME ...]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ti_raytrace_tpu.core.runtime import (  # noqa: E402
    card_name_and_power,
    require_gpu,
    setup_compile_cache,
)

setup_compile_cache()
require_gpu()

import jax  # noqa: E402
import numpy as np

from ti_raytrace_tpu import film as film_mod
from ti_raytrace_tpu.examples.run import get_integrator
from ti_raytrace_tpu.examples.scenes import (
    BENCH_SCHEDULE_MERGED,
    EXAMPLES,
    make_camera,
)

SIZE = 512


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _measure(step, n_timed):
    """step(film) -> film'.  Returns (compile_s, [per-dispatch seconds])."""
    fl = film_mod.new_film(SIZE, SIZE)
    t0 = time.time()
    fl = step(fl)
    fl.hdr.block_until_ready()
    compile_s = time.time() - t0
    times = []
    for _ in range(n_timed):
        t0 = time.perf_counter()
        fl = step(fl)
        fl.hdr.block_until_ready()
        times.append(time.perf_counter() - t0)
    assert np.isfinite(np.asarray(fl.hdr)).all()
    return compile_s, times


def measure_scene(name: str, quick: bool):
    scene, cfg = EXAMPLES[name]()
    spec, cam = make_camera(scene, cfg, SIZE, SIZE)
    integ = cfg.integrator
    n_timed = 2 if quick else 4
    cfg_compaction = cfg.compaction
    if cfg_compaction == "auto":
        from ti_raytrace_tpu.integrators import pt_rgb as _pt

        cfg_compaction = _pt.calibrate_compaction(scene, spec, cam)
        log(f"{name}: calibrated compaction {cfg_compaction}")

    if name == "benchmark_100k":
        from functools import partial

        from ti_raytrace_tpu.integrators import pt_rgb

        from ti_raytrace_tpu.examples.scenes import BENCH_PAY_DIVISORS

        KF, G = 128, 16
        step_fn = jax.jit(
            partial(pt_rgb.render_film_frames_merged.__wrapped__,
                    n_frames=KF, group=G, compaction=BENCH_SCHEDULE_MERGED,
                    nee=pt_rgb.has_nee_materials(scene),
                    pay_divisors=BENCH_PAY_DIVISORS),
            static_argnums=(1,), donate_argnums=(3,),
        )

        def step(fl):
            fl, _ = step_fn(scene, spec, cam, fl)
            return fl

        compile_s, times = _measure(step, n_timed)
        per_frame = sorted(times)[len(times) // 2] / KF
        return integ, per_frame, compile_s

    if integ == "pt_spec":
        from ti_raytrace_tpu.integrators import pt_spec

        KF = 4 if quick else 8
        sdata = pt_spec.make_spectral_data(**(cfg.sky or {}))
        compaction = cfg.compaction

        def step(fl):
            fl, ov = pt_spec.render_film_frames_spec(
                scene, sdata, spec, cam, fl, n_frames=KF,
                compaction=compaction,
            )
            assert int(ov) == 0, f"{name}: compaction overflow {int(ov)}"
            return fl

        compile_s, times = _measure(step, n_timed)
        per_frame = sorted(times)[len(times) // 2] / KF
        return integ, per_frame, compile_s

    if integ == "pt_rgb":
        from ti_raytrace_tpu.integrators import pt_rgb

        KF = 4 if quick else 8

        def step(fl):
            fl, _ = pt_rgb.render_film_frames(
                scene, spec, cam, fl, n_frames=KF,
                compaction=cfg_compaction,
                nee=pt_rgb.has_nee_materials(scene),
            )
            return fl

        compile_s, times = _measure(step, n_timed)
        per_frame = sorted(times)[len(times) // 2] / KF
        return integ, per_frame, compile_s

    # single-frame integrators (bdpt_rgb, bdpt_spec)
    render = get_integrator(integ, cfg.sky, cfg_compaction, scene)

    def step(fl):
        return film_mod.accumulate(
            fl, render(scene, spec, cam, fl.frame, fl.key)
        )

    n_timed = max(1, n_timed if integ.startswith("pt") else n_timed // 2)
    compile_s, times = _measure(step, n_timed)
    per_frame = sorted(times)[len(times) // 2]
    return integ, per_frame, compile_s


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--scenes", nargs="*", default=None)
    args = ap.parse_args()

    names = args.scenes or [
        "cornell_box", "single_model", "sky_dome", "spectral_box",
        "veach_bdpt", "prism_rainbow", "benchmark_100k",
    ]
    rows = []
    for name in names:
        log(f"measuring {name} ...")
        integ, per_frame, compile_s = measure_scene(name, args.quick)
        fps = 1.0 / per_frame
        rows.append((name, integ, per_frame * 1e3, fps, compile_s))
        log(f"{name:16s} {integ:10s} {per_frame*1e3:8.1f} ms/frame "
            f"{fps:7.2f} fps  (compile+first {compile_s:.1f}s)")

    stamp = time.strftime("%Y-%m-%d")
    lines = [f"Measured {stamp} on {card_name_and_power()} (512x512, "
             "progressive 1 spp frames, steady-state median dispatch; "
             "compile+first-dispatch listed separately).  Producing script: "
             "`scripts/perf_table.py`.",
             "",
             "| scene | integrator | ms/frame | fps | compile+first (s) |",
             "|---|---|---|---|---|"]
    for name, integ, ms, fps, comp in rows:
        lines.append(f"| {name} | {integ} | {ms:.3f} | {fps:.3f} | {comp:.1f} |")
    print("\n".join(lines))


if __name__ == "__main__":
    main()
