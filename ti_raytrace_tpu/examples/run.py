"""CLI render harness: the headless replacement for the reference's
Main.py + ti.GUI loop (Example.py:38-59).

    python -m ti_raytrace_tpu.examples.run cornell_box \
        --size 512 --frames 512 --out out.png

Progressive rendering: 1 spp per frame, running-mean accumulation,
periodic PNG snapshots and resumable checkpoints.  The closing JSON line
names the device the frames ran on.
"""

import argparse
import json
import time

from ti_raytrace_tpu import film as film_mod
from ti_raytrace_tpu.examples.scenes import EXAMPLES, make_camera
from ti_raytrace_tpu.metrics import RenderMeter


def get_integrator(name: str, cfg_sky=None, compaction=None, scene=None,
                   cfg=None):
    if name == "pt_rgb":
        import functools

        from ti_raytrace_tpu.integrators import pt_rgb

        nee = pt_rgb.has_nee_materials(scene) if scene is not None else True
        return functools.partial(pt_rgb.render_frame, compaction=compaction, nee=nee)
    if name == "debug":
        from ti_raytrace_tpu.integrators import debug

        return debug.render_frame
    if name == "pt_spec":
        from ti_raytrace_tpu.integrators import pt_spec

        sky = cfg_sky or {}
        return pt_spec.make_render_frame(**sky, compaction=compaction)
    if name == "bdpt_rgb":
        import functools

        from ti_raytrace_tpu.integrators import bdpt_rgb

        # 2 slices halve the peak device memory of a 512^2 frame
        return functools.partial(
            bdpt_rgb.render_frame_sliced, n_slices=2,
            walk_compaction=(cfg.bdpt_walk_compaction if cfg else None),
            shadow_cap=(cfg.bdpt_shadow_cap if cfg else None))
    if name == "bdpt_spec":
        from ti_raytrace_tpu.integrators import bdpt_spec

        return bdpt_spec.make_render_frame(
            **(cfg_sky or {}),
            walk_compaction=(cfg.bdpt_walk_compaction if cfg else None),
            shadow_cap=(cfg.bdpt_shadow_cap if cfg else None))
    raise ValueError(f"unknown integrator {name!r}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("example", choices=sorted(EXAMPLES))
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--frames", type=int, default=512)
    ap.add_argument("--out", default="out.png")
    ap.add_argument("--integrator", default=None, help="override integrator")
    ap.add_argument("--snapshot-every", type=int, default=64)
    ap.add_argument("--checkpoint", default=None, help="save/resume .npz path")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--preview", action="store_true",
                    help="live window + orbit keys (arrows/+-/q); moving "
                         "the camera restarts progressive accumulation")
    ap.add_argument("--cpu", action="store_true",
                    help="allow a run without a GPU (tests): the cluster "
                         "kernel runs in the Pallas interpreter and the "
                         "rates printed are not device rates")
    args = ap.parse_args(argv)

    from ti_raytrace_tpu.core.runtime import (device_info, require_gpu,
                                              setup_compile_cache)
    from ti_raytrace_tpu.examples.scenes import example_cached

    setup_compile_cache()
    if not args.cpu:
        require_gpu()
    scene, cfg = example_cached(args.example)
    spec, cam = make_camera(scene, cfg, args.size, args.size)
    compaction = cfg.compaction
    if compaction == "auto":
        from ti_raytrace_tpu.integrators import pt_rgb as _pt

        compaction = _pt.calibrate_compaction(scene, spec, cam)
        print(f"calibrated compaction schedule: {compaction}")
    integ_name = args.integrator or cfg.integrator
    render = get_integrator(integ_name, cfg.sky, compaction, scene, cfg)

    # Multi-frame dispatch for the wavefront PT integrators: several
    # progressive frames per dispatch amortise the per-dispatch host
    # overhead.  Preview mode keeps single-frame dispatches (per-frame
    # window updates + orbit response).
    render_batch = None
    batch_cap = cfg.batch or 8
    frames_by_path = {}  # dispatch path -> frames it rendered
    if integ_name == "pt_rgb":
        from ti_raytrace_tpu.integrators import pt_rgb

        _nee = pt_rgb.has_nee_materials(scene)
        # production path: scenes with a merged group ride
        # render_film_frames_merged — the bench's merged multi-frame
        # dispatch with group-pooled compaction — instead of plain
        # batched frames; odd tails fall back to the plain path.
        _group = cfg.group or 0
        _merged = bool(compaction) and _group > 1
        if _merged and not cfg.batch:
            batch_cap = 64

        def render_batch(fl, n):
            if _merged and n % _group == 0:
                path = "merged"
                fl, _ = pt_rgb.render_film_frames_merged(
                    scene, spec, cam, fl, n_frames=n, group=_group,
                    compaction=compaction, nee=_nee,
                )
            else:
                path = "batched"
                fl, _ = pt_rgb.render_film_frames(
                    scene, spec, cam, fl, n_frames=n, compaction=compaction,
                    nee=_nee,
                )
            frames_by_path[path] = frames_by_path.get(path, 0) + n
            return fl
    elif integ_name == "pt_spec":
        from ti_raytrace_tpu.integrators import pt_spec

        _sdata = pt_spec.make_spectral_data(**(cfg.sky or {}))

        def render_batch(fl, n):
            fl, _ = pt_spec.render_film_frames_spec(
                scene, _sdata, spec, cam, fl, n_frames=n,
                compaction=compaction,
            )
            frames_by_path["spectral"] = frames_by_path.get("spectral", 0) + n
            return fl
    elif integ_name in ("bdpt_rgb", "bdpt_spec"):
        import functools

        import jax
        import jax.numpy as jnp

        # n frames per dispatch save the per-frame host round-trip.
        # Key/frame discipline matches the sequential loop
        # (render(fl.frame, fl.key) then accumulate) bit for bit.
        batch_cap = cfg.batch or 4

        @functools.partial(jax.jit, static_argnames=("n",))
        def _batch(fl, n):
            def body(_, fl):
                rad = render(scene, spec, cam, fl.frame, fl.key)
                return film_mod.accumulate(fl, rad)

            return jax.lax.fori_loop(0, n, body, fl)

        def render_batch(fl, n):
            frames_by_path["bdpt"] = frames_by_path.get("bdpt", 0) + n
            return _batch(fl, n=n)

    fl = film_mod.new_film(args.size, args.size, seed=args.seed)
    if args.checkpoint:
        try:
            fl = film_mod.load_checkpoint(args.checkpoint)
            print(f"resumed at frame {int(fl.frame)}")
        except FileNotFoundError:
            pass

    preview = None
    if args.preview:
        import numpy as np

        from ti_raytrace_tpu.examples.preview import OrbitRig, PygamePreview
        from ti_raytrace_tpu.examples.scenes import framing_params

        rig = OrbitRig(*framing_params(scene, cfg))
        cam = rig.camera()
        preview = PygamePreview(rig, args.size, args.size, cfg.name)

    meter = RenderMeter(spec.width * spec.height)
    while int(fl.frame) < args.frames:
        t0 = time.perf_counter()
        if render_batch is not None and preview is None:
            f0 = int(fl.frame)
            until_snap = args.snapshot_every - (f0 % args.snapshot_every)
            n = max(1, min(batch_cap, args.frames - f0, until_snap))
            fl = render_batch(fl, n)
            fl.hdr.block_until_ready()
            meter.tick(time.perf_counter() - t0, n)
        else:
            radiance = render(scene, spec, cam, fl.frame, fl.key)
            fl = film_mod.accumulate(fl, radiance)
            fl.hdr.block_until_ready()
            meter.tick(time.perf_counter() - t0)
        f = int(fl.frame)
        if preview is not None:
            srgb = film_mod.to_srgb(fl, exposure=cfg.exposure)
            preview.show(np.asarray(srgb * 255.0, dtype=np.uint8))
            preview.set_hud(f, args.frames, meter.fps)
            action = preview.poll()
            if action == "quit":
                break
            if action == "camera":
                # same semantics as the reference's cam_is_dirty reset
                # (Camera.py:70-79): orbit moves restart accumulation
                cam = rig.camera()
                fl = film_mod.new_film(args.size, args.size, seed=args.seed)
                continue
        if f % args.snapshot_every == 0 or f == args.frames:
            film_mod.save_png(fl, args.out, exposure=cfg.exposure)
            if args.checkpoint:
                film_mod.save_checkpoint(fl, args.checkpoint)
            print(f"frame {f}/{args.frames}  {meter.summary()}")

    if preview is not None:
        preview.close()

    film_mod.save_png(fl, args.out, exposure=cfg.exposure)
    report = dict(meter.report(), scene=args.example, size=args.size,
                  merged_group=cfg.group if integ_name == "pt_rgb" else None,
                  frames_by_path=frames_by_path, device=device_info())
    print(json.dumps(report))
    return fl, report


if __name__ == "__main__":
    main()
