"""BDPT strategy decomposition: per-(e, l) contribution analysis.

Instrument for closing the Veach brightness deficit:
renders one scene with PT truncated at successive depths (giving the
exact per-path-depth radiance decomposition of the unidirectional
estimator) and with BDPT restricted to each single (e, l) strategy
(sharing one set of subpaths per frame), then compares per-depth totals:

    PT depth k   <->  sum over { (e, l) : e + l - 2 == k }

A correctly-weighted BDPT must converge to the same per-depth totals
as PT — a per-strategy MIS/weighting bug shows up as a localized
deficit instead of a uniform noise difference.

Run (CPU ok):  JAX_PLATFORMS=cpu \
    python -m ti_raytrace_tpu.tools.bdpt_decompose --scene veach_bdpt \
    --size 48 --frames 8
"""

import argparse
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def pt_depth_decomposition(scene, spec, cam, frames, nee=True, corrected=False):
    """Mean radiance added at each path depth (successive truncations).

    corrected=True uses the TRUE sampler densities (pt_rgb corrected
    mode) so the truth is unbiased — required when decomposing the
    corrected BDPT estimator (the quirk PT's BRDF-sampled diffuse
    transport is ~2/3 low, PARITY.md 'Disney diffuse pdf')."""
    import jax
    import jax.numpy as jnp

    from ti_raytrace_tpu.camera import ray_directions, ray_origins
    from ti_raytrace_tpu.integrators import pt_rgb

    means = []
    for k in range(1, 9):  # BDPT compares depths <= 5 (edges <= 6)
        total = 0.0
        for f in range(frames):
            key = jax.random.PRNGKey(100 + f)
            k_cam, k_path = jax.random.split(key)
            o = jnp.swapaxes(ray_origins(spec, cam), 0, 1)
            d = jnp.swapaxes(ray_directions(spec, cam, jnp.int32(f + 1), k_cam), 0, 1)
            rad = pt_rgb.trace_paths(scene, o, d, k_path, max_depth=k, nee=nee,
                                     corrected=corrected)
            total += float(jnp.mean(rad))
        means.append(total / frames)
        if k >= 8 and abs(means[-1] - means[-2]) < 1e-6:
            break
    per_depth = [means[0]] + [b - a for a, b in zip(means, means[1:])]
    return means[-1], per_depth


def bdpt_strategy_decomposition(scene, spec, cam, frames, corrected=False,
                                spectral=False, unweighted=False):
    """Mean radiance per (e, l) strategy, sharing subpaths per frame.

    spectral=True runs the BDPT_SPEC machinery (single stochastic
    wavelength per lane, SpecCtx) — the instrument for the prism
    deficit: strategy sums convert through the CIE
    sensor exactly as bdpt_spec.render_frame does."""
    import jax
    import jax.numpy as jnp

    from ti_raytrace_tpu.integrators import bdpt_rgb as B

    spec_ctx_fn = None
    if spectral:
        from ti_raytrace_tpu.integrators.bdpt_spec import make_spec_ctx_fn

        spec_ctx_fn = make_spec_ctx_fn()

    N = spec.width * spec.height
    pairs = [
        (e, l)
        for e in range(1, B.EYE_MAX_DEPTH + 1)
        for l in range(0, B.LIGHT_MAX_DEPTH + 1)
        if not ((l == 1 and e == 1) or l + e - 2 < 0 or l + e - 2 > B.MAX_DEPTH)
    ]
    out = {p: 0.0 for p in pairs}
    for f in range(frames):
        key = jax.random.PRNGKey(100 + f)
        k_eye, k_light, k_conn = jax.random.split(key, 3)
        ctx = None
        if spectral:
            k_lam, k_eye = jax.random.split(k_eye)
            ctx = spec_ctx_fn(k_lam, N)
        eye, eye_count = B.build_eye_path(
            scene, spec, cam, jnp.int32(f + 1), k_eye, ctx, corrected=corrected
        )
        light, light_count = B.build_light_path(scene, N, k_light, ctx,
                                                corrected=corrected)
        for (e, l) in pairs:
            radiance, splat = B._connections(
                scene, spec, cam, eye, eye_count, light, light_count, k_conn,
                spec_ctx=ctx,
                strategies=lambda ee, ll, _e=e, _l=l: (ee, ll) == (_e, _l),
                corrected=corrected, unweighted=unweighted,
            )
            if spectral:
                radiance = ctx.to_rgb(radiance)
            # image = radiance (reshaped) + splat, so the image mean is
            # the sum of the two means (both average W*H*3 elements)
            out[(e, l)] += float(jnp.mean(radiance) + jnp.mean(splat))
    return {p: v / frames for p, v in out.items()}


def _diag_box():
    """Quirk-free diagnostic scene: a closed box whose ONE surface
    material has index 0, plus one emitting quad — the reference's
    material-index MIS quirk (_QUIRK_MAT_INDEX, PARITY.md) is inert
    here, and there is no glass, so a correct MIS must make BDPT
    converge to PT."""
    from ti_raytrace_tpu.core import constants as C
    from ti_raytrace_tpu.examples.scenes import ExampleConfig
    from ti_raytrace_tpu.scene.build import MaterialRec, SceneBuilder

    s = 2.0
    # 12 triangles of an inward-facing cube
    corners = np.array(
        [[x, y, z] for x in (-s, s) for y in (-s, s) for z in (-s, s)],
        np.float32,
    )
    quads = [  # inward-facing faces of the cube (corner indices)
        (0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1),
        (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3),
    ]
    tris = []
    for a, b, c, d in quads:
        tris.append([corners[a], corners[b], corners[c]])
        tris.append([corners[a], corners[c], corners[d]])
    pos = np.asarray(tris, np.float32)
    nrm = np.zeros_like(pos)
    uv = np.zeros((pos.shape[0], 3, 2), np.float32)

    bld = SceneBuilder()
    bld.add_triangles(pos, nrm, uv,
                      MaterialRec(C.MAT_DISNEY, color=(0.6, 0.6, 0.6), p0=0.0, p1=0.6))
    # small emitting patch near the ceiling
    e = 0.5
    light = np.asarray(
        [[[-e, s - 0.1, -e], [e, s - 0.1, -e], [e, s - 0.1, e]],
         [[-e, s - 0.1, -e], [e, s - 0.1, e], [-e, s - 0.1, e]]], np.float32)
    bld.add_triangles(light, np.zeros_like(light), np.zeros((2, 3, 2), np.float32),
                      MaterialRec(C.MAT_LIGHT, color=(8.0, 8.0, 8.0)))
    return bld.build(), ExampleConfig("diagbox", "bdpt_rgb", fixed_scale=1.0,
                                      fixed_target=(0.0, 0.0, 0.0))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scene", default="veach_bdpt")
    ap.add_argument("--size", type=int, default=48)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--corrected", action="store_true")
    ap.add_argument("--spectral", action="store_true",
                    help="decompose the BDPT_SPEC machinery (no PT truth)")
    ap.add_argument("--unweighted", action="store_true",
                    help="MIS weight := 1; each strategy alone is then a "
                         "complete estimator of its depths (separates "
                         "contribution bias from weight bias)")
    args = ap.parse_args(argv)

    import jax

    import ti_raytrace_tpu.accel as accel
    if jax.default_backend() == "cpu":
        accel.DENSE_MAX_PRIMS = 10 ** 9  # CPU: dense sweep everywhere

    from ti_raytrace_tpu.examples.scenes import EXAMPLES, make_camera
    from ti_raytrace_tpu.integrators import bdpt_rgb as B

    if args.scene == "diagbox":
        scene, cfg = _diag_box()
    else:
        scene, cfg = EXAMPLES[args.scene]()
    spec, cam = make_camera(scene, cfg, args.size, args.size)

    if args.spectral:
        t0 = time.time()
        strat = bdpt_strategy_decomposition(
            scene, spec, cam, args.frames, corrected=args.corrected,
            spectral=True, unweighted=args.unweighted,
        )
        log(f"BDPT_SPEC decomposition in {time.time()-t0:.0f}s")
        total = sum(strat.values())
        print(f"\n=== {args.scene} {args.size}px x{args.frames} frames "
              f"(SPECTRAL) ===")
        print(f"BDPT_SPEC total mean: {total:.5f}")
        bd_depth = {}
        for (e, l), v in strat.items():
            bd_depth[e + l - 2] = bd_depth.get(e + l - 2, 0.0) + v
        for k in sorted(bd_depth):
            print(f"depth {k} ({k+1} edges): {bd_depth[k]:.6f}")
        print("\n(e, l) strategy means:")
        for (e, l) in sorted(strat):
            print(f"  e={e} l={l} (depth {e+l-2}): {strat[(e, l)]:.6f}")
        return

    t0 = time.time()
    pt_total, _ = pt_depth_decomposition(scene, spec, cam, args.frames,
                                         corrected=args.corrected)
    # per-EDGE truth: with NEE off, PT(max_depth=k) - PT(max_depth=k-1)
    # is exactly the k-edge path total (with NEE the truncation windows
    # of the two sampling techniques overlap and the split is mixed)
    _, pt_edge = pt_depth_decomposition(scene, spec, cam, args.frames,
                                        nee=False, corrected=args.corrected)
    log(f"PT decomposition in {time.time()-t0:.0f}s")
    t0 = time.time()
    strat = bdpt_strategy_decomposition(scene, spec, cam, args.frames,
                                        corrected=args.corrected,
                                        unweighted=args.unweighted)
    log(f"BDPT decomposition in {time.time()-t0:.0f}s")

    bd_depth = {}
    for (e, l), v in strat.items():
        bd_depth[e + l - 2] = bd_depth.get(e + l - 2, 0.0) + v

    print(f"\n=== {args.scene} {args.size}px x{args.frames} frames ===")
    print(f"PT total mean (NEE, depth {15}): {pt_total:.5f}")
    print(f"BDPT total mean: {sum(strat.values()):.5f} "
          f"(ratio {sum(strat.values())/max(pt_total,1e-9):.3f})")
    print("\nedges | PT(noNEE) |     BDPT | ratio   [BDPT depth d == d+1 edges]")
    for k in sorted(bd_depth):
        edges = k + 1
        p = pt_edge[edges - 1] if edges - 1 < len(pt_edge) else 0.0
        b = bd_depth[k]
        print(f"{edges:5d} | {p:9.5f} | {b:8.5f} | "
              f"{b / p if abs(p) > 1e-9 else float('nan'):.3f}")
    print("\n(e, l) strategy means:")
    for (e, l) in sorted(strat):
        print(f"  e={e} l={l} (depth {e+l-2}): {strat[(e, l)]:.6f}")


if __name__ == "__main__":
    main()
