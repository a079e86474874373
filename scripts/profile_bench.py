"""Profile the 100k benchmark frame on the GPU: where does the time go?

    python scripts/profile_bench.py [--trace DIR]

Times, on camera rays and on twice-bounced (incoherent) rays at 512^2:
the coherence sort + per-block cluster order, the cluster kernel alone,
one full bounce, and one compacted frame.  With --trace, also writes a
jax.profiler trace of one frame to DIR (read it with scripts/xplane.py).
Every line is stamped with the card's name and power limit.
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def timeit(fn, n=5):
    fn()  # compile / warm
    best = 1e9
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()

    from ti_raytrace_tpu.core.runtime import (card_name_and_power,
                                              require_gpu, setup_compile_cache)

    setup_compile_cache()
    require_gpu()
    import jax
    import jax.numpy as jnp

    from ti_raytrace_tpu.camera import ray_directions, ray_origins
    from ti_raytrace_tpu.examples.scenes import benchmark_100k
    from ti_raytrace_tpu.integrators import pt_rgb
    from ti_raytrace_tpu.ops import cluster_trace as ct

    import bench

    log(f"device: {jax.devices()[0].device_kind} ({card_name_and_power()})")
    t0 = time.time()
    scene, _ = benchmark_100k()
    log(f"scene build {time.time()-t0:.1f}s prims={scene.n_prims} "
        f"clusters={scene.cluster_bounds.shape[1]}")
    scene, spec, cam, nee = bench.setup(512)
    key = jax.random.PRNGKey(0)
    o = jnp.swapaxes(ray_origins(spec, cam), 0, 1)
    d = jnp.swapaxes(ray_directions(spec, cam, jnp.int32(1), key), 0, 1)
    N = o.shape[1]

    @jax.jit
    def prep(o, d):
        ko, kd = ct._coherence_key(scene, o, d)
        _, _, order = jax.lax.sort((ko, kd, jnp.arange(N, dtype=jnp.int32)),
                                   num_keys=2, is_stable=True)
        rays = jnp.concatenate([o, d, jnp.zeros((2, N), jnp.float32)], 0)
        rays = jnp.take(rays, order, axis=1)
        sb = ct._super_bounds(scene.cluster_bounds)
        cent = rays[0:3].reshape(3, N // ct.TILE, ct.TILE).mean(axis=2).T
        return rays, ct._front_to_back(sb, cent), sb

    block = scene.cluster_tri.shape[1] // scene.cluster_bounds.shape[1]

    def kern(rays, order, sb):
        return ct._run_kernel(rays, order, sb, scene.cluster_bounds,
                              scene.cluster_tri, block, False)

    for label, (oo, dd) in (("camera", (o, d)),):
        rays, order, sb = jax.block_until_ready(prep(oo, dd))
        dt = timeit(lambda: jax.block_until_ready(prep(oo, dd)))
        log(f"{label}: sort + per-block order {dt*1e3:.3f} ms")
        dt = timeit(lambda: jax.block_until_ready(kern(rays, order, sb)))
        log(f"{label}: kernel only {dt*1e3:.3f} ms ({N} rays)")

    bounce = jax.jit(lambda c, k: pt_rgb._bounce(scene, c, k, nee, True))
    carry0 = pt_rgb._new_carry(o, d)
    dt = timeit(lambda: jax.block_until_ready(bounce(carry0, key)), n=3)
    log(f"full bounce {N} (nee={nee}): {dt*1e3:.3f} ms")
    c1 = jax.block_until_ready(bounce(carry0, key))
    c2 = jax.block_until_ready(bounce(c1, jax.random.fold_in(key, 1)))
    log(f"occupancy b1={float(np.asarray(c1['alive']).mean()):.3f} "
        f"b2={float(np.asarray(c2['alive']).mean()):.3f}")
    rays, order, sb = jax.block_until_ready(prep(c2["origin"], c2["direction"]))
    dt = timeit(lambda: jax.block_until_ready(kern(rays, order, sb)))
    log(f"bounced: kernel only, full width {dt*1e3:.3f} ms")

    from ti_raytrace_tpu.examples.scenes import BENCH_SCHEDULE

    fr = jax.jit(lambda k: pt_rgb.render_frame(scene, spec, cam, jnp.int32(1),
                                               k, BENCH_SCHEDULE, nee))
    dt = timeit(lambda: fr(key).block_until_ready(), n=3)
    log(f"render_frame (compaction {BENCH_SCHEDULE}): {dt*1e3:.3f} ms")
    if args.trace:
        with jax.profiler.trace(args.trace):
            fr(key).block_until_ready()
        log(f"trace written to {args.trace}")


if __name__ == "__main__":
    main()
