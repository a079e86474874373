"""Multi-chip rendering: pixel-tile sharding over a device mesh.

Path tracing is embarrassingly parallel per pixel (SURVEY.md §5.8), so the
sharding story is simple and rides ICI exclusively:

  * the scene pytree (geometry, BVH, packs, env map, spectral tables) is
    REPLICATED on every device;
  * the ray wavefront and film are SHARDED along the pixel axis (the lane
    axis of every planar (…, N) tensor);
  * PT needs no cross-device communication at all
    (render_frame_sharded); BDPT's light-tracing splats land on
    arbitrary pixels, so each device accumulates a local
    full-resolution splat film which is `jax.lax.psum`-reduced once per
    frame (render_bdpt_frame_sharded) — the only collective in the
    renderer.

`make_mesh()` builds a 1-D mesh over all local devices; the render
wrappers put the integrators' planar path kernels under `shard_map`.
The key discipline matches bdpt_rgb.render_frame_sliced (shard i ==
lane slice i), so an 8-device frame equals the 8-slice single-device
frame up to splat summation order.
"""

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

AXIS = "pix"


def make_mesh(devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    import numpy as np

    return Mesh(np.asarray(devices), (AXIS,))


def replicate_scene(scene, mesh: Mesh):
    """Place every scene leaf replicated on the mesh."""
    spec = NamedSharding(mesh, P())
    return jax.tree.map(lambda x: jax.device_put(x, spec), scene)


def render_frame_sharded(render_paths_fn, scene, spec, cam, frame, key, mesh: Mesh):
    """One progressive frame over the mesh.

    render_paths_fn(scene, o, d, key) -> (3, N_local) radiance (an
    integrator's planar path kernel, e.g. pt_rgb.trace_paths).

    Rays are generated globally (deterministic per frame) and sharded
    along the wavefront axis; each device traces its pixel shard against
    the replicated scene.  The returned radiance is the full (W, H, 3)
    frame (sharded; converges to host layout on use).
    """
    from ti_raytrace_tpu.camera import ray_directions, ray_origins

    k_cam, k_path = jax.random.split(key)
    o = jnp.swapaxes(ray_origins(spec, cam), 0, 1)
    d = jnp.swapaxes(ray_directions(spec, cam, frame, k_cam), 0, 1)

    scene_specs = jax.tree.map(lambda _: P(), scene)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(scene_specs, P(None, AXIS), P(None, AXIS), P()),
        out_specs=P(None, AXIS),
        check_vma=False,
    )
    def _run(scene_, o_, d_, key_):
        # decorrelate RNG across shards by the device's mesh position
        my = jax.lax.axis_index(AXIS)
        return render_paths_fn(scene_, o_, d_, jax.random.fold_in(key_, my))

    radiance = _run(scene, o, d, k_path)
    return jnp.swapaxes(radiance, 0, 1).reshape(spec.width, spec.height, 3)


def render_frame_spec_sharded(scene, sdata, spec, cam, frame, key,
                              mesh: Mesh, compaction=None, max_depth=None):
    """One hero-wavelength spectral PT frame over the mesh
    (pt_spec.trace_paths_spec per lane shard).

    Same discipline as render_frame_sharded: scene + spectral tables
    replicated, wavefront sharded along lanes, zero collectives (the
    spectral splat is per-pixel).  Per-shard RNG is fold_in(key, shard)
    so hero-lambda draws decorrelate across devices."""
    from ti_raytrace_tpu.camera import ray_directions, ray_origins
    from ti_raytrace_tpu.integrators.pt_spec import trace_paths_spec

    k_cam, k_path = jax.random.split(key)
    o = jnp.swapaxes(ray_origins(spec, cam), 0, 1)
    d = jnp.swapaxes(ray_directions(spec, cam, frame, k_cam), 0, 1)

    scene_specs = jax.tree.map(lambda _: P(), scene)
    sdata_specs = jax.tree.map(lambda _: P(), sdata)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(scene_specs, sdata_specs, P(None, AXIS), P(None, AXIS),
                  P()),
        out_specs=P(None, AXIS),
        check_vma=False,
    )
    def _run(scene_, sdata_, o_, d_, key_):
        my = jax.lax.axis_index(AXIS)
        kw = {} if max_depth is None else {"max_depth": max_depth}
        return trace_paths_spec(scene_, sdata_, o_, d_,
                                jax.random.fold_in(key_, my),
                                compaction=compaction, **kw)

    radiance = _run(scene, sdata, o, d, k_path)
    return jnp.swapaxes(radiance, 0, 1).reshape(spec.width, spec.height, 3)


def render_bdpt_spec_frame_sharded(scene, spec, cam, frame, key, mesh: Mesh,
                                   emitter_scale: float = 1.0,
                                   strategies=None, max_depth=None):
    """One single-wavelength spectral BDPT frame over the mesh
    (bdpt_spec's machinery under shard_map).

    Identical structure to render_bdpt_frame_sharded — eye pixels
    sharded, light splats psum-reduced — with a per-shard SpecCtx drawn
    from fold_in(k_lam, shard) so each device's wavelengths decorrelate.
    The scalar spectral radiance converts to sRGB per shard (to_rgb is
    per-lane)."""
    from ti_raytrace_tpu.camera import ray_directions, ray_origins
    from ti_raytrace_tpu.integrators import bdpt_rgb
    from ti_raytrace_tpu.integrators.bdpt_spec import make_spec_ctx_fn

    if max_depth is None:
        max_depth = bdpt_rgb.MAX_DEPTH
    spec_ctx_fn = make_spec_ctx_fn(emitter_scale)

    k_cam, k_lam, k_eye, k_light, k_conn = jax.random.split(key, 5)
    o = jnp.swapaxes(ray_origins(spec, cam), 0, 1)
    d = jnp.swapaxes(ray_directions(spec, cam, frame, k_cam), 0, 1)

    scene_specs = jax.tree.map(lambda _: P(), scene)
    cam_specs = jax.tree.map(lambda _: P(), cam)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(scene_specs, P(None, AXIS), P(None, AXIS), cam_specs,
                  P(), P(), P(), P()),
        out_specs=(P(None, AXIS), P()),
        check_vma=False,
    )
    def _run(scene_, o_, d_, cam_, klam, ke, kl, kc):
        my = jax.lax.axis_index(AXIS)
        ns = o_.shape[1]
        ctx = spec_ctx_fn(jax.random.fold_in(klam, my), ns)
        eye, eye_count = bdpt_rgb.build_eye_path_rays(
            scene_, o_, d_, jax.random.fold_in(ke, my), ctx,
            eye_depth=max_depth + 2,
        )
        light, light_count = bdpt_rgb.build_light_path(
            scene_, ns, jax.random.fold_in(kl, my), ctx,
            light_depth=max_depth + 1,
        )
        radiance, splat = bdpt_rgb._connections(
            scene_, spec, cam_, eye, eye_count, light, light_count,
            jax.random.fold_in(kc, my), ctx, strategies=strategies,
            max_depth=max_depth,
        )
        radiance = ctx.to_rgb(radiance)
        splat = jax.lax.psum(splat, AXIS)
        return radiance, splat

    radiance, splat = _run(scene, o, d, cam, k_lam, k_eye, k_light, k_conn)
    img = jnp.swapaxes(radiance, 0, 1).reshape(spec.width, spec.height, 3)
    return img + splat


class LaneFilm(NamedTuple):
    """Progressive film in morton LANE space, planar (3, N).

    The production renderer generates camera rays in static morton pixel
    order (pt_rgb.MORTON_CAMERA) and the sharded variant keeps the whole
    pipeline — rays, wavefront, flush, accumulation — in that lane order,
    sharded along the lane axis.  Converting to a raster image needs one
    cross-shard unpermute (`lane_film_image`), which runs once per
    save/display, never per dispatch."""
    hdr: jnp.ndarray    # (3, N) running-mean radiance, lane order
    frame: jnp.ndarray  # () int32
    key: jnp.ndarray    # PRNG key for the next frame


def new_lane_film(spec, mesh: Mesh = None, seed: int = 0) -> LaneFilm:
    n = spec.width * spec.height
    hdr = jnp.zeros((3, n), jnp.float32)
    if mesh is not None:
        hdr = jax.device_put(hdr, NamedSharding(mesh, P(None, AXIS)))
    return LaneFilm(hdr=hdr, frame=jnp.zeros((), jnp.int32),
                    key=jax.random.PRNGKey(seed))


def lane_film_image(fl: LaneFilm, spec) -> jnp.ndarray:
    """Lane-space film -> (W, H, 3) raster image (one global unpermute)."""
    from ti_raytrace_tpu.camera import morton_pixel_order
    from ti_raytrace_tpu.integrators.pt_rgb import _to_raster

    _, inv = morton_pixel_order(spec.width, spec.height)
    img = _to_raster(fl.hdr, jnp.asarray(inv))
    return jnp.swapaxes(img, 0, 1).reshape(spec.width, spec.height, 3)


def _merged_lane_shard(scene, spec, cam, hdr, frame0, key0, shard_idx,
                       px, py, n_frames: int, group: int, compaction,
                       nee: bool, max_depth: int = None):
    """One device's share of a merged multi-frame dispatch: renders the
    morton lane slice (px, py) of every frame in `n_frames`, accumulating
    into the (3, n_local) hdr shard.  Factored out of the shard_map body
    so the equivalence test can run the exact same computation shard by
    shard on one device (the mirror discipline of test_render.py's
    sharded-BDPT proof).

    RNG: the film's global key chain is device-independent (frame/key
    advance exactly as in pt_rgb.render_film_frames_merged); each group's
    render key is fold_in(film_key, shard_idx), so shards draw
    decorrelated camera jitter and path uniforms."""
    from ti_raytrace_tpu import film as film_mod
    from ti_raytrace_tpu.camera import ray_directions_from_pixels
    from ti_raytrace_tpu.integrators import pt_rgb

    ns = px.shape[0]

    def gen_rays(frame, k_cam):
        o = jnp.broadcast_to(cam.eye[:, None], (3, ns))
        d = ray_directions_from_pixels(spec, cam, frame, k_cam, px, py)
        return o, d, True  # contiguous morton slice -> coherent tiles

    def gbody(_, state):
        hdr_, frame_, key_, ov_total = state
        rad_sum, ov = pt_rgb._render_group(
            scene, spec, cam, frame_, jax.random.fold_in(key_, shard_idx),
            group, tuple(compaction), nee,
            max_depth=(max_depth if max_depth is not None
                       else pt_rgb.MAX_DEPTH),
            gen_rays=gen_rays, lane_space=True, n_lanes=ns,
        )
        # accumulate_group on the lane shard (same running-mean algebra)
        f = frame_.astype(jnp.float32)
        hdr_ = (hdr_ * f + rad_sum) / (f + group)
        for _ in range(group):
            key_, _ = jax.random.split(key_)
        return hdr_, frame_ + group, key_, ov_total + ov

    hdr, frame, key, overflow = jax.lax.fori_loop(
        0, n_frames // group, gbody,
        (hdr, frame0, key0, jnp.int32(0)),
    )
    return hdr, frame, key, overflow


@partial(jax.jit,
         static_argnames=("spec", "n_frames", "group", "compaction", "nee",
                          "mesh", "max_depth"),
         donate_argnums=(3,))
def render_film_frames_merged_sharded(scene, spec, cam, fl: LaneFilm,
                                      n_frames: int, group: int,
                                      compaction, nee: bool, mesh: Mesh,
                                      max_depth: int = None):
    """The PRODUCTION render path (merged groups + compaction + morton
    camera, pt_rgb.render_film_frames_merged) over a device mesh.

    Each device renders its contiguous morton lane slice of every frame:
    scene replicated, wavefront/film lane-sharded, zero collectives in
    the loop (path tracing is per-pixel; the only cross-device op is the
    unpermute in lane_film_image at save time).  Compaction runs
    per-device on the local slice — capacity pools across the group's
    frames exactly as on one chip.

    Returns (LaneFilm', overflow_kills_total)."""
    from ti_raytrace_tpu.camera import morton_pixel_order

    import numpy as np

    assert compaction, "merged rendering requires a compaction schedule"
    assert n_frames % group == 0, (n_frames, group)
    W, H = spec.width, spec.height
    perm, _ = morton_pixel_order(W, H)
    px = jnp.asarray((perm // H).astype(np.float32))
    py = jnp.asarray((perm % H).astype(np.float32))

    scene_specs = jax.tree.map(lambda _: P(), scene)
    cam_specs = jax.tree.map(lambda _: P(), cam)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(scene_specs, cam_specs, P(None, AXIS), P(), P(),
                  P(AXIS), P(AXIS)),
        out_specs=(P(None, AXIS), P(), P(), P()),
        check_vma=False,
    )
    def _run(scene_, cam_, hdr_, frame_, key_, px_, py_):
        my = jax.lax.axis_index(AXIS)
        hdr2, frame2, key2, ov = _merged_lane_shard(
            scene_, spec, cam_, hdr_, frame_, key_, my, px_, py_,
            n_frames, group, compaction, nee, max_depth=max_depth,
        )
        # frame/key advance identically on every device; overflow is the
        # global kill count (the estimator-bias telemetry)
        ov = jax.lax.psum(ov, AXIS)
        return hdr2, frame2, key2, ov

    hdr, frame, key, overflow = _run(scene, cam, fl.hdr, fl.frame, fl.key,
                                     px, py)
    return LaneFilm(hdr=hdr, frame=frame, key=key), overflow


def render_bdpt_frame_sharded(scene, spec, cam, frame, key, mesh: Mesh,
                              strategies=None, max_depth=None):
    """One progressive BDPT frame over the mesh.

    Eye pixels are sharded along the wavefront axis; every device walks
    its own eye+light subpaths and connects all (e, l) strategies
    locally.  The e=1 light-tracing strategy splats through the camera
    onto ARBITRARY pixels (reference BDPT_RGB.py:630-633), so each
    device scatters into a local full-resolution splat film and the
    films are `jax.lax.psum`-reduced across the mesh — the one
    collective this renderer needs.  Key discipline matches
    bdpt_rgb.render_frame_sliced with n_slices == mesh size.

    strategies: optional host predicate f(e, l) -> bool restricting the
    compiled strategy families (tests/dryruns: the full ~30-strategy
    graph under shard_map is expensive to partition/compile on the
    8-virtual-device CPU backend).
    """
    from ti_raytrace_tpu.camera import ray_directions, ray_origins
    from ti_raytrace_tpu.integrators import bdpt_rgb

    if max_depth is None:
        max_depth = bdpt_rgb.MAX_DEPTH

    k_cam, k_eye, k_light, k_conn = jax.random.split(key, 4)
    o = jnp.swapaxes(ray_origins(spec, cam), 0, 1)
    d = jnp.swapaxes(ray_directions(spec, cam, frame, k_cam), 0, 1)

    scene_specs = jax.tree.map(lambda _: P(), scene)
    cam_specs = jax.tree.map(lambda _: P(), cam)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(scene_specs, P(None, AXIS), P(None, AXIS), cam_specs,
                  P(), P(), P()),
        out_specs=(P(None, AXIS), P()),
        check_vma=False,
    )
    def _run(scene_, o_, d_, cam_, ke, kl, kc):
        my = jax.lax.axis_index(AXIS)
        ns = o_.shape[1]
        eye, eye_count = bdpt_rgb.build_eye_path_rays(
            scene_, o_, d_, jax.random.fold_in(ke, my),
            eye_depth=max_depth + 2,
        )
        light, light_count = bdpt_rgb.build_light_path(
            scene_, ns, jax.random.fold_in(kl, my),
            light_depth=max_depth + 1,
        )
        radiance, splat = bdpt_rgb._connections(
            scene_, spec, cam_, eye, eye_count, light, light_count,
            jax.random.fold_in(kc, my), strategies=strategies,
            max_depth=max_depth,
        )
        # cross-pixel splats: the only cross-device reduction
        splat = jax.lax.psum(splat, AXIS)
        return radiance, splat

    radiance, splat = _run(scene, o, d, cam, k_eye, k_light, k_conn)
    img = jnp.swapaxes(radiance, 0, 1).reshape(spec.width, spec.height, 3)
    return img + splat
