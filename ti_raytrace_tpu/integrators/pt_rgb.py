"""Wavefront RGB path tracer with next-event estimation and MIS.

The wavefront re-architecture of reference integrator/PT_RGB.py: instead
of a per-pixel megakernel with data-dependent control flow
(PT_RGB.py:45-136), the whole film advances one bounce at a time as a
fixed-shape planar wavefront inside one jitted `lax.while_loop` (which
exits as soon as every path has terminated).  Per-lane alive masks replace
`break`; the three material branches (light / glass / disney) are computed
masked rather than repacked.

Structure (see ops/planar.py, ops/dense_trace.py):
  * all wavefront state is planar (3, N) / (N,) — lanes on the minor axis;
  * hit attributes arrive as packed (A, N) columns from the tracer;
  * environment misses are deferred: each lane records its miss direction
    and weight (a path misses at most once), and a single env-map lookup
    runs after the bounce loop instead of one gather per bounce.

Estimator parity with the reference: same sampling decisions, same MIS
power-heuristic weights, same Beer-Lambert transmission roulette
(PT_RGB.py:117-122), same progressive accumulation.  RNG is counter-based:
frame key -> fold_in(bounce) -> row-split, so renders are deterministic,
resumable, and shard-invariant.
"""

from functools import partial

import jax
import jax.numpy as jnp

from ti_raytrace_tpu.accel import needs_presort, trace, trace_shaded
from ti_raytrace_tpu.bsdf.planar import disney_evaluate_pdf, disney_sample, glass_sample
from ti_raytrace_tpu.camera import CameraSpec, ray_directions, ray_origins
from ti_raytrace_tpu.core import constants as C
from ti_raytrace_tpu.ops import planar as pv
from ti_raytrace_tpu.ops.shading import decode_hit
from ti_raytrace_tpu.scene.sample_planar import sample_li
from ti_raytrace_tpu.utils.colorsp import srgb_to_lrgb
from ti_raytrace_tpu.utils.sampling import power_heuristic

MAX_DEPTH = 15  # reference PT_RGB.py:21
PRESORT_CARRY = False  # see trace_paths
PRESORT_HALF = False  # merged deep phases: presort every SECOND bounce
                      # (odd bounces trace with the stale lane order but
                      # a FRESH per-block front-to-back ordering —
                      # pruning stays exact, only block density decays
                      # one bounce).  Unrolls the phase bounces
                      # statically (no while_loop early exit).  Off: it
                      # lost on the previous accelerator; not yet
                      # measured on the GPU.
PRESORT_MERGED = True  # merged deep phases: sort the packed carry once
                       # per bounce (_sort_carry, ONE (22,N) gather) and
                       # trace with sort_rays=False + tile_order=True +
                       # the planar kernel record — replaces the
                       # per-trace sort + rays gather + unsort.
PACK_ROWS = 22  # rows of the packed carry matrix (_pack_carry)
NEE_FROM_EMITTER_PARITY = False  # see the shadow-ray origin note in
                                 # _shade's NEE block
TRACE0_COMPACT = False  # bounce-0 fast path (_trace0_compact_shade):
                       # off — it lost on the previous accelerator (the
                       # one-step variant overflows because the HIT
                       # fraction exceeds the post-shade alive fraction;
                       # the exact two-step one cost more in sort and
                       # gather than it saved in shading); not yet
                       # measured on the GPU.
                       # trace at full film width, compact to the HIT
                       # lanes at divisor TRACE0_DIV, shade there, then
                       # a second alive-compact (_flush_compact) down to
                       # the schedule's phase-1 width.  Applies when the
                       # compaction schedule starts at bounce 1 and the
                       # wavefront is a pinhole camera.  Per-lane
                       # uniforms ride through the compaction, so
                       # surviving lanes make the same sampling
                       # decisions; the RNG stream of LATER bounces
                       # shifts (lane positions change), which is the
                       # same contract as merged groups.
TRACE0_DIV = 3     # hit-lane width of the shade step: the HIT fraction
                   # exceeds the post-shade alive fraction (some hits
                   # are Beer-killed IN shade), so shading at the
                   # phase-1 width overflows
TRACE0_PAY_DIV = 16  # payload-tail capacity of the post-shade compact
                     # (emitter-hit radiance; misses were banked at full
                     # width before the shade compact)
MORTON_CAMERA = True  # generate camera rays in static morton pixel
                      # order (camera.morton_pixel_order) so bounce 0
                      # runs with sort_rays=False: no coherence sort and
                      # no sort/unsort gathers; the film accumulates in
                      # lane space with ONE unpermute gather per frame
                      # group.


def _pack_carry(carry):
    """Carry dict -> ONE planar (22, N) f32 matrix (int/bool rows ride
    along bitcast to f32) so a permutation costs ONE gather instead of
    ten."""
    return jnp.concatenate(
        [
            carry["origin"],                                   # 0:3
            carry["direction"],                                # 3:6
            carry["throughput"],                               # 6:9
            carry["radiance"],                                 # 9:12
            carry["miss_dir"],                                 # 12:15
            carry["miss_weight"],                              # 15:18
            carry["alive"].astype(jnp.float32)[None],          # 18
            carry["brdf_pdf"][None],                           # 19
            carry["perfect_spec"].astype(jnp.float32)[None],   # 20
            jax.lax.bitcast_convert_type(
                carry["pixel"], jnp.float32
            )[None],                                           # 21
        ],
        axis=0,
    )


def _unpack_carry(m):
    return dict(
        origin=m[0:3],
        direction=m[3:6],
        throughput=m[6:9],
        radiance=m[9:12],
        miss_dir=m[12:15],
        miss_weight=m[15:18],
        alive=m[18] > 0.5,
        brdf_pdf=m[19],
        perfect_spec=m[20] > 0.5,
        pixel=jax.lax.bitcast_convert_type(m[21], jnp.int32),
    )


def _sort_carry(scene, carry):
    """Permute the whole wavefront carry into (alive-first, morton) order.

    Sorting the carry once per bounce is the cluster tracer's coherence
    restoration: the trace then runs with sort_rays=False, saving the
    per-trace ray sort + the (N, 48) hit-record unsort gather.  Radiance
    is scattered back to pixels by the carry's pixel ids at flush time."""
    from ti_raytrace_tpu.ops.cluster_trace import _coherence_key

    N = carry["alive"].shape[0]
    key_o, key_d = _coherence_key(scene, carry["origin"], carry["direction"])
    dead_first = jnp.where(carry["alive"], jnp.uint32(0), jnp.uint32(1))
    idx = jnp.arange(N, dtype=jnp.int32)
    _, _, _, order = jax.lax.sort(
        (dead_first, key_o, key_d, idx), num_keys=3, is_stable=True
    )

    mat = _pack_carry(carry)
    # permute along the MAJOR axis: transpose + row gather + transpose
    m = jnp.take(jnp.swapaxes(mat, 0, 1), order, axis=0)
    m = jnp.swapaxes(m, 0, 1)
    return _unpack_carry(m)


def _bounce(scene, carry, key, nee: bool = True, presort: bool = False,
            corrected: bool = False, shared_origin=None,
            coherent: bool = False, stale_order: bool = False):
    if presort:
        carry = _sort_carry(scene, carry)
    o = carry["origin"]
    d = carry["direction"]
    N = o.shape[1]

    u = jax.random.uniform(key, (8, N), dtype=jnp.float32)

    # coherent=True: the wavefront is already in a spatially coherent
    # lane order (static morton camera generation) — skip the tracer's
    # sort/unsort; shared_origin keeps the front-to-back cluster order.
    # stale_order=True: the carry was presorted a bounce ago — skip the
    # re-sort but keep the per-tile front-to-back ordering (recomputed
    # from the CURRENT origins, so pruning stays exact).
    t, prim, uv_bary, attr = trace_shaded(
        scene, o, d,
        sort_rays=not presort and not coherent and not stale_order,
        sort_small=True,
        shared_origin=shared_origin,
        tile_order=presort or stale_order,
    )
    return _shade(scene, carry, u, t, prim, uv_bary, attr, nee, corrected)


def _shade(scene, carry, u, t, prim, uv_bary, attr, nee: bool = True,
           corrected: bool = False):
    """The post-trace half of _bounce: per-lane shading, NEE, sampling
    and carry update from a hit record.  Factored out so the bounce-0
    fast path can trace at full film width but shade only the compacted
    hit lanes (_trace0_compact_shade)."""
    o = carry["origin"]
    d = carry["direction"]
    alive = carry["alive"]

    u_nee = u[0:3]
    u_bsdf = u[3:6]
    u_rr = u[6]

    hit = decode_hit(o, d, t, prim, uv_bary, attr)
    valid = hit.valid & alive
    fnormal = pv.faceforward(hit.normal, -d, hit.gnormal)
    reflect_color = srgb_to_lrgb(hit.mat_color)

    throughput = carry["throughput"]
    radiance = carry["radiance"]
    brdf_pdf_prev = carry["brdf_pdf"]
    perfect_spec = carry["perfect_spec"]

    # ---- miss: defer the env lookup; record direction + weight --------
    miss = alive & ~hit.valid
    carry_miss_dir = pv.where(miss, d, carry["miss_dir"])
    carry_miss_w = jnp.where(miss[None], throughput, carry["miss_weight"])

    # ---- emitter hit: MIS-weighted terminate (PT_RGB.py:72-81) --------
    is_light = valid & (hit.mat_type == C.MAT_LIGHT)
    fcos = jnp.abs(pv.dot(d, hit.gnormal))
    area = hit.area * scene.n_lights
    light_pdf_hit = (t * t) / jnp.maximum(area * fcos, 1e-12)
    if nee:
        mis_w = jnp.where(
            perfect_spec, 1.0, power_heuristic(brdf_pdf_prev, light_pdf_hit)
        )
    else:
        # without NEE there is no competing light-sampling technique:
        # emitter hits must count in full or energy is silently lost
        mis_w = jnp.ones_like(light_pdf_hit)
    radiance = radiance + jnp.where(
        is_light[None], mis_w[None] * throughput * hit.mat_color, 0.0
    )

    # ---- glass lanes (PT_RGB.py:89-92) --------------------------------
    is_glass = valid & (hit.mat_type == C.MAT_GLASS)
    g_dir, g_forb = glass_sample(u_bsdf[0], d, hit.normal, hit.mat_p0)

    # ---- disney lanes: NEE + continuation (PT_RGB.py:94-114) ----------
    is_disney = valid & (hit.mat_type != C.MAT_GLASS) & (hit.mat_type != C.MAT_LIGHT)
    if nee:
        ls = sample_li(scene, hit.pos, u_nee)
        ndl_surf = pv.dot(fnormal, ls["direction"])
        ndl_light = pv.dot(ls["normal"], ls["direction"])
        nee_geo_ok = is_disney & (ndl_surf < 0.0) & (ndl_light > 0.0)
        # park shadow rays of non-disney lanes far outside the scene:
        # their tiles then fail every cluster test and cost nothing (the
        # dense tracer ignores parking; the cluster tracer exploits it).
        #
        # NEE_FROM_EMITTER_PARITY: the reference starts its shadow ray
        # EXACTLY on the sampled emitter (PT_RGB.py:104 closet_hit_shadow
        # from light_pos) and takes any hit with t > 0 — for non-axis-
        # aligned lamps the self-intersection lands at t ~ +-1e-7 and a
        # positive sign reads as full occlusion, silently dropping part
        # of that lamp's NEE.  Axis-aligned lights (cornell) produce an
        # exact t = 0 and are unaffected.  The published veach golden
        # embodies SOME of this loss: at 512 frames our offset variant
        # converges 3.5% BRIGHT (ratio 1.035, mad 0.051), the on-emitter
        # variant 5.8% DARK (0.942, mad 0.061) — our fp drops more than
        # the reference's does, and the artifact depends on private fp
        # noise, so it is not replicable in principle (measured both
        # ways).  The UNBIASED offset variant is
        # the default: it is also the closer of the two brackets.
        sh_from = (ls["pos"] if NEE_FROM_EMITTER_PARITY
                   else pv.offset_ray(ls["pos"], ls["normal"]))
        sh_o = pv.where(is_disney, sh_from, jnp.full_like(ls["pos"], 1e9))
        _, sh_prim = trace(scene, sh_o, ls["direction"], sort_small=True)
        unoccluded = sh_prim == prim
        nee_brdf, nee_pdf = disney_evaluate_pdf(
            fnormal, -d, -ls["direction"], hit.mat_p0, hit.mat_p1,
            true_pdf=corrected,
        )
        light_pdf = (
            ls["dist"] * ls["dist"] * ls["choice_pdf"] / jnp.maximum(ndl_light, 1e-12)
        )
        nee_ok = nee_geo_ok & unoccluded & (nee_pdf > 0.0)
        nee_w = (
            power_heuristic(light_pdf, nee_pdf)
            / jnp.maximum(light_pdf, 1e-4)
            * nee_brdf
            * jnp.abs(ndl_surf)
        )
        radiance = radiance + jnp.where(
            nee_ok[None], nee_w[None] * ls["emission"] * throughput * reflect_color, 0.0
        )

    d_dir = disney_sample(u_bsdf, d, fnormal, hit.mat_p0, hit.mat_p1)
    d_brdf, d_pdf = disney_evaluate_pdf(fnormal, -d, d_dir, hit.mat_p0, hit.mat_p1,
                                        true_pdf=corrected)
    d_brdf = d_brdf * jnp.abs(pv.dot(hit.normal, d_dir))

    # ---- merge branches ----------------------------------------------
    next_dir = pv.where(is_glass, g_dir, d_dir)
    f_or_b = jnp.where(is_glass, g_forb, 1.0)
    brdf = jnp.where(is_glass, 1.0, d_brdf)
    brdf_pdf = jnp.where(is_glass, 1.0, d_pdf)
    new_perfect_spec = jnp.where(is_glass, True, jnp.where(is_disney, False, perfect_spec))

    next_origin = pv.offset_ray(hit.pos, fnormal * pv.sign_nonzero(f_or_b)[None])

    # Beer-Lambert transmission roulette (PT_RGB.py:117-122)
    transmitted = f_or_b < 0.0
    beer_r = jnp.exp(-t / jnp.maximum(hit.mat_p1, 1e-12))
    beer_kill = transmitted & (u_rr >= beer_r)

    cont = (is_glass | is_disney) & (brdf_pdf > 0.0) & ~beer_kill
    throughput = jnp.where(
        cont[None],
        throughput * (brdf / jnp.maximum(brdf_pdf, 1e-12))[None] * reflect_color,
        throughput,
    )

    return dict(
        # terminated lanes get parked far away -> all-dead ray tiles
        # short-circuit in the cluster tracer
        origin=pv.where(cont, next_origin, jnp.full_like(o, 1e9)),
        direction=pv.where(cont, next_dir, d),
        throughput=throughput,
        radiance=radiance,
        alive=cont,
        brdf_pdf=jnp.where(cont, brdf_pdf, brdf_pdf_prev),
        perfect_spec=jnp.where(cont, new_perfect_spec, perfect_spec),
        miss_dir=carry_miss_dir,
        miss_weight=carry_miss_w,
        pixel=carry["pixel"],
    )


def _env_radiance(scene, d):
    """Equirect environment lookup (PT_RGB.py:127-131), planar dirs.

    The bilinear fetch goes through a 2x2-block texture built in-graph
    (concats) so the lookup is ONE gather instead of four."""
    from ti_raytrace_tpu.texture.texture import texture2d_packed

    if scene.env_img.shape[0] == 1 and scene.env_img.shape[1] == 1:
        # constant env (black when env_power == 0): no gather at all
        texel = srgb_to_lrgb(scene.env_img[0, 0])
        return texel[:, None] * scene.env_power

    t = scene.env_img
    xp = jnp.concatenate([t[:, 1:], t[:, -1:]], 1)
    yp = jnp.concatenate([t[1:], t[-1:]], 0)
    xyp = jnp.concatenate([yp[:, 1:], yp[:, -1:]], 1)
    blocks = jnp.concatenate([t, xp, yp, xyp], 2)

    dis = jnp.sqrt(d[0] * d[0] + d[2] * d[2])
    tx = (jnp.arctan2(d[2], d[0]) + C.PI) / C.TWO_PI
    ty = jnp.arctan2(d[1], dis) / C.PI + 0.5
    rgb = texture2d_packed(blocks, tx, ty)  # (N, 3)
    return jnp.swapaxes(srgb_to_lrgb(rgb), 0, 1) * scene.env_power


def _camera_rays(spec, cam, frame, k_cam):
    """Full-film camera wavefront, planar (3, N): (o, d, inv_perm).

    Under MORTON_CAMERA the lanes are in static Z-order (lane n = pixel
    morton_pixel_order(W, H)[0][n]) and inv_perm maps raster pixel ->
    lane for the final unpermute; otherwise raster order and None."""
    from ti_raytrace_tpu.camera import (morton_pixel_order, ray_directions,
                                        ray_directions_morton, ray_origins)

    o = jnp.swapaxes(ray_origins(spec, cam), 0, 1)
    if MORTON_CAMERA:
        d = ray_directions_morton(spec, cam, frame, k_cam)  # planar (3, N)
        _, inv = morton_pixel_order(spec.width, spec.height)
        return o, d, jnp.asarray(inv)
    d = jnp.swapaxes(ray_directions(spec, cam, frame, k_cam), 0, 1)
    return o, d, None


def _to_raster(radiance, inv_perm):
    """Lane-space (3, N) radiance -> raster pixel order (one sublane-axis
    gather via the transpose trick; no-op for raster-ordered lanes)."""
    if inv_perm is None:
        return radiance
    r = jnp.take(jnp.swapaxes(radiance, 0, 1), inv_perm, axis=0)
    return jnp.swapaxes(r, 0, 1)


def _new_carry(o, d):
    N = o.shape[1]
    return dict(
        origin=o,
        direction=d,
        throughput=jnp.ones((3, N), jnp.float32),
        radiance=jnp.zeros((3, N), jnp.float32),
        alive=jnp.ones((N,), bool),
        brdf_pdf=jnp.ones((N,), jnp.float32),
        perfect_spec=jnp.ones((N,), bool),  # camera rays count as specular
        miss_dir=jnp.zeros((3, N), jnp.float32),
        miss_weight=jnp.zeros((3, N), jnp.float32),
        pixel=jnp.arange(N, dtype=jnp.int32),
    )


def _flush(carry, accum, identity: bool = False, scene=None):
    """Bank the carry's accumulated radiance / pending env misses into
    the full-resolution accum pair (radiance (3, N), miss (6, N) =
    [miss_dir | miss_w]) by pixel id, and clear them in the carry.

    identity=True (static): the carry has never been compacted, so
    carry['pixel'] is exactly arange(N) — the flush degenerates to
    plain adds.  XLA cannot infer this (the ids are loop-carried).

    scene given (deep flushes): the pending env misses are RESOLVED
    here — one env gather over the compacted carry (a few % of the
    film) folds them into radiance, so the scatter writes the 3
    radiance rows only.  The radiance and miss accums are SEPARATE
    arrays because a scatter into a row-slice of one (9, N) buffer
    lowers to a windowed scatter.  Only the prologue's identity
    adds populate the miss rows, so the final env pass covers exactly
    the camera-ray misses."""
    rad, miss = accum
    pix = carry["pixel"]
    has_miss = jnp.any(carry["miss_weight"] != 0.0, axis=0)
    if scene is not None and not identity:
        env = _env_radiance(scene, carry["miss_dir"])
        radiance = carry["radiance"] + jnp.where(
            has_miss[None], env * carry["miss_weight"], 0.0
        )
        rad = rad.at[:, pix].add(radiance)
    else:
        miss_d = jnp.where(has_miss[None], carry["miss_dir"], 0.0)
        miss_w = jnp.where(has_miss[None], carry["miss_weight"], 0.0)
        # a lane misses at most once (terminal), so a masked add is an
        # exact merge into the full-resolution pending-miss rows
        payload = jnp.concatenate([miss_d, miss_w], 0)
        if identity:
            rad = rad + carry["radiance"]
            miss = miss + payload
        else:
            rad = rad.at[:, pix].add(carry["radiance"])
            miss = miss.at[:, pix].add(payload)
    carry = dict(carry)
    carry["radiance"] = jnp.zeros_like(carry["radiance"])
    carry["miss_dir"] = jnp.zeros_like(carry["miss_dir"])
    carry["miss_weight"] = jnp.zeros_like(carry["miss_weight"])
    return carry, (rad, miss)


def _new_accum(n):
    """Full-resolution flush buffers (radiance (3,n), [miss_dir|miss_w]
    (6,n))."""
    return jnp.zeros((3, n), jnp.float32), jnp.zeros((6, n), jnp.float32)


def _phase_width(n: int, dv: int) -> int:
    """Compacted-phase width: n/dv with a 1024-lane floor (tiny widths
    under-fill even one kernel tile), clamped to n (lane SHARDS of the
    multi-device path can be smaller than the floor)."""
    return min(n, max(1024, n // dv))


def _compact(carry, new_n: int):
    """Shrink the wavefront to its live lanes (alive-first stable sort +
    static slice).  Capacity overflow (more live lanes than new_n) kills
    the excess paths — widths are chosen with ~4-8x headroom over typical
    occupancy, so this is a rare depth cut, not an estimator change.
    Returns (compacted_carry, n_overflow) so overflow is observable
    (a silent kill would be a silent bias regression)."""
    N = carry["alive"].shape[0]
    n_alive = jnp.sum(carry["alive"].astype(jnp.int32))
    overflow = jnp.maximum(n_alive - new_n, 0)
    key = jnp.where(carry["alive"], jnp.uint32(0), jnp.uint32(1))
    idx = jnp.arange(N, dtype=jnp.int32)
    _, order = jax.lax.sort((key, idx), num_keys=1, is_stable=True)
    sel = order[:new_n]

    # one packed gather instead of one take per carry array (see
    # _pack_carry); the per-op gather cost dominated phase transitions
    m = jnp.take(jnp.swapaxes(_pack_carry(carry), 0, 1), sel, axis=0)
    return _unpack_carry(jnp.swapaxes(m, 0, 1)), overflow


def _trace0_compact_shade(scene, o, d, key0, w_shade: int, nee: bool,
                          corrected: bool, coherent: bool):
    """Bounce 0 fast path: trace at full film width, SHADE at the
    compacted width w_shade.  Only ~26% of the bench camera rays hit
    anything, yet the shade half of _bounce (attr decode + BSDF
    branches + NEE) runs at full width in the plain prologue.  Here the
    wavefront is compacted to its HIT lanes (a superset of the
    post-shade alive set — Beer roulette and emitterless termination
    happen IN shade) between trace and shade; the per-lane uniforms
    ride through the pack so every surviving lane makes the same
    sampling decisions as the uncompacted bounce (extra gather rows are
    nearly free — gathers pay per OP).  Callers follow with a
    _flush_compact down to the schedule's phase-1 width.

    Returns (shaded carry at width w_shade, accum at full width with
    the miss payload identity-banked, overflow = kept hits beyond
    w_shade)."""
    N = o.shape[1]
    u = jax.random.uniform(key0, (8, N), dtype=jnp.float32)
    t, prim, uv_bary, attr = trace_shaded(
        scene, o, d, sort_rays=not coherent, sort_small=True,
        shared_origin=o[:, 0], tile_order=False,
    )
    valid = (t < C.INF) & (prim >= 0)

    # identity-flush the miss payload (bounce-0 throughput == 1)
    miss_payload = jnp.where(
        valid[None], 0.0,
        jnp.concatenate([d, jnp.ones((3, N), jnp.float32)], 0),
    )
    # emitter hits terminate AND resolve at full width: camera rays are
    # perfect-specular so their MIS weight is exactly 1 and the banked
    # radiance is just the raw emission color (attr rows 18/19:22,
    # ops/shading.decode_hit) — excluding them from the compact matters
    # because the bench's HIT fraction (sphere light included) exceeds
    # the post-shade alive fraction the phase-1 width was provisioned
    # for (compact-on-hit killed paths at divisor 4)
    is_light_hit = valid & (attr[18].astype(jnp.int32) == C.MAT_LIGHT)
    rad_payload = jnp.where(is_light_hit[None], attr[19:22], 0.0)
    accum = (rad_payload, miss_payload)

    keep = valid & ~is_light_hit
    n_keep = jnp.sum(keep.astype(jnp.int32))
    overflow = jnp.maximum(n_keep - w_shade, 0)
    key_m = jnp.where(keep, jnp.uint32(0), jnp.uint32(1))
    idx = jnp.arange(N, dtype=jnp.int32)
    _, order = jax.lax.sort((key_m, idx), num_keys=1, is_stable=True)
    sel = order[:w_shade]

    A = attr.shape[0]
    rows = jnp.concatenate(
        [
            o, d, u, t[None],
            jax.lax.bitcast_convert_type(prim, jnp.float32)[None],
            uv_bary, attr,
            jax.lax.bitcast_convert_type(idx, jnp.float32)[None],
        ],
        axis=0,
    )
    m = jnp.swapaxes(
        jnp.take(jnp.swapaxes(rows, 0, 1), sel, axis=0), 0, 1
    )
    o_c, d_c, u_c = m[0:3], m[3:6], m[6:14]
    t_c = m[14]
    prim_c = jax.lax.bitcast_convert_type(m[15], jnp.int32)
    uv_c = m[16:18]
    attr_c = m[18:18 + A]
    pix_c = jax.lax.bitcast_convert_type(m[18 + A], jnp.int32)

    carry = _new_carry(o_c, d_c)
    # alive excludes emitter hits — their radiance was already banked at
    # full width above; letting _shade see them alive would double-count
    carry["alive"] = ((t_c < C.INF) & (prim_c >= 0)
                      & (attr_c[18].astype(jnp.int32) != C.MAT_LIGHT))
    carry["pixel"] = pix_c
    return (
        _shade(scene, carry, u_c, t_c, prim_c, uv_c, attr_c, nee, corrected),
        accum,
        overflow,
    )


def _flush_compact(scene, carry, accum, new_n: int, pay_cap: int):
    """Fused deep-phase flush + compact: ONE 3-way stable sort
    (alive < dead-with-payload < dead-empty) and ONE packed gather of
    the top new_n + pay_cap lanes replace _flush's full-width scatter +
    _compact's separate sort/gather.  Only the pay_cap-lane tail is
    scattered into the accum (env-folding its pending misses); the
    phase-boundary scatter cost drops from carry-width indices to
    pay_cap (a scatter-add costs per index).

    Dead lanes that fit inside the new carry keep riding with their
    banked-later payload (they are parked at 1e9, so their tiles cost
    nothing); dead-empty lanes beyond the tail drop freely.  Exactness:
    every lane lands in exactly one of {carry, scattered tail, empty},
    and the overflow count now ALSO covers payload lanes pushed off the
    tail (pay_cap must keep headroom over the phase's dead-with-payload
    occupancy, like the width schedule itself)."""
    rad, miss_acc = accum
    N = carry["alive"].shape[0]
    alive = carry["alive"]
    has_pay = (
        jnp.any(carry["radiance"] != 0.0, axis=0)
        | jnp.any(carry["miss_weight"] != 0.0, axis=0)
    )
    key3 = jnp.where(
        alive, jnp.uint32(0), jnp.where(has_pay, jnp.uint32(1), jnp.uint32(2))
    )
    idx = jnp.arange(N, dtype=jnp.int32)
    _, order = jax.lax.sort((key3, idx), num_keys=1, is_stable=True)
    sel = order[: new_n + pay_cap]
    m = jnp.take(jnp.swapaxes(_pack_carry(carry), 0, 1), sel, axis=0)
    m = jnp.swapaxes(m, 0, 1)
    new_carry = _unpack_carry(m[:, :new_n])
    tail = _unpack_carry(m[:, new_n:])

    has_miss = jnp.any(tail["miss_weight"] != 0.0, axis=0)
    env = _env_radiance(scene, tail["miss_dir"])
    radiance = tail["radiance"] + jnp.where(
        has_miss[None], env * tail["miss_weight"], 0.0
    )
    rad = rad.at[:, tail["pixel"]].add(radiance)

    n_alive = jnp.sum(alive.astype(jnp.int32))
    n_pay = jnp.sum((~alive & has_pay).astype(jnp.int32))
    overflow = jnp.maximum(n_alive - new_n, 0) + jnp.maximum(
        n_alive + n_pay - (new_n + pay_cap), 0
    )
    return new_carry, (rad, miss_acc), overflow


def calibrate_compaction(scene, spec, cam, key=None, probe_size: int = 128,
                         margin: float = 4.0, max_depth: int = MAX_DEPTH):
    """Derive a safe compaction schedule from one probe frame.

    Renders a small probe wavefront bounce by bounce (host loop), records
    the live-lane fraction after each bounce, and returns a
    ((start_bounce, divisor), ...) schedule whose widths keep `margin`x
    headroom over the measured occupancy.  Returns None when the scene
    keeps high occupancy (e.g. closed diffuse boxes) — compaction would
    not pay there.
    """
    import numpy as np

    from ti_raytrace_tpu.camera import CameraSpec as _Spec

    key = key if key is not None else jax.random.PRNGKey(0)
    pspec = _Spec(probe_size, probe_size, focal=spec.focal)
    k_cam, k_path = jax.random.split(key)
    o = jnp.swapaxes(ray_origins(pspec, cam), 0, 1)
    d = jnp.swapaxes(ray_directions(pspec, cam, jnp.int32(1), k_cam), 0, 1)
    nee = has_nee_materials(scene)
    presort = PRESORT_CARRY and needs_presort(scene)
    bounce = jax.jit(lambda c, k: _bounce(scene, c, k, nee, presort))
    carry = _new_carry(o, d)
    frac = []
    for depth in range(max_depth):
        carry = bounce(carry, jax.random.fold_in(k_path, depth))
        frac.append(float(np.asarray(carry["alive"]).mean()))
        if frac[-1] == 0.0:
            break

    schedule = []
    div_prev = 1
    for depth, f in enumerate(frac):
        # largest power-of-two width divisor keeping margin x headroom;
        # each new phase costs one extra compiled wavefront size
        div = 1
        while div < 64 and f * margin <= 1.0 / (2 * div):
            div *= 2
        if div >= 2 * div_prev:
            schedule.append((depth + 1, div))
            div_prev = div
    return tuple(schedule) if schedule else None


def has_nee_materials(scene) -> bool:
    """Host-side check: does any material take the NEE branch?  Scenes of
    only glass + emitters (the 100k benchmark) contribute exactly zero via
    NEE, so the shadow pass can be compiled out (`nee=False`)."""
    import numpy as np

    mt = np.asarray(scene.mat_type)
    return bool(((mt != C.MAT_GLASS) & (mt != C.MAT_LIGHT)).any())


def _while_bounces(scene, carry, key, depth0, b1, nee: bool,
                   presort: bool = False, corrected: bool = False):
    """Run bounces [depth0, b1) in a while_loop with the carry PACKED as
    the (PACK_ROWS, N) f32 matrix.

    A dict carry puts pred/int arrays on the loop boundary, where XLA
    may materialize each with a layout copy per iteration.  The packed
    f32 matrix crosses the boundary copy-free; pack/unpack are
    slices/concats that fuse into the bounce body.  Bit-identical:
    bool->f32->bool and the pixel bitcast are exact."""

    def cond(state):
        depth, m = state
        return (depth < b1) & (jnp.max(m[18]) > 0.5)  # row 18 == alive

    def body(state):
        depth, m = state
        c = _bounce(scene, _unpack_carry(m), jax.random.fold_in(key, depth),
                    nee, presort, corrected)
        return depth + 1, _pack_carry(c)

    _, m = jax.lax.while_loop(
        cond, body, (jnp.asarray(depth0, jnp.int32), _pack_carry(carry))
    )
    return _unpack_carry(m)


def trace_paths(scene, o, d, key, max_depth: int = MAX_DEPTH,
                compaction=None, nee: bool = True, return_overflow: bool = False,
                corrected: bool = False, camera_origin=None,
                coherent_camera: bool = False):
    """Full path-trace of a planar wavefront: (3,N) rays -> (3,N) radiance.

    corrected=True divides BRDF-sampled bounces by the sampler's TRUE
    density (diffuse cos/pi) instead of the reference's claimed 1/pi
    (PARITY.md 'Disney diffuse pdf') — the unbiased-estimator mode used
    as ground truth by the corrected-BDPT convergence test.

    compaction: ((start_bounce, shrink_divisor), ...) — after
    `start_bounce` bounces the wavefront is compacted to N/divisor live
    lanes.  Late bounces otherwise cost as much as full ones (every pass
    is fixed-shape), so scenes whose paths terminate early (glass with
    Beer roulette, open scenes) gain 3-5x.  Capacity overflow cuts the
    excess paths, so the schedule must leave headroom over the scene's
    real occupancy — it is per-scene opt-in (None = exact, default).

    return_overflow=True additionally returns the number of live paths
    killed by compaction capacity (int32 scalar; 0 == exact estimator).
    """
    compaction = compaction or ()
    # Carry presorting (sort the whole wavefront once per bounce, trace
    # unsorted) lost to the tracer's internal sort+unsort on the
    # previous accelerator; off until measured on the GPU.
    presort = PRESORT_CARRY and needs_presort(scene)

    # Bounce 0 of a pinhole-camera wavefront is peeled out of the while
    # loop: its rays share ONE origin, so the cluster tracer can use a
    # single shared front-to-back order (no per-block argsort).  RNG discipline is unchanged
    # (fold_in(key, 0) for bounce 0, loop continues at depth 1).
    def _start(ca):
        if camera_origin is not None and not presort:
            ca = _bounce(scene, ca, jax.random.fold_in(key, 0), nee, presort,
                         corrected, shared_origin=camera_origin,
                         coherent=coherent_camera)
            return jnp.int32(1), ca
        return jnp.int32(0), ca

    if not compaction:
        # exact single-phase path: one pixel scatter at the very end
        depth0, carry = _start(_new_carry(o, d))
        carry = _while_bounces(scene, carry, key, depth0, max_depth, nee,
                               presort, corrected)
        missed = jnp.any(carry["miss_weight"] != 0.0, axis=0)
        env = _env_radiance(scene, carry["miss_dir"])
        radiance = carry["radiance"] + jnp.where(
            missed[None], env * carry["miss_weight"], 0.0
        )
        if presort:
            radiance = jnp.zeros_like(radiance).at[:, carry["pixel"]].set(radiance)
        if return_overflow:
            return radiance, jnp.int32(0)
        return radiance
    N = o.shape[1]
    # static phase schedule: (start, end, width)
    starts = [0] + [s for s, _ in compaction]
    ends = [s for s, _ in compaction] + [max_depth]
    widths = [N] + [_phase_width(N, dv) for _, dv in compaction]

    # bounce-0 fast path (see _trace0_compact_shade): only when the
    # schedule compacts right after bounce 0 and the wavefront is a
    # pinhole camera — mirrors _render_group's prologue so merged
    # group=1 stays equivalent to this sequential loop
    fast0 = (TRACE0_COMPACT and camera_origin is not None and not presort
             and compaction[0][0] == 1 and max_depth >= 1)
    if fast0:
        carry, accum_full, overflow = _trace0_compact_shade(
            scene, o, d, jax.random.fold_in(key, 0),
            _phase_width(N, TRACE0_DIV), nee, corrected, coherent_camera,
        )
        carry, accum_full, ov2 = _flush_compact(
            scene, carry, accum_full, widths[1],
            _phase_width(N, TRACE0_PAY_DIV),
        )
        overflow = overflow + ov2
    else:
        carry = _new_carry(o, d)
        accum_full = _new_accum(N)
        overflow = jnp.int32(0)

    for phase, (b0, b1, width) in enumerate(zip(starts, ends, widths)):
        if b0 >= max_depth:
            break
        b1 = min(b1, max_depth)
        if fast0 and phase == 0:
            continue  # bounce 0 already traced+shaded by the fast path
        if phase > 0 and not (fast0 and phase == 1):
            carry, accum_full = _flush(
                carry, accum_full,
                identity=(phase == 1),  # never compacted yet: pixel==arange
                scene=scene,
            )
            carry, ov = _compact(carry, width)
            overflow = overflow + ov

        depth0, carry = _start(carry) if phase == 0 else (jnp.int32(b0), carry)
        # compacted deep phases presort the carry (see PRESORT_MERGED);
        # phase 0 keeps the tracer-internal sort — this matches
        # _render_group bounce for bounce, so merged group=1 stays
        # bit-identical to this sequential loop
        deep_presort = presort or (
            phase > 0 and PRESORT_MERGED and needs_presort(scene)
        )
        carry = _while_bounces(scene, carry, key, depth0, b1, nee,
                               deep_presort, corrected)

    carry, accum_full = _flush(carry, accum_full, scene=scene)
    radiance_full, acc_miss = accum_full
    miss_dir_full = acc_miss[0:3]
    miss_w_full = acc_miss[3:6]

    # one deferred environment pass for every lane that escaped
    missed = jnp.any(miss_w_full != 0.0, axis=0)
    env = _env_radiance(scene, miss_dir_full)
    radiance = radiance_full + jnp.where(missed[None], env * miss_w_full, 0.0)
    if return_overflow:
        return radiance, overflow
    return radiance


@partial(jax.jit, static_argnames=("spec", "compaction", "nee", "corrected",
                                   "max_depth"))
def render_frame(scene, spec: CameraSpec, cam, frame, key, compaction=None,
                 nee: bool = True, corrected: bool = False,
                 max_depth: int = MAX_DEPTH):
    """One progressive frame (1 spp): returns (W, H, 3) radiance."""
    k_cam, k_path = jax.random.split(key)
    o, d, inv = _camera_rays(spec, cam, frame, k_cam)
    radiance = trace_paths(scene, o, d, k_path, compaction=compaction, nee=nee,
                           corrected=corrected, camera_origin=o[:, 0],
                           coherent_camera=inv is not None,
                           max_depth=max_depth)
    radiance = _to_raster(radiance, inv)
    return jnp.swapaxes(radiance, 0, 1).reshape(spec.width, spec.height, 3)


@partial(jax.jit, static_argnames=("spec", "compaction", "nee"))
def render_frame_stats(scene, spec: CameraSpec, cam, frame, key,
                       compaction=None, nee: bool = True):
    """render_frame + estimator-safety stats: (image, overflow_kills).

    overflow_kills > 0 means the compaction schedule cut live paths
    (depth bias) — bench.py surfaces it so a too-tight schedule cannot
    silently regress the estimator."""
    k_cam, k_path = jax.random.split(key)
    o, d, inv = _camera_rays(spec, cam, frame, k_cam)
    radiance, overflow = trace_paths(
        scene, o, d, k_path, compaction=compaction, nee=nee,
        return_overflow=True, camera_origin=o[:, 0],
        coherent_camera=inv is not None,
    )
    radiance = _to_raster(radiance, inv)
    img = jnp.swapaxes(radiance, 0, 1).reshape(spec.width, spec.height, 3)
    return img, overflow


@partial(jax.jit, static_argnames=("spec", "n_frames", "compaction", "nee",
                                   "max_depth"),
         donate_argnums=(3,))
def render_film_frames(scene, spec: CameraSpec, cam, film, n_frames: int = 4,
                       compaction=None, nee: bool = True,
                       max_depth: int = MAX_DEPTH):
    """n progressive frames accumulated into the film in ONE dispatch.

    The frames run SEQUENTIALLY inside a fori_loop, which amortizes the
    per-dispatch host overhead across n frames.

    Key/frame discipline matches the single-frame loop exactly
    (render(fl.frame, fl.key) then film.accumulate), so an n-frame
    dispatch is bit-identical to n single-frame dispatches.

    Returns (film', overflow_kills_total)."""
    from ti_raytrace_tpu import film as film_mod

    def body(_, state):
        fl, ov_total = state
        k_cam, k_path = jax.random.split(fl.key)
        o, d, inv = _camera_rays(spec, cam, fl.frame, k_cam)
        radiance, ov = trace_paths(
            scene, o, d, k_path, compaction=compaction, nee=nee,
            return_overflow=True, camera_origin=o[:, 0],
            coherent_camera=inv is not None, max_depth=max_depth,
        )
        radiance = _to_raster(radiance, inv)
        img = jnp.swapaxes(radiance, 0, 1).reshape(spec.width, spec.height, 3)
        return film_mod.accumulate(fl, img), ov_total + ov

    return jax.lax.fori_loop(0, n_frames, body, (film, jnp.int32(0)))


def _render_group(scene, spec, cam, frame0, key0, group: int, compaction,
                  nee: bool, max_depth: int = MAX_DEPTH, gen_rays=None,
                  lane_space: bool = False, n_lanes: int = None,
                  pay_divisors=None):
    """`group` progressive frames with their compacted deep phases MERGED
    into one wavefront.  Returns (summed (W, H, 3) radiance, overflow).

    gen_rays(frame, k_cam) -> (o, d, coherent) overrides the full-film
    camera generation — the sharded production path
    (parallel/shard.render_film_frames_merged_sharded) renders one lane
    shard per device, so each device generates only its n_lanes rays.
    lane_space=True returns the summed radiance as planar (3, n_lanes)
    WITHOUT the raster unpermute (the film then lives in lane space and
    converts to an image once, outside shard_map).

    The per-block cluster union in the deep phases is intrinsic at a
    given survivor DENSITY, but density is a free variable: concatenating
    G frames' compacted carries packs G-times more live rays per origin
    cell, so each ray block spans a smaller cell and visits fewer
    clusters, while the per-bounce sort/gather/shade ops amortize
    G-fold.

    Per-frame camera rays and bounce 0 stay on the film's per-frame key
    chain (k_cam/k_path = split(key_f)), so they are bit-identical to the
    sequential loop; merged bounces (depth >= first compaction) draw from
    frame 0's path key over the concatenated wavefront — a different but
    equally valid RNG stream (every lane still gets fresh independent
    uniforms; group=1 reduces EXACTLY to the sequential loop).  Lane g*N+p
    belongs to frame g, pixel p; compaction capacity is pooled across the
    group, so a one-frame survivor spike can borrow headroom."""
    N = n_lanes if n_lanes is not None else spec.width * spec.height
    b_merge, dv0 = compaction[0]
    w1 = _phase_width(N, dv0)

    if gen_rays is None:
        def gen_rays(frame, k_cam):
            o, d, inv = _camera_rays(spec, cam, frame, k_cam)
            return o, d, inv is not None

    def prologue(state, g):
        key_f, ov = state
        k_cam, k_path = jax.random.split(key_f)
        o, d, coherent = gen_rays(frame0 + g, k_cam)
        if TRACE0_COMPACT and b_merge == 1:
            c, accum, ovg = _trace0_compact_shade(
                scene, o, d, jax.random.fold_in(k_path, 0),
                _phase_width(N, TRACE0_DIV), nee, False, coherent,
            )
            c, accum, ov2 = _flush_compact(
                scene, c, accum, w1, _phase_width(N, TRACE0_PAY_DIV)
            )
            ovg = ovg + ov2
        else:
            c = _new_carry(o, d)
            c = _bounce(scene, c, jax.random.fold_in(k_path, 0), nee, False,
                        False, shared_origin=o[:, 0], coherent=coherent)
            for depth in range(1, b_merge):
                c = _bounce(scene, c, jax.random.fold_in(k_path, depth), nee,
                            False)
            c, accum = _flush(c, _new_accum(N), identity=True)
            c, ovg = _compact(c, w1)
        c["pixel"] = c["pixel"] + g * N
        key_next, _ = jax.random.split(key_f)  # film.accumulate's key chain
        return (key_next, ov + ovg), (_pack_carry(c), accum)

    (_, overflow), (packed, accums) = jax.lax.scan(
        prologue, (key0, jnp.int32(0)), jnp.arange(group, dtype=jnp.int32)
    )
    carry = _unpack_carry(
        jnp.swapaxes(packed, 0, 1).reshape(PACK_ROWS, group * w1)
    )
    accum_full = (
        jnp.swapaxes(accums[0], 0, 1).reshape(3, group * N),
        jnp.swapaxes(accums[1], 0, 1).reshape(6, group * N),
    )

    # frame 0's path key: group=1 then replays trace_paths' exact stream
    _, k_merge = jax.random.split(key0)

    starts = [s for s, _ in compaction]
    ends = starts[1:] + [max_depth]
    for i, ((b0, dv), b1) in enumerate(zip(compaction, ends)):
        if b0 >= max_depth:
            break
        b1 = min(b1, max_depth)
        if i > 0:
            w = group * _phase_width(N, dv)
            if pay_divisors is not None:
                # fused flush+compact: scatter only the dead-with-payload
                # tail (pay_divisors[i-1] sets its capacity, same
                # headroom discipline as the width schedule)
                carry, accum_full, ovg = _flush_compact(
                    scene, carry, accum_full, w,
                    group * _phase_width(N, pay_divisors[i - 1]),
                )
            else:
                carry, accum_full = _flush(carry, accum_full, scene=scene)
                carry, ovg = _compact(carry, w)
            overflow = overflow + ovg

        presort_on = PRESORT_MERGED and needs_presort(scene)
        if presort_on and PRESORT_HALF:
            for j, depth in enumerate(range(b0, b1)):
                carry = _bounce(scene, carry,
                                jax.random.fold_in(k_merge, depth), nee,
                                presort=(j % 2 == 0),
                                stale_order=(j % 2 == 1))
        else:
            carry = _while_bounces(scene, carry, k_merge, b0, b1, nee,
                                   presort=presort_on)

    carry, accum_full = _flush(carry, accum_full, scene=scene)
    acc_rad, acc_miss = accum_full
    missed = jnp.any(acc_miss[3:6] != 0.0, axis=0)
    env = _env_radiance(scene, acc_miss[0:3])
    radiance = acc_rad + jnp.where(
        missed[None], env * acc_miss[3:6], 0.0
    )
    img_sum = radiance.reshape(3, group, N).sum(axis=1)
    if lane_space:
        return img_sum, overflow
    if MORTON_CAMERA:
        from ti_raytrace_tpu.camera import morton_pixel_order

        _, inv = morton_pixel_order(spec.width, spec.height)
        img_sum = _to_raster(img_sum, jnp.asarray(inv))
    return (
        jnp.swapaxes(img_sum, 0, 1).reshape(spec.width, spec.height, 3),
        overflow,
    )


@partial(jax.jit, static_argnames=("spec", "n_frames", "group", "compaction",
                                   "nee", "pay_divisors", "max_depth"),
         donate_argnums=(3,))
def render_film_frames_merged(scene, spec: CameraSpec, cam, film,
                              n_frames: int = 16, group: int = 4,
                              compaction=None, nee: bool = True,
                              pay_divisors=None, max_depth: int = MAX_DEPTH):
    """n progressive frames in ONE dispatch, traced in merged groups.

    Like render_film_frames, but each group of `group` frames shares its
    compacted deep phases (see _render_group) — the production bench path
    Requires a compaction
    schedule; the film ends on the same frame count and key chain as the
    sequential loop, so checkpoints are interchangeable.

    Returns (film', overflow_kills_total)."""
    from ti_raytrace_tpu import film as film_mod

    assert compaction, "merged rendering requires a compaction schedule"
    assert n_frames % group == 0, (n_frames, group)

    def gbody(_, state):
        fl, ov_total = state
        img_sum, ov = _render_group(
            scene, spec, cam, fl.frame, fl.key, group, tuple(compaction), nee,
            pay_divisors=pay_divisors, max_depth=max_depth,
        )
        return film_mod.accumulate_group(fl, img_sum, group), ov_total + ov

    return jax.lax.fori_loop(
        0, n_frames // group, gbody, (film, jnp.int32(0))
    )
