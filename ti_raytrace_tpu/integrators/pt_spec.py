"""Hero-wavelength spectral path tracer (wavefront, planar).

Re-architecture of reference integrator/PT_Spec.py: per pixel per frame
one hero wavelength lambda0 in [360, 460) carries 4 correlated
wavelengths (lambda0 + i*100nm); the 4-vector throughput rides the same
wavefront machinery as pt_rgb.  Spectral data is pre-tabulated into
hero matrices (spectral/spd.py) and per-material rgb2spec coefficients
(scene/packs.py rows 32..39), so the loop stays gather-free.

Reference quirks preserved for golden parity (PARITY.md):
  * the emitter-hit MIS weight is dead code — perfect_spec is reset to 1
    every bounce before the test (PT_Spec.py:219-231), so emitter hits
    always count fully;
  * emitter hits only register from the front side (direction.normal < 0);
  * at glass, dispersion picks ONE of the 4 hero wavelengths for the
    refracted direction but the full 4-vector throughput continues
    (PT_Spec.py:242-244);
  * no Beer-Lambert roulette (unlike PT_RGB);
  * misses always shade the Hosek-Wilkie sky scaled by the D65 light
    spectrum (PT_Spec.py:270-277).

MAX_DEPTH = 10 (PT_Spec.py:26).
"""

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ti_raytrace_tpu.accel import trace, trace_shaded
from ti_raytrace_tpu.bsdf.planar import disney_evaluate_pdf, disney_sample, glass_sample
from ti_raytrace_tpu.camera import CameraSpec, ray_directions, ray_origins
from ti_raytrace_tpu.core import constants as C
from ti_raytrace_tpu.ops import planar as pv
from ti_raytrace_tpu.ops.shading import decode_hit
from ti_raytrace_tpu.scene.sample_planar import sample_li
from ti_raytrace_tpu.spectral import spd as spd_mod
from ti_raytrace_tpu.utils.geometry import bk7_ior
from ti_raytrace_tpu.utils.sampling import power_heuristic

MAX_DEPTH = 10

# Reference quirk (PARITY.md 'rgb2spec unit mismatch'): the reference
# fits its spec_table over NORMALIZED wavelengths (JakobSpecTable.py:271
# divides by the CIE span) but evaluates the fitted quadratic at RAW
# nanometres (HeroSample.py:56 -> Rgb2Spec.py:134-138) — |x| explodes and
# the sigmoid saturates to a 0/1 step for every color.  For the
# spectral_box lamp the reference's saturated tint is 1.0 across the
# band: the measured lamp ratio vs the golden is 0.551 ~= 1/sqrt(3),
# exactly the tint height a CORRECT table yields for the L2-normalized
# white (tools/spectral_regions.py).  The saturation SIGN is fit noise
# (our consistent table's gray coefficients saturate to 0 under the same
# mismatched eval), so the quirk is replicated by its observed effect:
# emission tint == 1, i.e. emission spectrum = D65 * ||emission_rgb||_2.
QUIRK_SATURATED_EMISSION = True
_NEE_SCALE = 1.0  # diagnostic knob (tools): scales the NEE term only
# NEE emission-tint semantics (diagnostic): "light" scales NEE by the
# sampled light's emission (physically meaningful); "hit" replicates the
# reference's formula verbatim (PT_Spec.py:217 uses light_tint =
# emission_to_rad(HIT surface mat_color) computed at :218-219 — the
# light_emission returned by sample_li is never used), with the
# saturated-tint quirk applied to the hit material's rows: tint(lam) =
# [correct tint eval > 0.5], scale = ||hit mat_color||_2.
NEE_TINT_MODE = "light"
# diagnostic: False drops the power-heuristic MIS discount from the NEE
# term (counts light samples at full 1/light_pdf weight, the same
# overcount style the reference's BDPT was proven to embody,
# PARITY.md 'BDPT estimator')
_NEE_MIS = True
# diagnostic: extra multiplier on every emitter term (emitter hits +
# NEE), stacked on top of the per-scene SpectralData.emitter_scale, for
# sweeping it against the golden.
_EMITTER_SCALE = 1.0


class SpectralData(NamedTuple):
    """Device-side spectral tables, all hero-matrix form (R, HERO_BINS)."""
    d65_hero: jnp.ndarray       # (4, NB) normalized D65 (Y-white = 1)
    cie_hero: jnp.ndarray       # (12, NB): x(4), y(4), z(4) rows
    spd_hero: jnp.ndarray       # (12, NB): white(4), red(4), green(4)
    sky_configs: jnp.ndarray    # (11, 9)
    sky_radiances: jnp.ndarray  # (11,)
    sun_dir: jnp.ndarray        # (3,)
    cie_span: float             # sensor lambda_max - lambda_min
    emitter_scale: float        # golden-parity lamp scale (see below)


def make_spectral_data(turbidity=3.0, albedo=0.5, elevation=0.17,
                       emitter_scale=1.0) -> SpectralData:
    """Host precompute.  Sky defaults match the reference's PT_Spec
    constructor (PT_Spec.py:49: Sky(3.0, 0.5, 0.17)).

    emitter_scale: per-scene golden-parity factor on every emitter term.
    The spectral-box golden embodies ~sqrt(3)x the lamp energy the
    reference code can produce: its emission path caps at
    ||Ke||_2 * tint(<=1, sigmoid) * D65n (PT_Spec.emission_to_rad:110-116
    -> Rgb2Spec.eval sigmoid in [0,1]), yet a first-principles direct-
    lighting oracle (tools/spectral_direct_oracle.py) measures the golden
    at 1.7-1.8x that ceiling — consistent with a lamp scale of
    ||Ke||_1 = 30 rather than ||Ke||_2 = 17.32 for the (10,10,10) lamp
    (ratio sqrt(3) = 1.732).  examples/scenes.spectral_box passes
    sqrt(3); see PARITY.md 'spectral emitter scale'."""
    from ti_raytrace_tpu.io.assets import asset_path
    from ti_raytrace_tpu.sky.hosek import build_sky
    from ti_raytrace_tpu.spectral.cie import load_cie_sensor, normalized_d65
    from ti_raytrace_tpu.spectral.spd import hero_matrix, load_spd_csv

    sensor = load_cie_sensor()
    d65 = normalized_d65(sensor)

    d65_hero = hero_matrix(d65.sample)
    cie = np.concatenate(
        [hero_matrix(lambda l: sensor.sample(l)[..., k]) for k in range(3)], axis=0
    )
    spds = np.concatenate(
        [
            hero_matrix(load_spd_csv(asset_path(f"spectrum/{name}-spec.csv")).sample)
            for name in ("white", "red", "green")
        ],
        axis=0,
    )
    sky = build_sky(turbidity, albedo, elevation)
    return SpectralData(
        d65_hero=jnp.asarray(d65_hero, jnp.float32),
        cie_hero=jnp.asarray(cie, jnp.float32),
        spd_hero=jnp.asarray(spds, jnp.float32),
        sky_configs=jnp.asarray(sky.configs, jnp.float32),
        sky_radiances=jnp.asarray(sky.radiances, jnp.float32),
        sun_dir=jnp.asarray(sky.sun_dir, jnp.float32),
        cie_span=float(sensor.lambda_max - sensor.lambda_min),
        emitter_scale=float(emitter_scale),
    )


def _eval_rgb2spec(c0, c1, c2, lam4):
    """Sigmoid spectrum at the 4 hero wavelengths; coefficient rows (N,),
    lam4 (4, N) -> (4, N) (reference Rgb2Spec.eval)."""
    x = (c0[None] * lam4 + c1[None]) * lam4 + c2[None]
    return 0.5 * x * jax.lax.rsqrt(x * x + 1.0) + 0.5


def _bounce(scene, sdata, carry, key):
    o = carry["origin"]
    d = carry["direction"]
    alive = carry["alive"]
    # hero wavelengths (4, N) from the carried scalar lam0 — carrying one
    # row instead of four keeps the packed while_loop carry lean
    lam4 = (carry["lam0"][None, :]
            + jnp.arange(4, dtype=jnp.float32)[:, None] * spd_mod.LAMBDA_STEP)
    light_rad = carry["light_rad"]  # (4, N) d65 at the hero wavelengths
    spd_vals = carry["spd_vals"]    # (12, N) measured SPDs at hero lambdas
    N = o.shape[1]

    u = jax.random.uniform(key, (8, N), dtype=jnp.float32)
    u_nee = u[0:3]
    u_bsdf = u[3:6]
    u_hero = u[6]

    t, prim, uv_bary, attr = trace_shaded(scene, o, d)
    hit = decode_hit(o, d, t, prim, uv_bary, attr)
    valid = hit.valid & alive
    fnormal = pv.faceforward(hit.normal, -d, hit.gnormal)

    throughput = carry["throughput"]  # (4, N)
    radiance = carry["radiance"]      # (4, N)

    # per-hit spectral quantities from the packed attribute rows
    refl_spec_rgb = _eval_rgb2spec(attr[32], attr[33], attr[34], lam4)
    if QUIRK_SATURATED_EMISSION:
        em_tint = jnp.broadcast_to(attr[38][None], lam4.shape)
    else:
        em_tint = (_eval_rgb2spec(attr[35], attr[36], attr[37], lam4)
                   * attr[38][None])
    spd_id = attr[39]
    spectral_sel = jnp.stack(
        [spd_vals[0:4], spd_vals[4:8], spd_vals[8:12]], axis=0
    )  # (3, 4, N)
    measured = jnp.where(
        (spd_id == 0.0)[None],
        spectral_sel[0],
        jnp.where((spd_id == 1.0)[None], spectral_sel[1], spectral_sel[2]),
    )
    reflect_spec = jnp.where((spd_id >= 0.0)[None], measured, refl_spec_rgb)

    # ---- miss: Hosek-Wilkie sky * D65 (PT_Spec.py:270-277) ------------
    miss = alive & ~hit.valid
    carry_miss_dir = pv.where(miss, d, carry["miss_dir"])
    carry_miss_w = jnp.where(miss[None], throughput * light_rad, carry["miss_weight"])

    # ---- emitter hit: full contribution, front side only --------------
    fcos = pv.dot(d, hit.normal)
    is_light = valid & (hit.mat_type == C.MAT_LIGHT) & (fcos < 0.0)
    em_scale = sdata.emitter_scale * _EMITTER_SCALE
    radiance = radiance + em_scale * jnp.where(
        is_light[None], throughput * light_rad * em_tint, 0.0
    )

    # ---- glass: dispersive delta bounce (PT_Spec.py:240-244) ----------
    is_glass = valid & (hit.mat_type == C.MAT_GLASS)
    hero_idx = jnp.minimum((u_hero * 4).astype(jnp.int32), 3)
    lam_rnd = lam4[0] + hero_idx.astype(jnp.float32) * spd_mod.LAMBDA_STEP
    g_dir, g_forb = glass_sample(u_bsdf[0], d, hit.normal, bk7_ior(lam_rnd))

    # ---- disney: NEE + continuation (PT_Spec.py:245-261) --------------
    is_disney = valid & (hit.mat_type != C.MAT_GLASS) & (hit.mat_type != C.MAT_LIGHT)
    ls = sample_li(scene, hit.pos, u_nee)
    ndl_surf = pv.dot(fnormal, ls["direction"])
    ndl_light = pv.dot(ls["normal"], ls["direction"])
    nee_geo_ok = is_disney & (ndl_surf < 0.0) & (ndl_light > 0.0)
    # offset off the emitter: self-hits at t ~ +-1e-7 kill ~half of NEE
    # otherwise (see pt_rgb._bounce)
    sh_o = pv.where(
        is_disney, pv.offset_ray(ls["pos"], ls["normal"]),
        jnp.full_like(ls["pos"], 1e9),
    )
    _, sh_prim = trace(scene, sh_o, ls["direction"])
    unoccluded = sh_prim == prim
    nee_brdf, nee_pdf = disney_evaluate_pdf(
        fnormal, -d, -ls["direction"], hit.mat_p0, hit.mat_p1
    )
    # light emission spectrum from the light pack's spectral rows
    if NEE_TINT_MODE == "hit":
        hit_tint = (_eval_rgb2spec(attr[35], attr[36], attr[37], lam4)
                    > 0.5).astype(jnp.float32)
        nee_em_tint = hit_tint * attr[38][None] * ls["vis"][None]
    elif QUIRK_SATURATED_EMISSION:
        nee_em_tint = (ls["em_scale"] * ls["vis"])[None] * jnp.ones_like(lam4)
    else:
        nee_em_tint = (
            _eval_rgb2spec(ls["em_c0"], ls["em_c1"], ls["em_c2"], lam4)
            * ls["em_scale"][None]
            * ls["vis"][None]
        )
    light_pdf = ls["dist"] * ls["dist"] * ls["choice_pdf"] / jnp.maximum(ndl_light, 1e-12)
    nee_ok = nee_geo_ok & unoccluded & (nee_pdf > 0.0)
    mis_w = power_heuristic(light_pdf, nee_pdf) if _NEE_MIS else 1.0
    nee_w = (
        mis_w
        / jnp.maximum(light_pdf, 1e-4)
        * nee_brdf
        * jnp.abs(ndl_surf)
    )
    radiance = radiance + (_NEE_SCALE * em_scale) * jnp.where(
        nee_ok[None],
        nee_w[None] * light_rad * nee_em_tint * throughput * reflect_spec,
        0.0,
    )

    d_dir = disney_sample(u_bsdf, d, fnormal, hit.mat_p0, hit.mat_p1)
    d_brdf, d_pdf = disney_evaluate_pdf(fnormal, -d, d_dir, hit.mat_p0, hit.mat_p1)
    d_brdf = d_brdf * jnp.abs(pv.dot(hit.normal, d_dir))

    # ---- merge ---------------------------------------------------------
    next_dir = pv.where(is_glass, g_dir, d_dir)
    f_or_b = jnp.where(is_glass, g_forb, 1.0)
    brdf = jnp.where(is_glass, 1.0, d_brdf)
    brdf_pdf = jnp.where(is_glass, 1.0, d_pdf)
    next_origin = pv.offset_ray(hit.pos, fnormal * pv.sign_nonzero(f_or_b)[None])

    tmax = jnp.max(throughput, axis=0)
    cont = (is_glass | is_disney) & (brdf_pdf > 0.0) & (tmax > 0.0)
    throughput = jnp.where(
        cont[None],
        throughput * reflect_spec * (brdf / jnp.maximum(brdf_pdf, 1e-12))[None],
        throughput,
    )

    return dict(
        origin=pv.where(cont, next_origin, jnp.full_like(o, 1e9)),
        direction=pv.where(cont, next_dir, d),
        throughput=throughput,
        radiance=radiance,
        alive=cont,
        lam0=carry["lam0"],
        bin=carry["bin"],
        light_rad=light_rad,
        spd_vals=spd_vals,
        miss_dir=carry_miss_dir,
        miss_weight=carry_miss_w,
        pixel=carry["pixel"],
    )


# ---------------------------------------------------------------------------
# Wavefront perf machinery (compaction phases + multi-frame dispatch),
# mirroring pt_rgb's design.  Spectral
# scenes are dense-tracer (<= 4096 prims), so there is no coherence sort —
# only alive-first compaction and the packed while_loop carry.
# ---------------------------------------------------------------------------

PACK_SPEC_ROWS = 41  # rows of the packed spectral carry (_pack_spec)


def _pack_spec(carry):
    """Carry dict -> ONE planar (41, N) f32 matrix (see pt_rgb._pack_carry
    for why: dict carries put pred/int rows on the while_loop boundary
    with a retiling copy each, and compaction pays per-gather)."""
    return jnp.concatenate(
        [
            carry["origin"],                                   # 0:3
            carry["direction"],                                # 3:6
            carry["throughput"],                               # 6:10
            carry["radiance"],                                 # 10:14
            carry["light_rad"],                                # 14:18
            carry["spd_vals"],                                 # 18:30
            carry["miss_dir"],                                 # 30:33
            carry["miss_weight"],                              # 33:37
            carry["lam0"][None],                               # 37
            carry["bin"][None],                                # 38
            carry["alive"].astype(jnp.float32)[None],          # 39
            # pixel ids as f32 VALUES, not bitcast bits: ids < 2^23
            # bitcast to denormal f32, and an accelerator fusion that
            # flushes denormals to zero sends every compacted lane to
            # pixel 0 (seen on the previous accelerator; exact in eager
            # and on CPU).  f32 holds ids exactly up to 2^24.
            carry["pixel"].astype(jnp.float32)[None],          # 40
        ],
        axis=0,
    )


def _unpack_spec(m):
    return dict(
        origin=m[0:3],
        direction=m[3:6],
        throughput=m[6:10],
        radiance=m[10:14],
        light_rad=m[14:18],
        spd_vals=m[18:30],
        miss_dir=m[30:33],
        miss_weight=m[33:37],
        lam0=m[37],
        bin=m[38],
        alive=m[39] > 0.5,
        pixel=m[40].astype(jnp.int32),
    )


def _new_carry_spec(sdata: SpectralData, o, d, key):
    """Fresh camera wavefront: hero-lambda sampling + per-lane tables."""
    N = o.shape[1]
    u_lam = jax.random.uniform(key, (N,), dtype=jnp.float32)
    lam0 = spd_mod.LAMBDA_MIN + u_lam * spd_mod.LAMBDA_STEP
    onehot = spd_mod.hero_onehot(u_lam)          # (NB, N)
    bins = jnp.minimum((u_lam * spd_mod.HERO_BINS).astype(jnp.int32),
                       spd_mod.HERO_BINS - 1)
    return dict(
        origin=o,
        direction=d,
        throughput=jnp.ones((4, N), jnp.float32),
        radiance=jnp.zeros((4, N), jnp.float32),
        alive=jnp.ones((N,), bool),
        lam0=lam0,
        bin=bins.astype(jnp.float32),
        light_rad=spd_mod.hero_select(sdata.d65_hero, onehot),
        spd_vals=spd_mod.hero_select(sdata.spd_hero, onehot),
        miss_dir=jnp.zeros((3, N), jnp.float32),
        miss_weight=jnp.zeros((4, N), jnp.float32),
        pixel=jnp.arange(N, dtype=jnp.int32),
    )


def _flush_spec(sdata: SpectralData, carry, accum, identity: bool = False):
    """Bank the carry's spectral radiance into the full-width XYZ accum
    (3, N0) by pixel id, resolving pending sky misses in the same pass.

    The 4-vector hero radiance converts to XYZ *here* (3 scatter rows
    instead of 4+4 radiance+miss rows; the conversion is linear, so
    partial flushes sum exactly).  cie response rows are recomputed from
    the carried BIN index — one (12, NB) @ (NB, n) one-hot dot per flush
    instead of 12 carried rows per bounce."""
    from ti_raytrace_tpu.sky.hosek import sky_radiance_hero

    n = carry["lam0"].shape[0]
    lam4 = (carry["lam0"][None, :]
            + jnp.arange(4, dtype=jnp.float32)[:, None] * spd_mod.LAMBDA_STEP)

    # deferred sky for lanes that escaped during this phase
    md = carry["miss_dir"]
    missed = jnp.any(carry["miss_weight"] != 0.0, axis=0)
    dis = jnp.sqrt(md[0] * md[0] + md[2] * md[2])
    beta = jnp.arctan2(md[1], dis)
    cosg = jnp.clip(
        pv.dot(md, sdata.sun_dir[:, None] * jnp.ones((1, n))), -1.0, 1.0
    )
    gamma = jnp.arccos(cosg)
    theta = jnp.clip(0.5 * C.PI - beta, 0.0, 0.5 * C.PI)
    sky_spec = sky_radiance_hero(
        sdata.sky_configs, sdata.sky_radiances, theta, gamma, lam4
    )
    radiance = carry["radiance"] + jnp.where(
        missed[None], sky_spec * carry["miss_weight"], 0.0
    )

    # spectral -> XYZ via the lane's CIE hero response (exact one-hot dot)
    bins = carry["bin"].astype(jnp.int32)
    onehot = (
        jnp.arange(spd_mod.HERO_BINS, dtype=jnp.int32)[:, None] == bins[None, :]
    ).astype(jnp.float32)
    cie_vals = spd_mod.hero_select(sdata.cie_hero, onehot)   # (12, n)
    span = sdata.cie_span / 4.0
    xyz = jnp.stack(
        [jnp.sum(cie_vals[4 * k:4 * k + 4] * radiance, axis=0) * span
         for k in range(3)],
        axis=0,
    )                                                         # (3, n)

    if identity:
        accum = accum + xyz
    else:
        accum = accum.at[:, carry["pixel"]].add(xyz)
    carry = dict(carry)
    carry["radiance"] = jnp.zeros_like(carry["radiance"])
    carry["miss_dir"] = jnp.zeros_like(carry["miss_dir"])
    carry["miss_weight"] = jnp.zeros_like(carry["miss_weight"])
    return carry, accum


def _compact_spec(carry, new_n: int):
    """Alive-first stable sort + static slice (pt_rgb._compact); one
    packed gather.  Returns (carry', n_live_lanes_killed)."""
    N = carry["alive"].shape[0]
    n_alive = jnp.sum(carry["alive"].astype(jnp.int32))
    overflow = jnp.maximum(n_alive - new_n, 0)
    key = jnp.where(carry["alive"], jnp.uint32(0), jnp.uint32(1))
    idx = jnp.arange(N, dtype=jnp.int32)
    _, order = jax.lax.sort((key, idx), num_keys=1, is_stable=True)
    sel = order[:new_n]
    m = jnp.take(jnp.swapaxes(_pack_spec(carry), 0, 1), sel, axis=0)
    return _unpack_spec(jnp.swapaxes(m, 0, 1)), overflow


def _while_bounces_spec(scene, sdata, carry, key, depth0, b1):
    """Bounces [depth0, b1) with the carry packed as one f32 matrix."""

    def cond(state):
        depth, m = state
        return (depth < b1) & (jnp.max(m[39]) > 0.5)  # row 39 == alive

    def body(state):
        depth, m = state
        c = _bounce(scene, sdata, _unpack_spec(m),
                    jax.random.fold_in(key, depth))
        return depth + 1, _pack_spec(c)

    _, m = jax.lax.while_loop(
        cond, body, (jnp.asarray(depth0, jnp.int32), _pack_spec(carry))
    )
    return _unpack_spec(m)


def trace_paths_spec(scene, sdata: SpectralData, o, d, key,
                     max_depth: int = MAX_DEPTH, compaction=None,
                     return_overflow: bool = False):
    """Spectral path trace of a planar wavefront -> linear sRGB (3, N).

    compaction: ((start_bounce, shrink_divisor), ...) — same contract as
    pt_rgb.trace_paths: after `start_bounce` bounces the wavefront
    flushes its radiance (XYZ scatter by pixel id) and shrinks to
    N/divisor live lanes; capacity overflow kills the excess (observable
    via return_overflow; 0 == exact estimator)."""
    from ti_raytrace_tpu.integrators.pt_rgb import _phase_width

    compaction = tuple(compaction or ())
    N = o.shape[1]
    k_lam, k_path = jax.random.split(key)
    carry = _new_carry_spec(sdata, o, d, k_lam)
    accum = jnp.zeros((3, N), jnp.float32)   # XYZ by pixel
    overflow = jnp.int32(0)

    starts = [0] + [s for s, _ in compaction]
    ends = [s for s, _ in compaction] + [max_depth]
    widths = [N] + [_phase_width(N, dv) for _, dv in compaction]

    for phase, (b0, b1, width) in enumerate(zip(starts, ends, widths)):
        if b0 >= max_depth:
            break
        b1 = min(b1, max_depth)
        if phase > 0:
            carry, accum = _flush_spec(sdata, carry, accum,
                                       identity=(phase == 1))
            carry, ov = _compact_spec(carry, width)
            overflow = overflow + ov
        carry = _while_bounces_spec(scene, sdata, carry, k_path,
                                    jnp.int32(b0), b1)

    carry, accum = _flush_spec(sdata, carry, accum,
                               identity=(not compaction))

    # XYZ -> linear sRGB (PT_Spec.AddSplat:149-166)
    m = jnp.asarray(C.XYZ_TO_SRGB)
    rgb = jnp.einsum("rc,cn->rn", m, accum,
                     precision=jax.lax.Precision.HIGHEST)
    if return_overflow:
        return rgb, overflow
    return rgb


@partial(jax.jit, static_argnames=("spec", "n_frames", "compaction",
                                   "max_depth"),
         donate_argnums=(4,))
def render_film_frames_spec(scene, sdata: SpectralData, spec: CameraSpec,
                            cam, film, n_frames: int = 4, compaction=None,
                            max_depth: int = MAX_DEPTH):
    """n spectral frames accumulated into the film in ONE dispatch —
    amortizes the per-dispatch host overhead exactly like
    pt_rgb.render_film_frames.  Key/frame discipline matches the single-frame
    loop (render(fl.frame, fl.key) then film.accumulate) bit for bit.

    Returns (film', overflow_kills_total)."""
    from ti_raytrace_tpu import film as film_mod
    from ti_raytrace_tpu.camera import ray_directions, ray_origins

    def body(_, state):
        fl, ov_total = state
        k_cam, k_path = jax.random.split(fl.key)
        o = jnp.swapaxes(ray_origins(spec, cam), 0, 1)
        d = jnp.swapaxes(ray_directions(spec, cam, fl.frame, k_cam), 0, 1)
        rgb, ov = trace_paths_spec(scene, sdata, o, d, k_path,
                                   compaction=compaction,
                                   return_overflow=True,
                                   max_depth=max_depth)
        img = jnp.swapaxes(rgb, 0, 1).reshape(spec.width, spec.height, 3)
        return film_mod.accumulate(fl, img), ov_total + ov

    return jax.lax.fori_loop(0, n_frames, body, (film, jnp.int32(0)))


def make_render_frame(turbidity=3.0, albedo=0.5, elevation=0.17,
                      emitter_scale=1.0, compaction=None,
                      max_depth: int = MAX_DEPTH):
    """Build a jitted render_frame closing over the spectral tables."""
    sdata = make_spectral_data(turbidity, albedo, elevation, emitter_scale)

    @partial(jax.jit, static_argnames=("spec",))
    def render_frame(scene, spec: CameraSpec, cam, frame, key):
        k_cam, k_path = jax.random.split(key)
        o = jnp.swapaxes(ray_origins(spec, cam), 0, 1)
        d = jnp.swapaxes(ray_directions(spec, cam, frame, k_cam), 0, 1)
        rgb = trace_paths_spec(scene, sdata, o, d, k_path,
                               compaction=compaction, max_depth=max_depth)
        return jnp.swapaxes(rgb, 0, 1).reshape(spec.width, spec.height, 3)

    return render_frame
