"""Bidirectional path tracer with multiple importance sampling (planar).

Wavefront re-architecture of reference integrator/BDPT_RGB.py:

  * the eye subpath (<= MAX_DEPTH+2 = 7 vertices, BDPT_RGB.py:22-25) and
    light subpath (<= 6) are built by statically-unrolled wavefront walks;
    each depth's vertex is a dict of planar (3, N)/(N,) arrays — the
    reference's (W, H, depth) SoA pools (BDPT_Vertex.py) with the depth
    axis unrolled at trace time, so all indexing is static;
  * every (e, l) connection strategy is a masked whole-wavefront block
    (static double loop, reference render:617-637), including the e=1
    light-tracing strategy that splats to a different pixel via one
    scatter-add per frame (reference :630-633);
  * the MIS weight (reference mis_weight:302-479) is evaluated
    functionally: the reference temporarily rewrites endpoint vertices in
    shared pools (the temp-swap trick, :311-332) and restores them; here
    the recomputed endpoint reverse-pdfs are passed as override values
    into a pure weight function.

Parity notes (PARITY.md): the reference's mis_weight compares the
material *index* against MAT_DISNEY==0 at three sites
(BDPT_RGB.py:364,379,432 — `light.mat` holds an index), so only material
#0 contributes a real reverse pdf there; the published goldens embody
that weighting, so it is replicated verbatim (_QUIRK_MAT_INDEX).
Everything else (remap0 semantics, delta masking, vertex-area pdf
conversions, beta conventions including the emitter-hit
beta = beta*emission*|n.d|) follows the reference exactly.
"""

from functools import partial

import jax
import jax.numpy as jnp

from ti_raytrace_tpu.accel import trace, trace_shaded
from ti_raytrace_tpu.bsdf.planar import disney_evaluate_pdf, disney_sample, glass_sample
from ti_raytrace_tpu.camera import CameraSpec, project, ray_directions, ray_origins
from ti_raytrace_tpu.core import constants as C
from ti_raytrace_tpu.ops import planar as pv
from ti_raytrace_tpu.ops.shading import decode_hit
from ti_raytrace_tpu.scene.sample_planar import sample_li, sample_light
from ti_raytrace_tpu.utils.colorsp import srgb_to_lrgb

MAX_DEPTH = 5            # reference BDPT_RGB.py:23
EYE_MAX_DEPTH = MAX_DEPTH + 2
LIGHT_MAX_DEPTH = MAX_DEPTH + 1

V_NONE, V_LIGHT, V_LENS, V_SURFACE = 0, 1, 2, 3

PARK = 1e9

# replicate the reference's material-index-vs-type comparison in MIS
_QUIRK_MAT_INDEX = True

# Occupancy compaction of the fused shadow-ray wavefront: the sorted
# cluster tracer packs the selected (sel) lanes into a dense prefix and
# runs the kernel grid over only SHADOW_CAP of the lanes — parked lanes
# (~55% on veach: strategies whose endpoint never materialized or is
# delta) drop out of the kernel grid.  Contract: active lanes above
# capacity are CUT to misses, which the consumers read as "occluded" —
# a bias — so any cap needs measured headroom (veach's active fraction
# is ~45% over frames; caps 0.5-0.625 gave 0 kills and bit-identical
# images).  Default None: on the previous accelerator a cap bought no
# frame time, because parked lanes already carry a 1e-3 tmax seed that
# prunes their narrow phase; not yet measured on the GPU (pass
# shadow_cap= to the render entry points).
SHADOW_CAP = None


def _quirk_is_disney(v):
    if _QUIRK_MAT_INDEX:
        return v["mat_index"] == 0
    return v["mat_type"] == C.MAT_DISNEY


def _cos_pdf(c):
    return jnp.maximum(0.01, c / C.PI)


def _disney_pdf(n, v, l, metallic, roughness, true_pdf: bool = False):
    _, p = disney_evaluate_pdf(n, v, l, metallic, roughness, true_pdf=true_pdf)
    return jnp.maximum(p, 0.0)


def _empty_vertex(N):
    z3 = jnp.zeros((3, N), jnp.float32)
    z = jnp.zeros((N,), jnp.float32)
    return dict(
        pos=z3, normal=z3, snormal=z3, wo=z3, beta=z3, reflect=z3,
        fpdf=z, rpdf=z, delta=z, area=z, metallic=z, roughness=z,
        vtype=jnp.zeros((N,), jnp.int32), prim=jnp.full((N,), -1, jnp.int32),
        mat_type=jnp.zeros((N,), jnp.int32),
        mat_index=jnp.zeros((N,), jnp.int32),
    )


def _walk_state(origin, direction, beta0, fpdf0, vertex0, max_depth,
                spec_ctx=None):
    """Mutable walk carry: per-depth vertex dicts + the ray front.

    The front additionally carries the previous vertex's pos/normal and
    each lane's ORIGINAL lane id so the front can be occupancy-compacted
    mid-walk (r5): vertex writes then scatter back to original lane
    slots while all arithmetic runs at the compacted width.  In the
    default full-width mode (`compacted` False) every value is
    bit-identical to the pre-r5 walk.  Spectral walks also ride the
    per-lane wavelength tables (spec_ctx.lam / d65_val) in the front so
    they shrink with it."""
    N = origin.shape[1]
    st = {
        "verts": [vertex0] + [_empty_vertex(N) for _ in range(max_depth - 1)],
        "count": jnp.ones((N,), jnp.int32),
        "o": origin,
        "d": direction,
        "beta": beta0,
        "pdf_fwd": fpdf0,
        "alive": jnp.ones((N,), bool),
        "lane": jnp.arange(N, dtype=jnp.int32),
        "prev_pos": vertex0["pos"],
        "prev_normal": vertex0["normal"],
        "compacted": False,  # python-static: front narrower than verts?
        "n_full": N,
    }
    if spec_ctx is not None:
        st["lam"] = spec_ctx.lam
        st["d65"] = spec_ctx.d65_val
    return st


def _walk_width(N: int, dv) -> int:
    """Compacted front width: N/dv rounded up to a 128-lane multiple."""
    w = int(N / float(dv))
    return min(N, max(128, (w + 127) // 128 * 128))


def _compact_walk_front(st, new_n: int):
    """Alive-first stable sort + static prefix slice of the walk front
    (the PT compaction contract, pt_rgb._compact): live lanes above
    capacity are dropped — their subpath simply ends here, which the
    estimator sees as a shorter walk (observable bias; schedules carry
    measured headroom and the overflow count is returned for
    telemetry)."""
    w = st["o"].shape[1]
    n_alive = jnp.sum(st["alive"].astype(jnp.int32))
    overflow = jnp.maximum(n_alive - new_n, 0)
    key = jnp.where(st["alive"], jnp.uint32(0), jnp.uint32(1))
    idx = jnp.arange(w, dtype=jnp.int32)
    _, order = jax.lax.sort((key, idx), num_keys=1, is_stable=True)
    sel = order[:new_n]
    C_ = st["beta"].shape[0]
    spectral = "lam" in st
    rows = [st["o"], st["d"], st["beta"], st["pdf_fwd"][None],
            st["prev_pos"], st["prev_normal"]]
    if spectral:
        rows += [st["lam"][None], st["d65"][None]]
    rows = jnp.concatenate(rows, axis=0)
    rows = jnp.swapaxes(jnp.take(jnp.swapaxes(rows, 0, 1), sel, axis=0), 0, 1)
    st["o"] = rows[0:3]
    st["d"] = rows[3:6]
    st["beta"] = rows[6:6 + C_]
    st["pdf_fwd"] = rows[6 + C_]
    st["prev_pos"] = rows[7 + C_:10 + C_]
    st["prev_normal"] = rows[10 + C_:13 + C_]
    if spectral:
        st["lam"] = rows[13 + C_]
        st["d65"] = rows[14 + C_]
    st["alive"] = jnp.take(st["alive"], sel)
    st["lane"] = jnp.take(st["lane"], sel)
    st["compacted"] = True
    return overflow


def _walk(scene, origin, direction, beta0, fpdf0, vertex0, max_depth, key,
          is_light_path, spec_ctx=None, corrected: bool = False,
          compaction=None):
    """Shared subpath random walk (reference eye_path:105-198 /
    light_path:201-294).  Returns list of per-depth vertex dicts and the
    per-lane vertex count.

    compaction: optional ((depth, divisor), ...) — before the trace at
    `depth` the front shrinks to width/divisor (alive-first), exactly
    the PT schedule contract.  Occupancy collapses identically to PT
    (veach eye walk: 85/65/47/34/25/18% alive after depths 1-6), and a
    dead lane still pays full trace + shade cost without this."""
    st = _walk_state(origin, direction, beta0, fpdf0, vertex0, max_depth,
                     spec_ctx)
    N = origin.shape[1]
    sched = dict(compaction or ())
    for depth in range(1, max_depth):
        if depth in sched:
            _compact_walk_front(st, _walk_width(N, sched[depth]))
        o_t = pv.where(st["alive"], st["o"], jnp.full_like(st["o"], PARK))
        traced = trace_shaded(scene, o_t, st["d"])
        _walk_step(scene, st, depth, key, is_light_path, spec_ctx,
                   corrected, o_t, traced)
    return st["verts"], st["count"]


def _walk_step(scene, st, depth, key, is_light_path, spec_ctx, corrected,
               o_t, traced):
    """One walk depth given this depth's trace results; mutates st.

    Runs at the FRONT's width (== full width until the first compaction
    boundary).  In compacted mode the per-depth vertex dict is written
    through one packed scatter back to original lane slots; the
    full-width branch keeps the pre-r5 masked writes bit-identically."""
    N = o_t.shape[1]
    verts, count = st["verts"], st["count"]
    o, d, beta, pdf_fwd, alive = (st["o"], st["d"], st["beta"],
                                  st["pdf_fwd"], st["alive"])
    compacted = st["compacted"]
    N_full = st["n_full"]
    if spec_ctx is not None:
        # per-lane wavelength tables ride the (possibly compacted) front
        spec_ctx = spec_ctx._replace(lam=st["lam"], d65_val=st["d65"])

    k = jax.random.fold_in(key, depth)
    u = jax.random.uniform(k, (5, N), dtype=jnp.float32)

    t, prim, uv_bary, attr = traced
    hit = decode_hit(o_t, d, t, prim, uv_bary, attr)
    valid = hit.valid & alive
    fnormal = pv.faceforward(hit.normal, -d, hit.gnormal)
    if spec_ctx is None:
        reflect = srgb_to_lrgb(hit.mat_color)
    else:
        reflect = spec_ctx.reflect_power(attr)
    is_light_mat = hit.mat_type == C.MAT_LIGHT

    # previous vertex pos/normal ride the front (they equal
    # verts[depth-1]'s masked writes exactly; carrying them avoids a
    # per-lane gather when the front is compacted)
    prev_pos, prev_normal = st["prev_pos"], st["prev_normal"]
    to = hit.pos - prev_pos
    dist = jnp.maximum(pv.length(to), 0.01)
    inv_d2 = 1.0 / (dist * dist)
    to = to * (1.0 / dist)[None]
    if corrected:
        # standard solid-angle -> area-measure conversion: the cosine
        # at the NEW vertex (PBRT convertDensity)
        geo_fwd = jnp.abs(pv.dot(to, hit.normal)) * inv_d2
    else:
        # reference quirk: cosine at the PREVIOUS vertex
        # (BDPT_RGB.py:143-146 geo_pdf uses this_normal of the source)
        geo_fwd = jnp.abs(pv.dot(to, prev_normal)) * inv_d2

    if is_light_path:
        # light walk stops on emitter hits without storing a vertex
        store = valid & ~is_light_mat
    else:
        store = valid

    vt = verts[depth]
    if not is_light_path:
        # emitter hit terminates the eye walk with a light vertex
        # (beta folds emission and |n.d|, reference :148-152; the
        # spectral variant folds the light power without the cosine,
        # BDPT_SPEC.py:228)
        lhit = valid & is_light_mat
        if spec_ctx is None:
            light_beta = beta * hit.mat_color * jnp.abs(pv.dot(hit.normal, d))[None]
        else:
            light_beta = beta * spec_ctx.light_power_attr(attr)
        beta_v = pv.where(
            lhit, light_beta, beta * jnp.abs(pv.dot(d, hit.normal))[None])
        vtype_v = jnp.where(lhit, V_LIGHT, V_SURFACE)
        write = valid          # beta/vtype land for light hits too
        continue_mask = valid & ~is_light_mat
    else:
        beta_v = beta * jnp.abs(pv.dot(d, hit.normal))[None]
        vtype_v = jnp.full((N,), V_SURFACE, jnp.int32)
        write = store
        continue_mask = store

    fpdf_v = pdf_fwd * geo_fwd
    mat_index_v = attr[30].astype(jnp.int32)
    if not compacted:
        vt["pos"] = pv.where(store, hit.pos, vt["pos"])
        vt["normal"] = pv.where(store, hit.normal, vt["normal"])
        vt["snormal"] = pv.where(store, fnormal, vt["snormal"])
        vt["wo"] = pv.where(store, d, vt["wo"])
        vt["reflect"] = pv.where(store, reflect, vt["reflect"])
        vt["fpdf"] = jnp.where(store, fpdf_v, vt["fpdf"])
        vt["prim"] = jnp.where(store, prim, vt["prim"])
        vt["mat_type"] = jnp.where(store, hit.mat_type, vt["mat_type"])
        vt["mat_index"] = jnp.where(store, mat_index_v, vt["mat_index"])
        vt["metallic"] = jnp.where(store, hit.mat_p0, vt["metallic"])
        vt["roughness"] = jnp.where(store, hit.mat_p1, vt["roughness"])
        vt["area"] = jnp.where(store, hit.area, vt["area"])
        if not is_light_path:
            vt["beta"] = pv.where(write, beta_v, vt["beta"])
            vt["vtype"] = jnp.where(write, vtype_v, vt["vtype"])
            count = jnp.where(valid, depth + 1, count)
        else:
            vt["beta"] = pv.where(store, beta_v, vt["beta"])
            vt["vtype"] = jnp.where(store, vtype_v, vt["vtype"])
            count = jnp.where(store, depth + 1, count)
    else:
        # vertex storage rows are always 3-wide for beta/reflect
        # (_empty_vertex); spectral (1, w) values broadcast into them
        # exactly as the full-width pv.where writes did
        C_ = vt["reflect"].shape[0]
        reflect_b = jnp.broadcast_to(reflect, (C_, N))
        beta_b = jnp.broadcast_to(beta_v, (vt["beta"].shape[0], N))
        # ONE packed scatter back to original lane slots; non-written
        # slots keep the _empty_vertex init (zeros / prim -1).  Indices
        # outside the write mask go out of bounds and drop.
        lane = st["lane"]
        idx_store = jnp.where(store, lane, jnp.int32(N_full))
        idx_write = jnp.where(write, lane, jnp.int32(N_full))
        updf = jnp.concatenate(
            [hit.pos, hit.normal, fnormal, d, reflect_b,
             fpdf_v[None], hit.mat_p0[None], hit.mat_p1[None],
             hit.area[None]], axis=0)          # (12 + C_ + 4, w)
        basef = jnp.concatenate(
            [vt["pos"], vt["normal"], vt["snormal"], vt["wo"],
             vt["reflect"], vt["fpdf"][None], vt["metallic"][None],
             vt["roughness"][None], vt["area"][None]], axis=0)
        scf = basef.at[:, idx_store].set(updf, mode="drop")
        vt["pos"] = scf[0:3]
        vt["normal"] = scf[3:6]
        vt["snormal"] = scf[6:9]
        vt["wo"] = scf[9:12]
        vt["reflect"] = scf[12:12 + C_]
        vt["fpdf"] = scf[12 + C_]
        vt["metallic"] = scf[13 + C_]
        vt["roughness"] = scf[14 + C_]
        vt["area"] = scf[15 + C_]
        updi = jnp.stack([prim, hit.mat_type, mat_index_v])
        basei = jnp.stack([vt["prim"], vt["mat_type"], vt["mat_index"]])
        sci = basei.at[:, idx_store].set(updi, mode="drop")
        vt["prim"], vt["mat_type"], vt["mat_index"] = sci[0], sci[1], sci[2]
        # beta/vtype/count use the (possibly wider) write mask
        vt["beta"] = vt["beta"].at[:, idx_write].set(beta_b, mode="drop")
        vt["vtype"] = vt["vtype"].at[idx_write].set(vtype_v, mode="drop")
        count = count.at[idx_write].set(depth + 1, mode="drop")

    # ---- sample the continuation --------------------------------
    is_glass = continue_mask & (hit.mat_type == C.MAT_GLASS)
    if spec_ctx is None:
        glass_ior = hit.mat_p0
    else:
        # dispersive glass at the path's single wavelength
        # (BDPT_SPEC.py:241,335 -> Glass.sample_lambda)
        from ti_raytrace_tpu.utils.geometry import bk7_ior

        glass_ior = bk7_ior(spec_ctx.lam)
    g_dir, g_forb = glass_sample(u[0], d, hit.normal, glass_ior)
    d_dir = disney_sample(u[0:3], d, fnormal, hit.mat_p0, hit.mat_p1)
    d_brdf, d_pdf = disney_evaluate_pdf(fnormal, -d, d_dir, hit.mat_p0,
                                        hit.mat_p1, true_pdf=corrected)

    next_dir = pv.where(is_glass, g_dir, d_dir)
    f_or_b = jnp.where(is_glass, g_forb, 1.0)
    brdf = jnp.where(is_glass, 1.0, d_brdf)
    pdf_new = jnp.where(is_glass, 1.0, d_pdf)
    delta_v = jnp.where(is_glass, 1.0, 0.0)
    if not compacted:
        vt["delta"] = jnp.where(store, delta_v, vt["delta"])
    else:
        vt["delta"] = vt["delta"].at[idx_store].set(delta_v, mode="drop")

    ok = continue_mask & (pdf_new > 0.0)

    # reverse pdf of the PREVIOUS vertex (reference :179-180, :274-277)
    pdf_rev = jnp.where(
        is_glass, 0.0,
        _disney_pdf(fnormal, next_dir, -d, hit.mat_p0, hit.mat_p1,
                    true_pdf=corrected),
    )
    if corrected:
        # area measure at the PREVIOUS vertex -> its cosine
        geo_rev = jnp.abs(pv.dot(to, prev_normal)) * inv_d2
    else:
        # bit-identical to reading vt["normal"] back: the write below
        # the ok mask is hit.normal for every ok lane
        geo_rev = jnp.abs(pv.dot(to, hit.normal)) * inv_d2
    prev_ref = verts[depth - 1]
    rpdf_v = pdf_rev * geo_rev
    if not compacted:
        prev_ref["rpdf"] = jnp.where(ok, rpdf_v, prev_ref["rpdf"])
    else:
        idx_ok = jnp.where(ok, st["lane"], jnp.int32(N_full))
        prev_ref["rpdf"] = prev_ref["rpdf"].at[idx_ok].set(
            rpdf_v, mode="drop")

    beta_scale = jnp.where(
        is_glass,
        brdf,
        brdf * jnp.abs(pv.dot(hit.normal, next_dir)) / jnp.maximum(pdf_new, 1e-12),
    )
    beta = pv.where(ok, beta * reflect * beta_scale[None], beta)
    pdf_fwd = jnp.where(is_glass, 0.0, jnp.where(ok, pdf_new, pdf_fwd))

    # Beer-Lambert roulette on transmission (reference :182-186)
    beer_r = jnp.exp(-t / jnp.maximum(hit.mat_p1, 1e-12))
    beer_kill = (f_or_b < 0.0) & (u[4] >= beer_r)
    ok = ok & ~beer_kill

    o = pv.where(ok, pv.offset_ray(hit.pos, fnormal * pv.sign_nonzero(f_or_b)[None]), o)
    d = pv.where(ok, next_dir, d)
    alive = ok

    st["count"] = count
    st["o"], st["d"] = o, d
    st["beta"], st["pdf_fwd"], st["alive"] = beta, pdf_fwd, alive
    # next step's previous vertex == this depth's stored vertex
    zero3 = jnp.zeros_like(hit.pos)
    st["prev_pos"] = pv.where(store, hit.pos, zero3)
    st["prev_normal"] = pv.where(store, hit.normal, zero3)


def build_eye_path_rays(scene, o, d, key, spec_ctx=None,
                        eye_depth: int = EYE_MAX_DEPTH, fpdf0=None,
                        corrected: bool = False):
    """Eye subpath walk from explicit rays (o, d planar).

    fpdf0: per-lane camera direction pdf (solid angle).  The reference's
    weight machinery treats it as 1; the corrected estimator passes the
    pinhole pdf fx*fy/cos^3(theta) so eye[1].fpdf carries the real
    camera density."""
    N = o.shape[1]
    C_ = 1 if spec_ctx is not None else 3
    k_walk = key

    v0 = _empty_vertex(N)
    v0["pos"] = o
    v0["normal"] = d  # reference stores the ray direction (:114)
    v0["beta"] = jnp.ones((C_, N), jnp.float32)
    v0["fpdf"] = jnp.ones((N,), jnp.float32)
    v0["vtype"] = jnp.full((N,), V_LENS, jnp.int32)

    if fpdf0 is None:
        fpdf0 = jnp.ones((N,), jnp.float32)
    return _walk(
        scene, o, d, jnp.ones((C_, N), jnp.float32), fpdf0,
        v0, eye_depth, k_walk, is_light_path=False, spec_ctx=spec_ctx,
        corrected=corrected,
    )


def _camera_dir_pdf(spec, cam, d):
    """Pinhole direction pdf fx*fy/cos^3(theta) (per unit solid angle,
    film measured in pixels) for planar directions d."""
    axis = cam.view[2, :3]
    cos_t = jnp.maximum(
        jnp.abs(pv.dot(d, jnp.broadcast_to(axis[:, None], d.shape))), 1e-3
    )
    return spec.fx * spec.fy / (cos_t * cos_t * cos_t)


def build_eye_path(scene, spec, cam, frame, key, spec_ctx=None,
                   eye_depth: int = EYE_MAX_DEPTH, corrected: bool = False):
    k_cam, k_walk = jax.random.split(key)
    o = jnp.swapaxes(ray_origins(spec, cam), 0, 1)
    d = jnp.swapaxes(ray_directions(spec, cam, frame, k_cam), 0, 1)
    fpdf0 = _camera_dir_pdf(spec, cam, d) if corrected else None
    return build_eye_path_rays(scene, o, d, k_walk, spec_ctx, eye_depth,
                               fpdf0=fpdf0, corrected=corrected)


def _light_init(scene, N, k_sample, spec_ctx=None, corrected: bool = False):
    """Light subpath start: sampled emitter vertex + first ray.
    Returns (o, d, beta0, dir_pdf, v0)."""
    u6 = jax.random.uniform(k_sample, (6, N), dtype=jnp.float32)
    ls = sample_light(scene, u6)

    light_pdf = ls["choice_pdf"]
    v0 = _empty_vertex(N)
    v0["pos"] = ls["pos"]
    v0["normal"] = ls["normal"]
    v0["snormal"] = ls["normal"]
    if spec_ctx is None:
        emission = ls["emission"]
    else:
        emission = spec_ctx.light_power_sample(ls)
    v0["beta"] = emission / jnp.maximum(light_pdf, 1e-12)[None]
    v0["fpdf"] = light_pdf
    v0["wo"] = ls["direction"]
    v0["vtype"] = jnp.full((N,), V_LIGHT, jnp.int32)
    v0["prim"] = ls["prim"]

    beta0 = v0["beta"] * jnp.abs(pv.dot(ls["normal"], ls["direction"]))[None]
    if corrected:
        # standard light-subpath start: beta_1 = Le * cos0 /
        # (pdf_area * pdf_dir) (PBRT 16.3).  The reference never divides
        # by the emission-direction pdf (BDPT_RGB.py:214-232 carries
        # emission*cos/area_pdf only) — measured 0.2-0.28x deficit on
        # every l>=2 strategy (tools/bdpt_decompose.py --unweighted).
        beta0 = beta0 / jnp.maximum(ls["dir_pdf_std"], 1e-6)[None]
    o = ls["pos"]
    dir_pdf = ls["dir_pdf_std"] if corrected else ls["dir_pdf"]
    return o, ls["direction"], beta0, dir_pdf, v0


def build_light_path(scene, N, key, spec_ctx=None,
                     light_depth: int = LIGHT_MAX_DEPTH,
                     corrected: bool = False):
    k_sample, k_walk = jax.random.split(key)
    o, d, beta0, dir_pdf, v0 = _light_init(scene, N, k_sample, spec_ctx,
                                           corrected)
    return _walk(
        scene, o, d, beta0, dir_pdf, v0,
        light_depth, k_walk, is_light_path=True, spec_ctx=spec_ctx,
        corrected=corrected,
    )


def build_subpaths(scene, o, d, k_eye, k_light, spec_ctx=None,
                   eye_depth: int = EYE_MAX_DEPTH,
                   light_depth: int = LIGHT_MAX_DEPTH,
                   fpdf0=None, corrected: bool = False,
                   walk_compaction=None, return_overflow: bool = False):
    """Eye + light subpaths with each depth's two walk traces fused into
    ONE wavefront.  The walks are independent, so the tracer's fixed
    per-dispatch costs (coherence sort, kernel launch, unsort gathers)
    are paid once per depth instead of twice; per-lane hits are exact
    either way, so the estimator is unchanged vs the separate builders
    (same keys: k_eye == build_eye_path_rays' key, k_light ==
    build_light_path's).  Returns (eye, eye_count, light, light_count).

    walk_compaction: optional (eye_schedule, light_schedule), each the
    _walk compaction contract ((depth, divisor), ...).  The fused trace
    then runs at the sum of the two compacted front widths.  With
    return_overflow=True a fifth element counts live lanes dropped at
    capacity (0 == exact estimator)."""
    N = o.shape[1]
    C_ = 1 if spec_ctx is not None else 3
    sched_e, sched_l = (walk_compaction or (None, None))
    sched_e = dict(sched_e or ())
    sched_l = dict(sched_l or ())

    v0e = _empty_vertex(N)
    v0e["pos"] = o
    v0e["normal"] = d  # reference stores the ray direction (:114)
    v0e["beta"] = jnp.ones((C_, N), jnp.float32)
    v0e["fpdf"] = jnp.ones((N,), jnp.float32)
    v0e["vtype"] = jnp.full((N,), V_LENS, jnp.int32)
    if fpdf0 is None:
        fpdf0 = jnp.ones((N,), jnp.float32)
    st_e = _walk_state(o, d, jnp.ones((C_, N), jnp.float32), fpdf0, v0e,
                       eye_depth, spec_ctx)

    k_sample, k_lwalk = jax.random.split(k_light)
    lo, ld, lbeta0, ldir_pdf, v0l = _light_init(scene, N, k_sample, spec_ctx,
                                                corrected)
    st_l = _walk_state(lo, ld, lbeta0, ldir_pdf, v0l, light_depth, spec_ctx)

    overflow = jnp.int32(0)
    for depth in range(1, max(eye_depth, light_depth)):
        do_e = depth < eye_depth
        do_l = depth < light_depth
        if do_e and depth in sched_e:
            overflow = overflow + _compact_walk_front(
                st_e, _walk_width(N, sched_e[depth]))
        if do_l and depth in sched_l:
            overflow = overflow + _compact_walk_front(
                st_l, _walk_width(N, sched_l[depth]))
        o_te = (pv.where(st_e["alive"], st_e["o"],
                         jnp.full_like(st_e["o"], PARK)) if do_e else None)
        o_tl = (pv.where(st_l["alive"], st_l["o"],
                         jnp.full_like(st_l["o"], PARK)) if do_l else None)
        if do_e and do_l:
            we = o_te.shape[1]
            tt = trace_shaded(
                scene,
                jnp.concatenate([o_te, o_tl], axis=1),
                jnp.concatenate([st_e["d"], st_l["d"]], axis=1),
            )
            traced_e = tuple(x[..., :we] for x in tt)
            traced_l = tuple(x[..., we:] for x in tt)
        elif do_e:
            traced_e = trace_shaded(scene, o_te, st_e["d"])
        else:
            traced_l = trace_shaded(scene, o_tl, st_l["d"])
        if do_e:
            _walk_step(scene, st_e, depth, k_eye, False, spec_ctx,
                       corrected, o_te, traced_e)
        if do_l:
            _walk_step(scene, st_l, depth, k_lwalk, True, spec_ctx,
                       corrected, o_tl, traced_l)

    out = (st_e["verts"], st_e["count"], st_l["verts"], st_l["count"])
    return out + (overflow,) if return_overflow else out


def _remap0(f):
    return jnp.where(f == 0.0, 1.0, f)


def _mis_weight(eye, light, e, l, ov):
    """1 / (1 + sum of pdf-ratio products) — reference mis_weight:302-479,
    functional.  `ov` carries the per-connection endpoint overrides:
      eye_rpdf_e1, eye_rpdf_e2, light_rpdf_l1, light_rpdf_l2 (each (N,)
      or None), plus for l==1 the sample-vertex fpdf0."""
    if e + l == 2:
        return jnp.ones_like(eye[0]["fpdf"])

    def eye_rpdf(k):
        if k == e - 1 and ov.get("eye_rpdf_e1") is not None:
            return ov["eye_rpdf_e1"]
        if k == e - 2 and ov.get("eye_rpdf_e2") is not None:
            return ov["eye_rpdf_e2"]
        return eye[k]["rpdf"]

    def eye_delta(k):
        if k == e - 1:
            return jnp.zeros_like(eye[k]["delta"])
        return eye[k]["delta"]

    def light_rpdf(k):
        if k == l - 1 and ov.get("light_rpdf_l1") is not None:
            return ov["light_rpdf_l1"]
        if k == l - 2 and ov.get("light_rpdf_l2") is not None:
            return ov["light_rpdf_l2"]
        return light[k]["rpdf"]

    def light_fpdf(k):
        if k == 0 and l == 1 and ov.get("sample_fpdf0") is not None:
            return ov["sample_fpdf0"]
        return light[k]["fpdf"]

    def light_delta(k):
        if k == l - 1:
            return jnp.zeros_like(light[k]["delta"])
        if k == 0 and l == 1:
            return jnp.zeros_like(light[k]["delta"])
        return light[k]["delta"]

    ws = 0.0
    w = 1.0
    for k in range(e - 1, 0, -1):
        w = w * _remap0(eye_rpdf(k)) / _remap0(eye[k]["fpdf"])
        nd = (eye_delta(k) == 0.0) & (eye_delta(k - 1) == 0.0)
        ws = ws + jnp.where(nd, w, 0.0)

    w = 1.0
    for k in range(l - 1, -1, -1):
        w = w * _remap0(light_rpdf(k)) / _remap0(light_fpdf(k))
        if k == 0:
            nd = light_delta(0) == 0.0
        else:
            nd = (light_delta(k) == 0.0) & (light_delta(k - 1) == 0.0)
        ws = ws + jnp.where(nd, w, 0.0)

    return 1.0 / (1.0 + ws)


def _light_origin_pdf(ev):
    """(1/area)(1/light_count) of the emitter the eye path hit
    (reference light_origin_pdf:98-101)."""
    return 1.0 / jnp.maximum(ev["area"], 1e-12)


def _cos_in(v):
    """|wo . n| folded into every stored vertex beta (reference beta
    convention, BDPT_RGB.py:148-152/:160) — the corrected estimator
    divides it back out."""
    return jnp.maximum(jnp.abs(pv.dot(v["wo"], v["normal"])), 1e-6)


def _shadow_requests(scene, spec, cam, eye, eye_count, light, light_count,
                     key, pairs):
    """Build every connection strategy's shadow ray (pass 1 of
    _connections).  Returns (req_o, req_d, req_tmax, req_sel, req_tags)
    lists — one (3, N) origin/direction + (N,) distance bound + (N,)
    active mask per l>0 strategy.

    Every request carries its target distance as a tmax: visibility is
    decided by `sh_prim == target` and t is read only where the prim
    matches, so a hit beyond the bound can never satisfy the predicate —
    the cluster kernel seeds best_t with it (front-to-back pruning
    starts at the target, not at INF) and parked lanes get a tiny bound
    that prunes the whole scene.  Exact for the consumers (accel.trace).
    """
    N = eye[0]["pos"].shape[1]
    req_o, req_d, req_tmax, req_sel, req_tags = [], [], [], [], []
    parked_tmax = jnp.full((N,), 1e-3, jnp.float32)

    def _bound(sel, dist):
        return jnp.where(sel, dist * 1.001 + 1e-3, parked_tmax)

    for (e, l) in pairs:
        k = jax.random.fold_in(key, e * 16 + l)
        ev = eye[e - 1]
        active = (eye_count >= e) & ((light_count >= l) if l > 0 else True)
        if l == 0:
            continue
        if e == 1:
            lv = light[l - 1]
            _, _, wi_rows, vis = project(spec, cam, jnp.swapaxes(lv["pos"], 0, 1))
            wi = jnp.swapaxes(wi_rows, 0, 1)
            ndl = pv.dot(wi, lv["snormal"])
            sel = (
                active & vis & (lv["delta"] != 1.0) & (ndl < 0.0)
                & (lv["vtype"] == V_SURFACE)
            )
            cam_o = jnp.broadcast_to(cam.eye[:, None], (3, N))
            sh_o = pv.where(sel, cam_o, jnp.full((3, N), PARK))
            tdist = pv.length(lv["pos"] - cam_o)
            req_o.append(sh_o); req_d.append(wi)
            req_tmax.append(_bound(sel, tdist))
            req_sel.append(sel); req_tags.append((e, l))
        elif l == 1:
            u3 = jax.random.uniform(k, (3, N), dtype=jnp.float32)
            surface = pv.offset_ray(ev["pos"], ev["snormal"])
            ls = sample_li(scene, surface, u3)
            sel = active & (ev["delta"] != 1.0) & (ev["vtype"] == V_SURFACE)
            sh_o = pv.where(sel, surface, jnp.full((3, N), PARK))
            req_o.append(sh_o); req_d.append(-ls["direction"])
            req_tmax.append(_bound(sel, ls["dist"]))
            req_sel.append(sel); req_tags.append((e, l))
        else:
            lv = light[l - 1]
            sel = (
                active & (lv["delta"] != 1.0) & (ev["delta"] != 1.0)
                & (ev["vtype"] == V_SURFACE) & (lv["vtype"] == V_SURFACE)
            )
            dirv = ev["pos"] - lv["pos"]
            dist = jnp.maximum(pv.length(dirv), 1e-6)
            dirv = dirv * (1.0 / dist)[None]
            ndl_l = pv.dot(dirv, lv["snormal"])
            lv_from = pv.offset_ray(
                lv["pos"], lv["snormal"] * pv.sign_nonzero(ndl_l)[None]
            )
            sh_o = pv.where(sel, lv_from, jnp.full((3, N), PARK))
            req_o.append(sh_o); req_d.append(dirv)
            req_tmax.append(_bound(sel, dist))
            req_sel.append(sel); req_tags.append((e, l))
    return req_o, req_d, req_tmax, req_sel, req_tags


def _connections(scene, spec, cam, eye, eye_count, light, light_count, key,
                 spec_ctx=None, strategies=None, corrected: bool = False,
                 max_depth: int = MAX_DEPTH, unweighted: bool = False,
                 shadow_cap=None):
    """All (e, l) strategies; returns (radiance (C,N), splat image).

    strategies: optional host-side predicate `f(e, l) -> bool` selecting
    which strategy families to compile in — a debugging/diagnostic hook
    (tools/bdpt_decompose.py) passed explicitly, never read from the
    environment inside the jitted graph.

    corrected=False reproduces the reference's contribution formulas
    verbatim — which are NOT a consistent estimator: every connection
    edge's BSDF is divided by its sampling pdf as if it had been sampled
    (BDPT_RGB.py:516-517, :549-551, :583-585), stored betas fold an
    extra |cos| of the incoming direction, the l=0 emitter hit keeps
    that cosine, and the e=1 splat omits the pinhole importance.  The
    published goldens embody these, so they stay the default (PARITY.md
    has decomposition numbers: the reference's own veach BDPT golden is
    1.27x its own PT golden).  corrected=True restores the standard
    vertex-area-measure estimator: f (not f/pdf) on connection edges,
    betas un-cosined, l=0 without the cosine, and the e=1 splat carrying
    the pinhole importance fx*fy/cos^2 and the 1/N_paths normalization —
    BDPT then converges to PT (tests/test_golden.py)."""
    N = eye[0]["pos"].shape[1]
    C_ = 1 if spec_ctx is not None else 3
    radiance = jnp.zeros((C_, N), jnp.float32)
    splat = jnp.zeros((spec.width, spec.height, 3), jnp.float32)
    n_lights = jnp.float32(scene.n_lights)

    # subpath lengths available in the vertex pools (len(eye) == the walk's
    # eye_depth), strategy depth capped at max_depth
    pairs = [
        (e, l)
        for e in range(1, len(eye) + 1)
        for l in range(0, len(light) + 1)
        if not ((l == 1 and e == 1) or l + e - 2 < 0 or l + e - 2 > max_depth)
        and (strategies is None or strategies(e, l))
    ]

    # ---- pass 1: every strategy's shadow ray, traced as ONE wavefront.
    # ~28 sequential per-strategy traces dominated the BDPT frame (each
    # pays the tracer's fixed sort/launch costs at the full slice width);
    # one concatenated trace amortizes them ~28x.  The per-strategy RNG
    # keys and geometry are recomputed identically in pass 2 (the draws
    # are deterministic), so nothing else changes.
    # Every request also carries its target distance: visibility is
    # decided by `sh_prim == target` and t is read only where the prim
    # matches, so the tracer may treat the distance as a per-lane tmax —
    # hits beyond it can never satisfy the predicate.  The cluster
    # kernel seeds best_t with it (front-to-back pruning starts at the
    # target, not at INF), and parked lanes get a tiny bound that prunes
    # the whole scene.  Bit-exact for the consumers (accel.trace).
    occ = {}
    req_o, req_d, req_tmax, req_sel, req_tags = _shadow_requests(
        scene, spec, cam, eye, eye_count, light, light_count, key, pairs)
    # shadow_cap: None -> module default SHADOW_CAP; <= 0 -> disabled
    sc = SHADOW_CAP if shadow_cap is None else (
        shadow_cap if shadow_cap > 0 else None)
    if req_tags:
        # occupancy cap: parked lanes (sel=False) never reach the kernel
        # grid; their occ entries are undefined, and pass 2 only reads
        # occ under the same recomputed sel — safe under both tracers.
        t_all, prim_all = trace(
            scene, jnp.concatenate(req_o, 1), jnp.concatenate(req_d, 1),
            tmax=jnp.concatenate(req_tmax),
            active=(jnp.concatenate(req_sel) if sc is not None else None),
            cap_frac=sc,
        )
        for i, tag in enumerate(req_tags):
            occ[tag] = (t_all[i * N:(i + 1) * N], prim_all[i * N:(i + 1) * N])

    for (e, l) in pairs:
            depth = l + e - 2
            k = jax.random.fold_in(key, e * 16 + l)
            ev = eye[e - 1]
            active = (eye_count >= e) & ((light_count >= l) if l > 0 else True)

            contrib = jnp.zeros((C_, N), jnp.float32)
            ov = {}

            if l == 0:
                # eye path hit the light directly (reference :493-497)
                sel = active & (ev["vtype"] == V_LIGHT)
                beta_e = ev["beta"] / _cos_in(ev)[None] if corrected else ev["beta"]
                contrib = jnp.where(sel[None], beta_e, 0.0)
                ov["eye_rpdf_e1"] = _light_origin_pdf(ev) / n_lights
                if e > 1:
                    em = eye[e - 2]
                    to = em["pos"] - ev["pos"]
                    dist = jnp.maximum(pv.length(to), 1e-6)
                    to = to * (1.0 / dist)[None]
                    ldn = pv.dot(to, ev["normal"])
                    if corrected:
                        # standard: cos/pi at the light (no floor), area
                        # conversion with the cosine at the DESTINATION
                        cos_dst = jnp.where(
                            em["vtype"] == V_SURFACE,
                            jnp.abs(pv.dot(to, em["snormal"])), 1.0,
                        )
                        ov["eye_rpdf_e2"] = (
                            jnp.abs(ldn) / C.PI * cos_dst / (dist * dist)
                        )
                    else:
                        # reference: floored pdf x cosine at the SOURCE
                        ov["eye_rpdf_e2"] = jnp.abs(
                            _cos_pdf(jnp.abs(ldn)) * ldn
                        ) / (dist * dist)
                sel_any = sel

            elif e == 1:
                # light tracing: project the light vertex into the camera
                # (reference :499-521)
                lv = light[l - 1]
                px, py, wi_rows, vis = project(
                    spec, cam, jnp.swapaxes(lv["pos"], 0, 1)
                )
                wi = jnp.swapaxes(wi_rows, 0, 1)
                ndl = pv.dot(wi, lv["snormal"])
                sel = (
                    active
                    & vis
                    & (lv["delta"] != 1.0)
                    & (ndl < 0.0)
                    & (lv["vtype"] == V_SURFACE)
                )
                cam_o = jnp.broadcast_to(cam.eye[:, None], (3, N))
                _, sh_prim = occ[(e, l)]
                sel = sel & (sh_prim == lv["prim"])
                brdf, pdf = disney_evaluate_pdf(
                    lv["snormal"], -lv["wo"], -wi, lv["metallic"], lv["roughness"],
                    true_pdf=corrected,
                )
                tdist = jnp.maximum(pv.length(lv["pos"] - cam_o), 1e-6)
                g = jnp.abs(ndl) / (tdist * tdist)
                sel = sel & (pdf > 0.0)
                if corrected:
                    # pinhole importance: We = fx*fy / cos^3(theta) per
                    # unit pixel area; with G's cos(theta) at the lens
                    # this is fx*fy/cos^2; 1/N normalizes the N light
                    # subpaths this frame against the film's N pixels
                    axis_w = cam.view[2, :3]
                    cos_t = jnp.abs(pv.dot(-wi, jnp.broadcast_to(
                        axis_w[:, None], (3, N))))
                    cos_t = jnp.maximum(cos_t, 1e-3)
                    we = spec.fx * spec.fy / (cos_t * cos_t * jnp.float32(N))
                    contrib = jnp.where(
                        sel[None],
                        (g * we * brdf)[None]
                        * (lv["beta"] / _cos_in(lv)[None])
                        * lv["reflect"],
                        0.0,
                    )
                else:
                    contrib = jnp.where(
                        sel[None],
                        (g * brdf / jnp.maximum(pdf, 1e-12))[None]
                        * lv["beta"]
                        * lv["reflect"],
                        0.0,
                    )
                # overrides (sample vertex is the lens; eye[0] equals it)
                if l >= 1:
                    to = eye[0]["pos"] - lv["pos"]
                    dist = jnp.maximum(pv.length(to), 1e-6)
                    to = to * (1.0 / dist)[None]
                    axis = cam.view[2, :3]  # optical axis (get_optical_axis)
                    ldn = pv.dot(to, jnp.broadcast_to(axis[:, None], (3, N)))
                    if corrected:
                        # pinhole direction pdf fx*fy/cos^3 converted to
                        # area measure at lv with lv's cosine
                        cos_t = jnp.maximum(jnp.abs(ldn), 1e-3)
                        ov["light_rpdf_l1"] = (
                            spec.fx * spec.fy / (cos_t * cos_t * cos_t)
                            * jnp.abs(pv.dot(to, lv["snormal"]))
                            / (dist * dist)
                        )
                    else:
                        ov["light_rpdf_l1"] = ldn / (dist * dist)
                if l >= 2:
                    lm = light[l - 2]
                    wi2 = ev["pos"] - lv["pos"]
                    wo2 = lm["pos"] - lv["pos"]
                    dist2 = jnp.maximum(pv.length(wo2), 1e-6)
                    wi2 = pv.normalize(wi2)
                    wo2 = pv.normalize(wo2)
                    if corrected:
                        pdf2 = _disney_pdf(
                            lv["snormal"], wi2, wo2, lv["metallic"], lv["roughness"],
                            true_pdf=True,
                        )
                        cos_dst = jnp.where(
                            lm["vtype"] == V_NONE, 1.0,
                            jnp.abs(pv.dot(lm["normal"], wo2)),
                        )
                        ov["light_rpdf_l2"] = pdf2 * cos_dst / (dist2 * dist2)
                    else:
                        pdf2 = jnp.where(
                            _quirk_is_disney(lv),
                            _disney_pdf(lv["normal"], wi2, wo2, lv["metallic"], lv["roughness"]),
                            1.0,
                        )
                        geo = pdf2 / (dist2 * dist2)
                        geo = geo * jnp.where(
                            lm["vtype"] == V_SURFACE,
                            jnp.abs(pv.dot(lv["normal"], wo2)),
                            1.0,
                        )
                        ov["light_rpdf_l2"] = geo
                sel_any = sel
                # splat into the camera image at (px, py)
                mw = (jnp.ones((N,), jnp.float32) if unweighted
                      else _mis_weight(eye, light, e, l, ov))
                val = contrib * mw[None]
                if spec_ctx is not None:
                    val = spec_ctx.to_rgb(val)  # (3, N)
                flat = jnp.swapaxes(val, 0, 1)  # (N, 3)
                pxc = jnp.clip(px, 0, spec.width - 1)
                pyc = jnp.clip(py, 0, spec.height - 1)
                flat = jnp.where(sel[:, None], flat, 0.0)
                splat = splat.at[pxc, pyc].add(flat)
                continue

            elif l == 1:
                # NEE from the eye vertex with a fresh light sample
                # (reference :524-559)
                u3 = jax.random.uniform(k, (3, N), dtype=jnp.float32)
                surface = pv.offset_ray(ev["pos"], ev["snormal"])
                ls = sample_li(scene, surface, u3)
                wi = ls["direction"]
                ndl_l = pv.dot(wi, ls["normal"])
                ndl_e = pv.dot(wi, ev["snormal"])
                sel = active & (ev["delta"] != 1.0) & (ev["vtype"] == V_SURFACE)
                t_sh, sh_prim = occ[(e, l)]
                sel = sel & (sh_prim == ls["prim"]) & (t_sh > C.EPS)
                brdf, pdf = disney_evaluate_pdf(
                    ev["snormal"], -ev["wo"], -wi, ev["metallic"], ev["roughness"],
                    true_pdf=corrected,
                )
                sel = sel & (pdf > 0.0)
                g = jnp.abs(ndl_e * ndl_l) / jnp.maximum(t_sh * t_sh, 1e-12)
                if spec_ctx is None:
                    emission = ls["emission"]
                else:
                    emission = spec_ctx.light_power_sample(ls)
                beta_e = ev["beta"] / _cos_in(ev)[None] if corrected else ev["beta"]
                brdf_term = brdf if corrected else brdf / jnp.maximum(pdf, 1e-12)
                contrib = jnp.where(
                    sel[None],
                    g[None]
                    * beta_e
                    * brdf_term[None]
                    * ev["reflect"]
                    * emission
                    / jnp.maximum(ls["choice_pdf"], 1e-12)[None],
                    0.0,
                )
                # overrides: the sampled light IS light vertex 0 now
                to = ev["pos"] - ls["pos"]
                dist = jnp.maximum(pv.length(to), 1e-6)
                to = to * (1.0 / dist)[None]
                ldn = jnp.abs(pv.dot(to, ls["normal"]))
                ov["light_rpdf_l1"] = None  # replaced below as sample-based
                ov["sample_fpdf0"] = ls["choice_pdf"]
                if corrected:
                    # emission pdf cos/pi (no floor) x cosine at the EYE
                    # vertex (standard destination conversion)
                    ov["eye_rpdf_e1"] = (
                        ldn / C.PI
                        * jnp.abs(pv.dot(to, ev["snormal"]))
                        / (dist * dist)
                    )
                else:
                    ov["eye_rpdf_e1"] = _cos_pdf(ldn) * ldn / (dist * dist)
                # light.rpdf[0] (the sample) from the eye vertex (e>1 branch)
                if e > 1:
                    wi2 = eye[e - 2]["pos"] - ev["pos"]
                    wo2 = ls["pos"] - ev["pos"]
                    dist2 = jnp.maximum(pv.length(wo2), 1e-6)
                    wi2 = pv.normalize(wi2)
                    wo2 = pv.normalize(wo2)
                    if corrected:
                        pdf2 = _disney_pdf(
                            ev["snormal"], wi2, wo2, ev["metallic"], ev["roughness"],
                            true_pdf=True,
                        )
                        # destination is the sampled light point
                        ov["light_rpdf_l1"] = (
                            pdf2 * jnp.abs(pv.dot(ls["normal"], wo2))
                            / (dist2 * dist2)
                        )
                    else:
                        pdf2 = jnp.where(
                            _quirk_is_disney(ev),
                            _disney_pdf(ev["snormal"], wi2, wo2, ev["metallic"], ev["roughness"]),
                            1.0,
                        )
                        ov["light_rpdf_l1"] = (
                            pdf2 * jnp.abs(pv.dot(ev["normal"], wo2)) / (dist2 * dist2)
                        )
                else:
                    # e == 1 cannot reach here (skipped), guard anyway
                    ov["light_rpdf_l1"] = jnp.zeros((N,), jnp.float32)
                if e > 1:
                    # eye.rpdf[e-2] from the sampled light through ev
                    wi3 = ls["pos"] - ev["pos"]
                    wo3 = eye[e - 2]["pos"] - ev["pos"]
                    dist3 = jnp.maximum(pv.length(wo3), 1e-6)
                    wi3 = pv.normalize(wi3)
                    wo3 = pv.normalize(wo3)
                    pdf3 = _disney_pdf(
                        ev["snormal"], wi3, wo3, ev["metallic"], ev["roughness"],
                        true_pdf=corrected,
                    )
                    r = pdf3 / (dist3 * dist3)
                    if corrected:
                        r = r * jnp.where(
                            eye[e - 2]["vtype"] == V_SURFACE,
                            jnp.abs(pv.dot(eye[e - 2]["snormal"], wo3)),
                            1.0,
                        )
                    else:
                        r = r * jnp.where(
                            eye[e - 2]["vtype"] == V_SURFACE,
                            jnp.abs(pv.dot(ev["normal"], wo3)),
                            1.0,
                        )
                    ov["eye_rpdf_e2"] = jnp.where(
                        ev["vtype"] == V_SURFACE, r, 1.0
                    )
                sel_any = sel

            else:
                # surface-surface connection (reference :561-588)
                lv = light[l - 1]
                sel = (
                    active
                    & (lv["delta"] != 1.0)
                    & (ev["delta"] != 1.0)
                    & (ev["vtype"] == V_SURFACE)
                    & (lv["vtype"] == V_SURFACE)
                )
                dirv = ev["pos"] - lv["pos"]
                dist = jnp.maximum(pv.length(dirv), 1e-6)
                dirv = dirv * (1.0 / dist)[None]
                ndl_l = pv.dot(dirv, lv["snormal"])
                ndl_e = pv.dot(dirv, ev["snormal"])
                t_sh, sh_prim = occ[(e, l)]
                sel = sel & (sh_prim == ev["prim"]) & (t_sh > C.EPS)
                brdf_l, pdf_l = disney_evaluate_pdf(
                    lv["snormal"], -lv["wo"], dirv, lv["metallic"], lv["roughness"],
                    true_pdf=corrected,
                )
                brdf_e, pdf_e = disney_evaluate_pdf(
                    ev["snormal"], -ev["wo"], -dirv, ev["metallic"], ev["roughness"],
                    true_pdf=corrected,
                )
                sel = sel & (brdf_l > 0.0) & (brdf_e > 0.0)
                g = jnp.abs(ndl_e * ndl_l) / (dist * dist)
                contrib = jnp.where(
                    sel[None],
                    g[None]
                    * (ev["beta"] / _cos_in(ev)[None] if corrected else ev["beta"])
                    * (lv["beta"] / _cos_in(lv)[None] if corrected else lv["beta"])
                    * (brdf_l if corrected
                       else brdf_l / jnp.maximum(pdf_l, 1e-12))[None]
                    * (brdf_e if corrected
                       else brdf_e / jnp.maximum(pdf_e, 1e-12))[None]
                    * ev["reflect"]
                    * lv["reflect"],
                    0.0,
                )
                # overrides (reference :341-439 general branches)
                # eye.rpdf[e-1]: from light[l-1] toward ev
                wi2 = light[l - 2]["pos"] - lv["pos"] if l > 1 else -lv["wo"]
                wo2 = ev["pos"] - lv["pos"]
                dist2 = jnp.maximum(pv.length(wo2), 1e-6)
                wi2n = pv.normalize(wi2) if l > 1 else pv.normalize(wi2)
                wo2n = pv.normalize(wo2)
                if corrected:
                    pdf2 = _disney_pdf(
                        lv["snormal"], wi2n, wo2n, lv["metallic"], lv["roughness"],
                        true_pdf=True,
                    )
                    # destination is the eye vertex
                    ov["eye_rpdf_e1"] = (
                        pdf2 * jnp.abs(pv.dot(ev["snormal"], wo2n))
                        / (dist2 * dist2)
                    )
                else:
                    pdf2 = jnp.where(
                        _quirk_is_disney(lv),
                        _disney_pdf(lv["snormal"], wi2n, wo2n, lv["metallic"], lv["roughness"]),
                        1.0,
                    )
                    ov["eye_rpdf_e1"] = (
                        pdf2 * jnp.abs(pv.dot(lv["normal"], wo2n)) / (dist2 * dist2)
                    )
                # light.rpdf[l-1]: from ev toward light[l-1]
                if e > 1:
                    wi3 = eye[e - 2]["pos"] - ev["pos"]
                    wo3 = lv["pos"] - ev["pos"]
                    dist3 = jnp.maximum(pv.length(wo3), 1e-6)
                    wi3 = pv.normalize(wi3)
                    wo3 = pv.normalize(wo3)
                    if corrected:
                        pdf3 = _disney_pdf(
                            ev["snormal"], wi3, wo3, ev["metallic"], ev["roughness"],
                            true_pdf=True,
                        )
                        r3 = (
                            pdf3 * jnp.abs(pv.dot(lv["snormal"], wo3))
                            / (dist3 * dist3)
                        )
                    else:
                        pdf3 = jnp.where(
                            _quirk_is_disney(ev),
                            _disney_pdf(ev["snormal"], wi3, wo3, ev["metallic"], ev["roughness"]),
                            1.0,
                        )
                        r3 = pdf3 * jnp.abs(pv.dot(ev["normal"], wo3)) / (dist3 * dist3)
                    ov["light_rpdf_l1"] = jnp.where(ev["vtype"] == V_SURFACE, r3, 1.0)
                # eye.rpdf[e-2]: through ev toward eye[e-2]
                if e > 1:
                    wi4 = lv["pos"] - ev["pos"]
                    wo4 = eye[e - 2]["pos"] - ev["pos"]
                    dist4 = jnp.maximum(pv.length(wo4), 1e-6)
                    wi4 = pv.normalize(wi4)
                    wo4 = pv.normalize(wo4)
                    pdf4 = _disney_pdf(
                        ev["snormal"], wi4, wo4, ev["metallic"], ev["roughness"],
                        true_pdf=corrected,
                    )
                    r4 = pdf4 / (dist4 * dist4)
                    if corrected:
                        r4 = r4 * jnp.where(
                            eye[e - 2]["vtype"] == V_SURFACE,
                            jnp.abs(pv.dot(eye[e - 2]["snormal"], wo4)),
                            1.0,
                        )
                    else:
                        r4 = r4 * jnp.where(
                            eye[e - 2]["vtype"] == V_SURFACE,
                            jnp.abs(pv.dot(ev["normal"], wo4)),
                            1.0,
                        )
                    ov["eye_rpdf_e2"] = jnp.where(ev["vtype"] == V_SURFACE, r4, 1.0)
                # light.rpdf[l-2]: through light[l-1] toward light[l-2]
                if l > 1:
                    lm = light[l - 2]
                    wi5 = ev["pos"] - lv["pos"]
                    wo5 = lm["pos"] - lv["pos"]
                    dist5 = jnp.maximum(pv.length(wo5), 1e-6)
                    wi5 = pv.normalize(wi5)
                    wo5 = pv.normalize(wo5)
                    if corrected:
                        pdf5 = _disney_pdf(
                            lv["snormal"], wi5, wo5, lv["metallic"], lv["roughness"],
                            true_pdf=True,
                        )
                        r5 = pdf5 / (dist5 * dist5)
                        r5 = r5 * jnp.where(
                            lm["vtype"] == V_NONE, 1.0,
                            jnp.abs(pv.dot(lm["normal"], wo5)),
                        )
                    else:
                        pdf5 = jnp.where(
                            _quirk_is_disney(lv),
                            _disney_pdf(lv["normal"], wi5, wo5, lv["metallic"], lv["roughness"]),
                            1.0,
                        )
                        r5 = pdf5 / (dist5 * dist5)
                        r5 = r5 * jnp.where(
                            lm["vtype"] == V_SURFACE,
                            jnp.abs(pv.dot(lv["normal"], wo5)),
                            1.0,
                        )
                    ov["light_rpdf_l2"] = jnp.where(ev["vtype"] != V_LIGHT, r5, 1.0)
                sel_any = sel

            # MIS weight applies when all channels are positive
            # (reference :590-591; otherwise weight stays 1)
            pos_all = jnp.all(contrib > 0.0, axis=0)
            mw = (jnp.ones((N,), jnp.float32) if unweighted
                  else _mis_weight(eye, light, e, l, ov))
            mw = jnp.where(pos_all, mw, 1.0)
            radiance = radiance + contrib * mw[None]

    return radiance, splat


def render_paths(scene, spec: CameraSpec, cam, frame, key, spec_ctx=None,
                 corrected: bool = False, max_depth: int = MAX_DEPTH,
                 walk_compaction=None, shadow_cap=None):
    """Shared frame body: subpaths + connections -> (W, H, 3) radiance.

    max_depth is the strategy-depth cap (reference BDPT_RGB.py:23);
    subpath walk lengths derive from it (eye max_depth+2, light
    max_depth+1) exactly as the reference's module constants do."""
    N = spec.width * spec.height
    k_eye, k_light, k_conn = jax.random.split(key, 3)

    k_cam, k_ewalk = jax.random.split(k_eye)
    o = jnp.swapaxes(ray_origins(spec, cam), 0, 1)
    d = jnp.swapaxes(ray_directions(spec, cam, frame, k_cam), 0, 1)
    fpdf0 = _camera_dir_pdf(spec, cam, d) if corrected else None
    eye, eye_count, light, light_count = build_subpaths(
        scene, o, d, k_ewalk, k_light, spec_ctx,
        eye_depth=max_depth + 2, light_depth=max_depth + 1,
        fpdf0=fpdf0, corrected=corrected, walk_compaction=walk_compaction)
    radiance, splat = _connections(
        scene, spec, cam, eye, eye_count, light, light_count, k_conn, spec_ctx,
        corrected=corrected, max_depth=max_depth, shadow_cap=shadow_cap,
    )
    if spec_ctx is not None:
        radiance = spec_ctx.to_rgb(radiance)
    img = jnp.swapaxes(radiance, 0, 1).reshape(spec.width, spec.height, 3)
    return img + splat


@partial(jax.jit, static_argnames=("spec", "corrected", "max_depth",
                                   "walk_compaction"))
def render_frame(scene, spec: CameraSpec, cam, frame, key,
                 corrected: bool = False, max_depth: int = MAX_DEPTH,
                 walk_compaction=None):
    """One progressive BDPT frame -> (W, H, 3) radiance."""
    return render_paths(scene, spec, cam, frame, key, corrected=corrected,
                        max_depth=max_depth, walk_compaction=walk_compaction)


@partial(jax.jit,
         static_argnames=("spec", "n_slices", "max_depth", "shadow_cap",
                          "walk_compaction"))
def _render_slice(scene, spec: CameraSpec, cam, frame, key, n_slices: int,
                  slice_i, max_depth: int = MAX_DEPTH, shadow_cap=None,
                  walk_compaction=None):
    # slice_i is traced -> one compilation serves every slice
    N = spec.width * spec.height
    ns = N // n_slices
    k_cam, k_eye, k_light, k_conn = jax.random.split(key, 4)
    o_full = jnp.swapaxes(ray_origins(spec, cam), 0, 1)
    d_full = jnp.swapaxes(ray_directions(spec, cam, frame, k_cam), 0, 1)
    start = slice_i * ns
    o = jax.lax.dynamic_slice_in_dim(o_full, start, ns, axis=1)
    d = jax.lax.dynamic_slice_in_dim(d_full, start, ns, axis=1)
    eye, eye_count, light, light_count, overflow = build_subpaths(
        scene, o, d,
        jax.random.fold_in(k_eye, slice_i),
        jax.random.fold_in(k_light, slice_i),
        eye_depth=max_depth + 2, light_depth=max_depth + 1,
        walk_compaction=walk_compaction, return_overflow=True,
    )
    radiance, splat = _connections(
        scene, spec, cam, eye, eye_count, light, light_count,
        jax.random.fold_in(k_conn, slice_i), max_depth=max_depth,
        shadow_cap=shadow_cap,
    )
    return jnp.swapaxes(radiance, 0, 1), splat, overflow


def render_frame_sliced(scene, spec: CameraSpec, cam, frame, key,
                        n_slices: int = 2, max_depth: int = MAX_DEPTH,
                        shadow_cap=None, walk_compaction=None,
                        return_overflow: bool = False):
    """BDPT frame rendered in `n_slices` sequential lane slices: the
    13-vertex wavefront state of a full 512^2 frame is large, so each
    slice runs the whole pipeline on 1/n of the pixels (light-tracing
    splats still land on the full film).  One compile, n executions."""
    N = spec.width * spec.height
    parts = []
    splat_total = jnp.zeros((spec.width, spec.height, 3), jnp.float32)
    overflow_total = jnp.int32(0)
    for i in range(n_slices):
        rad, splat, ov = _render_slice(scene, spec, cam, frame, key, n_slices,
                                       jnp.int32(i), max_depth=max_depth,
                                       shadow_cap=shadow_cap,
                                       walk_compaction=walk_compaction)
        parts.append(rad)
        splat_total = splat_total + splat
        overflow_total = overflow_total + ov
    img = jnp.concatenate(parts, axis=0).reshape(spec.width, spec.height, 3)
    img = img + splat_total
    return (img, overflow_total) if return_overflow else img
