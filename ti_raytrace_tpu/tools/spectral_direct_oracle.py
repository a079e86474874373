"""First-principles direct-lighting oracle for the spectral cornell box.

Computes, with plain numpy quadrature (no renderer on either side), the
expected DISPLAY value of a directly-lit wall patch: lamp quad emission
E(lam) = ||Ke||_2 * D65_norm(lam) (the saturated-tint quirk, PARITY.md
'rgb2spec unit mismatch'), measured-SPD reflectance, the reference's
Disney diffuse lobe (brdf/Disney.py:66-108 Fd terms), the hero-sampling
CIE splat (PT_Spec.AddSplat with its span/4 = 470/4 factor), and the
ACES(0.5)+sRGB display transform (Example.py:43).

Then samples the SAME patch pixels from the reference golden and from a
render of ours, so the three-way comparison attributes any deficit to
"reference golden embodies X" vs "our transport loses X" with no
circular reasoning.  Direct light only — pick patches where one bounce
dominates (the oracle is a lower bound; indirect adds on top).

Run (host, no accelerator needed for the oracle itself):
  python -m ti_raytrace_tpu.tools.spectral_direct_oracle [--image OURS.png]
"""

import argparse
import sys

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def schlick(u):
    m = np.clip(1.0 - u, 0.0, 1.0)
    return m ** 5


def disney_diffuse_eval(n, v, l, roughness):
    """The reference's diffuse-lobe scalar (brdf/Disney.py:91-101 with
    metal=0): (Fsheen + 1/pi) * Fd, Csheen = 0.5."""
    ndl = float(np.dot(n, l))
    ndv = float(np.dot(n, v))
    if ndl <= 0.0 or ndv <= 0.0:
        return 0.0
    h = (l + v) / np.linalg.norm(l + v)
    ldh = float(np.dot(l, h))
    fl, fv, fh = schlick(ndl), schlick(ndv), schlick(ldh)
    fd90 = 0.5 + 2.0 * ldh * ldh * roughness
    fd = (1.0 + (fd90 - 1.0) * fl) * (1.0 + (fd90 - 1.0) * fv)
    fsheen = fh * 0.5
    return (fsheen + 1.0 / np.pi) * fd


def lamp_quad_and_patches():
    """Lamp triangles + probe patches from the reference OBJ."""
    from ti_raytrace_tpu.io.assets import asset_path
    from ti_raytrace_tpu.io.obj import load_obj

    mesh = load_obj(asset_path("model/cornell_box.obj"))
    light_id = next(
        i for i, m in enumerate(mesh.materials)
        if max(m.emissive) > 0.0
    )
    lamp = np.asarray(mesh.tri_pos[light_id])  # (T, 3, 3)
    return mesh, lamp, light_id


def _occluded(p, q, tris):
    """Any of tris (T,3,3) blocks segment p->q (Moller-Trumbore)."""
    d = q - p
    tmax = 1.0 - 1e-4
    v0 = tris[:, 0]
    e1 = tris[:, 1] - v0
    e2 = tris[:, 2] - v0
    pv = np.cross(d[None, :], e2)
    det = (e1 * pv).sum(1)
    ok = np.abs(det) > 1e-12
    inv = 1.0 / np.where(ok, det, 1.0)
    tv = p[None, :] - v0
    u = (tv * pv).sum(1) * inv
    qv = np.cross(tv, e1)
    v = (d[None, :] * qv).sum(1) * inv
    t = (e2 * qv).sum(1) * inv
    hit = ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & \
        (t > 1e-4) & (t < tmax)
    return bool(hit.any())


def integrate_direct(p, n, cam_pos, lamp_tris, emission_scale, occ_tris,
                     rough=0.5, grid=24):
    """Scalar direct transport factor at patch point p: the lambda-
    independent part sum_lamp brdf(cam, wl) * cos_s * cos_l / r^2 dA,
    with occlusion against occ_tris.  Emission spectrum multiplies
    outside."""
    v = cam_pos - p
    v = v / np.linalg.norm(v)
    total = 0.0
    occluded_n = 0
    samples_n = 0
    for tri in lamp_tris:
        a, b, c = tri
        area = 0.5 * np.linalg.norm(np.cross(b - a, c - a))
        ln = np.cross(b - a, c - a)
        ln = ln / np.linalg.norm(ln)
        us = (np.arange(grid) + 0.5) / grid
        for u1 in us:
            for u2 in us:
                uu, vv = (u1, u2) if u1 + u2 <= 1.0 else (1 - u1, 1 - u2)
                q = a + (b - a) * uu + (c - a) * vv
                d = q - p
                r2 = float(np.dot(d, d))
                wl = d / np.sqrt(r2)
                cos_s = float(np.dot(n, wl))
                cos_l = abs(float(np.dot(ln, wl)))
                if cos_s <= 0.0:
                    continue
                samples_n += 1
                if _occluded(p, q, occ_tris):
                    occluded_n += 1
                    continue
                brdf = disney_diffuse_eval(n, v, wl, rough)
                total += brdf * cos_s * cos_l / r2 * (2.0 * area / grid / grid)
    log(f"  occluded {occluded_n}/{samples_n} lamp samples")
    return total * emission_scale


def display_value(l_scalar, refl_spd, sensor, d65n):
    """Hero-sampled CIE splat of L(lam) = l_scalar * refl(lam) * D65n(lam)
    -> expected display sRGB, averaged over the lambda0 distribution."""
    from ti_raytrace_tpu.utils.colorsp import lrgb_to_srgb, tone_aces

    span = sensor.lambda_max - sensor.lambda_min
    lam0 = np.linspace(360.0, 460.0, 256, endpoint=False)
    lam4 = lam0[:, None] + np.arange(4)[None, :] * 100.0  # (256, 4)
    L = l_scalar * refl_spd.sample(lam4) * d65n.sample(lam4)  # (256, 4)
    xyz_bar = sensor.sample(lam4.reshape(-1)).reshape(256, 4, 3)
    xyz = (xyz_bar * L[..., None]).sum(axis=1) * (span / 4.0)  # (256, 3)
    xyz = xyz.mean(axis=0)
    from ti_raytrace_tpu.core import constants as C

    lrgb = np.asarray(C.XYZ_TO_SRGB) @ xyz
    disp = np.clip(lrgb_to_srgb(tone_aces(np.maximum(lrgb, 0.0) * 0.5)), 0, 1)
    return disp, lrgb


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--image", default=None,
                    help="our rendered PNG (e.g. /tmp/spectral_box.png)")
    ap.add_argument("--rough", type=float, default=0.5)
    args = ap.parse_args(argv)

    from ti_raytrace_tpu.io.assets import asset_path
    from ti_raytrace_tpu.spectral.cie import load_cie_sensor, load_d65, white_point
    from ti_raytrace_tpu.spectral.spd import load_spd_csv

    sensor = load_cie_sensor()
    d65 = load_d65()
    wp = white_point(sensor, d65)
    from ti_raytrace_tpu.spectral.spd import Spd

    d65n = Spd(d65.lambdas, d65.values / wp[1])
    white = load_spd_csv(asset_path("spectrum/white-spec.csv"))

    mesh, lamp, light_id = lamp_quad_and_patches()
    occ = np.concatenate(
        [np.asarray(t) for i, t in enumerate(mesh.tri_pos)
         if len(t) and i != light_id], axis=0)
    allv = occ.reshape(-1, 3)
    lo = allv.min(axis=0)
    hi = allv.max(axis=0)
    centre = 0.5 * (lo + hi)

    # the actual example camera (scenes.spectral_box -> make_camera)
    import jax.numpy as jnp

    from ti_raytrace_tpu.camera import project
    from ti_raytrace_tpu.examples.scenes import EXAMPLES, make_camera

    scene, cfg = EXAMPLES["spectral_box"]()
    spec, cam = make_camera(scene, cfg, 512, 512)
    cam_pos = np.asarray(cam.eye)

    emission_scale = float(np.linalg.norm([10.0, 10.0, 10.0]))

    # probes on the back wall (white measured SPD, faces +z toward cam):
    # upper (above the boxes, unshadowed) and mid-height
    back_z = lo[2]
    probes = [
        ("back-wall-upper", np.asarray(
            [centre[0], lo[1] + 0.75 * (hi[1] - lo[1]), back_z + 1e-3]),
         np.asarray([0.0, 0.0, 1.0])),
        ("back-wall-mid", np.asarray(
            [centre[0] * 0.8, lo[1] + 0.45 * (hi[1] - lo[1]), back_z + 1e-3]),
         np.asarray([0.0, 0.0, 1.0])),
    ]

    from ti_raytrace_tpu.tools.golden import load_reference

    ref = load_reference("image/spectral-cornellbox.png")[..., :3]
    ours = None
    if args.image:
        from ti_raytrace_tpu.io.image import read_image

        ours = read_image(args.image)[..., :3]

    for name, p, n in probes:
        tf = integrate_direct(p, n, cam_pos, lamp, emission_scale, occ,
                              args.rough)
        disp = display_value(tf, white, sensor, d65n)
        u, v, _, valid = project(spec, cam, jnp.asarray(p))
        px, py = int(u), int(v)
        # film (x, y) with y up -> image row = H-1-y
        row = 512 - 1 - py
        print(f"{name}: pixel (x={px}, row={row}, valid={bool(valid)}) "
              f"transport {tf:.5f}")
        print(f"  oracle direct-only sRGB: {disp}")
        patch = ref[max(row - 6, 0):row + 6, max(px - 6, 0):px + 6]
        print(f"  golden patch mean rgb:   {patch.mean(axis=(0, 1))}")
        if ours is not None:
            op = ours[max(row - 6, 0):row + 6, max(px - 6, 0):px + 6]
            print(f"  ours   patch mean rgb:   {op.mean(axis=(0, 1))}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
