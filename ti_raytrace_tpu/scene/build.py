"""Host-side scene assembly: OBJ ingest -> SoA arrays -> BVH -> SceneData.

Covers the reference's Scene host path (Scene.py:59-310): material
classification, triangle emission, analytic shapes, light list, normal
generation, and BVH construction.  All list-building is replaced by
vectorized numpy; the per-frame device state is a single frozen pytree.
"""

import numpy as np

from ti_raytrace_tpu.accel.lbvh import build_bvh

# Version of the host-array format produced by build_host(): BVH layout,
# cluster packing (accel/clusters.py), attr pack rows (scene/packs.py).
# Bump on ANY change to those layouts — examples/scenes.benchmark_100k
# keys its on-disk scene cache by this constant.
BUILD_FORMAT_VERSION = 6  # v6: 32-tri clusters, 10-row triangle table
from ti_raytrace_tpu.core import constants as C
from ti_raytrace_tpu.io.image import read_image
from ti_raytrace_tpu.io.obj import load_obj
from ti_raytrace_tpu.scene.data import SceneData, device_scene


class MaterialRec:
    """Host material record (reference SceneData.Material)."""

    def __init__(self, mtype=C.MAT_DISNEY, color=(0, 0, 0), p0=0.0, p1=0.0, tex=-1):
        self.type = mtype
        self.color = list(color)
        self.p0 = p0  # metallic | ior
        self.p1 = p1  # roughness | extinction
        self.tex = tex


class ShapeRec:
    """Host analytic-shape record (reference SceneData.Shape)."""

    def __init__(self, stype, pos, param):
        self.type = stype
        self.pos = list(pos)
        self.param = list(param) + [0.0] * (6 - len(param))


def sphere_shape(pos, radius):
    return ShapeRec(C.SHAPE_SPHERE, pos, [radius])


def spot_shape(pos, normal, x1, x2, scale):
    return ShapeRec(C.SHAPE_SPOT, pos, [x1, x2, scale] + list(normal))


def laser_shape(pos, normal, radius):
    return ShapeRec(C.SHAPE_LASER, pos, [radius, 0.0, 0.0] + list(normal))


class SceneBuilder:
    def __init__(self):
        self.materials: list[MaterialRec] = []
        self.shapes: list[ShapeRec] = []
        # per-triangle-corner streams
        self._pos: list[np.ndarray] = []     # (T,3,3)
        self._nrm: list[np.ndarray] = []
        self._uv: list[np.ndarray] = []      # (T,3,2)
        self._tri_mat: list[np.ndarray] = []  # (T,)
        # shape prims: (shape_index, mat_index)
        self._shape_prims: list[tuple[int, int]] = []
        self.env_img = np.zeros((1, 1, 3), np.float32)
        self.env_power = 0.0
        self.aabb_min = np.full((3,), C.INF, np.float32)
        self.aabb_max = np.full((3,), -C.INF, np.float32)

    # ------------------------------------------------------------- ingest
    def add_obj(self, path: str):
        """Load an OBJ with the reference's material heuristic
        (Scene.py:72-84)."""
        mesh = load_obj(path)
        for m, tp, tn, tu in zip(mesh.materials, mesh.tri_pos, mesh.tri_normal, mesh.tri_uv):
            em = m.emissive
            if em[0] > 1.0 and em[1] > 1.0 and em[2] > 1.0:
                rec = MaterialRec(C.MAT_LIGHT, color=em)
            elif m.transparency > 0.99:
                rec = MaterialRec(
                    C.MAT_DISNEY, color=m.diffuse, p0=0.0, p1=0.5
                )
            else:
                rec = MaterialRec(
                    C.MAT_GLASS, color=m.diffuse, p0=m.optical_density, p1=m.shininess
                )
            mat_idx = len(self.materials)
            self.materials.append(rec)

            t = tp.shape[0]
            self._pos.append(tp)
            self._nrm.append(tn)
            self._uv.append(tu)
            self._tri_mat.append(np.full((t,), mat_idx, np.int32))
            if t:
                self.aabb_min = np.minimum(self.aabb_min, tp.reshape(-1, 3).min(0))
                self.aabb_max = np.maximum(self.aabb_max, tp.reshape(-1, 3).max(0))

    def add_triangles(self, pos, nrm, uv, mat: MaterialRec):
        """Add a procedural triangle soup under one material.
        pos/nrm: (T,3,3); uv: (T,3,2)."""
        mat_idx = len(self.materials)
        self.materials.append(mat)
        pos = np.asarray(pos, np.float32)
        self._pos.append(pos)
        self._nrm.append(np.asarray(nrm, np.float32))
        self._uv.append(np.asarray(uv, np.float32))
        self._tri_mat.append(np.full((pos.shape[0],), mat_idx, np.int32))
        if pos.shape[0]:
            self.aabb_min = np.minimum(self.aabb_min, pos.reshape(-1, 3).min(0))
            self.aabb_max = np.maximum(self.aabb_max, pos.reshape(-1, 3).max(0))

    def add_shape(self, shape: ShapeRec, mat: MaterialRec):
        """(reference Scene.add_shape, Scene.py:188-205)."""
        self._shape_prims.append((len(self.shapes), len(self.materials)))
        self.shapes.append(shape)
        self.materials.append(mat)

    def write_debug_obj(self, path: str):
        """Dump the accumulated triangle soup as an OBJ for inspection
        (reference Scene.write_data_debug, Scene.py:209-220)."""
        pos, nrm, _, _ = self._concat_tris()
        with open(path, "w") as f:
            for t in range(pos.shape[0]):
                for c in range(3):
                    f.write("v %f %f %f\n" % tuple(pos[t, c]))
                    f.write("vn %f %f %f\n" % tuple(nrm[t, c]))
            for t in range(pos.shape[0]):
                i = 3 * t + 1
                f.write(f"f {i}//{i} {i+1}//{i+1} {i+2}//{i+2}\n")

    def add_env(self, path: str, power: float):
        img = read_image(path)[::-1].copy()  # row 0 at bottom
        self.env_img = img
        self.env_power = float(power)

    # ------------------------------------------------------------- build
    def _concat_tris(self):
        if self._pos:
            pos = np.concatenate(self._pos, 0)
            nrm = np.concatenate(self._nrm, 0)
            uv = np.concatenate(self._uv, 0)
            mat = np.concatenate(self._tri_mat, 0)
        else:
            pos = np.zeros((0, 3, 3), np.float32)
            nrm = np.zeros((0, 3, 3), np.float32)
            uv = np.zeros((0, 3, 2), np.float32)
            mat = np.zeros((0,), np.int32)
        return pos, nrm, uv, mat

    def build(self, smooth_normals: bool = False, spectral: bool = False) -> SceneData:
        return device_scene(self.build_host(smooth_normals, spectral))

    def build_host(self, smooth_normals: bool = False, spectral: bool = False) -> dict:
        """Assemble the full host-side array dict (everything device_scene
        needs) — separable so callers can cache it to disk (np.savez) and
        skip the ~10 s mesh/BVH/cluster build on re-runs."""
        pos, nrm, uv, tri_mat = self._concat_tris()
        T = pos.shape[0]
        S = len(self.shapes)
        P = T + len(self._shape_prims)
        assert P > 0, "empty scene"

        # face normals where the OBJ had none (reference cal_normal,
        # Scene.py:169-180)
        e1 = pos[:, 1] - pos[:, 0]
        e2 = pos[:, 2] - pos[:, 0]
        fn = np.cross(e1, e2)
        fn_len = np.linalg.norm(fn, axis=-1, keepdims=True)
        fn = fn / np.maximum(fn_len, 1e-20)
        has_n = np.linalg.norm(nrm[:, 0], axis=-1) > 0.0
        nrm = np.where(has_n[:, None, None], nrm, fn[:, None, :])

        if smooth_normals and T:
            nrm = _smooth_normals(pos, nrm)

        # triangle areas (Heron, reference Scene.py:325-338)
        a = np.linalg.norm(pos[:, 0] - pos[:, 1], axis=-1)
        b = np.linalg.norm(pos[:, 0] - pos[:, 2], axis=-1)
        c = np.linalg.norm(pos[:, 2] - pos[:, 1], axis=-1)
        s = 0.5 * (a + b + c)
        tri_area = np.sqrt(np.maximum(s * (s - a) * (s - b) * (s - c), 0.0))

        # primitives: triangles first, then shapes (reference appends
        # shapes via add_shape after add_obj)
        prim_type = np.concatenate(
            [
                np.full((T,), C.PRIM_TRI, np.int32),
                np.full((P - T,), C.PRIM_SHAPE, np.int32),
            ]
        )
        prim_vidx = np.concatenate(
            [
                (np.arange(T, dtype=np.int32) * 3),
                np.asarray([s_i for s_i, _ in self._shape_prims], np.int32),
            ]
        )
        prim_mat = np.concatenate(
            [tri_mat, np.asarray([m_i for _, m_i in self._shape_prims], np.int32)]
        )

        # shape areas: pi r^2 for sphere/spot/laser — the reference's
        # get_prim_area quirk (Scene.py:341-349), kept for emission parity
        shape_area = np.zeros((P - T,), np.float32)
        for k, (s_i, _) in enumerate(self._shape_prims):
            sh = self.shapes[s_i]
            shape_area[k] = np.pi * sh.param[0] * sh.param[0]
        prim_area = np.concatenate([tri_area.astype(np.float32), shape_area])

        # light list (prims whose material is MAT_LIGHT, reference
        # Scene.py:136-138 and add_shape)
        mat_type_np = np.asarray([m.type for m in self.materials], np.int32)
        light_prim = np.nonzero(mat_type_np[prim_mat] == C.MAT_LIGHT)[0].astype(np.int32)
        if light_prim.shape[0] == 0:
            light_prim = np.zeros((1,), np.int32)  # keep shapes static; unused

        # per-prim AABBs for the BVH
        prim_min = np.zeros((P, 3), np.float32)
        prim_max = np.zeros((P, 3), np.float32)
        if T:
            prim_min[:T] = pos.min(axis=1)
            prim_max[:T] = pos.max(axis=1)
        for k, (s_i, _) in enumerate(self._shape_prims):
            sh = self.shapes[s_i]
            p0 = np.asarray(sh.pos, np.float32)
            r = sh.param[0] if sh.type == C.SHAPE_SPHERE else 0.0
            prim_min[T + k] = p0 - r
            prim_max[T + k] = p0 + r

        aabb_min = self.aabb_min.copy()
        aabb_max = self.aabb_max.copy()
        if not np.all(aabb_min <= aabb_max):  # shapes-only scene
            aabb_min = prim_min.min(0)
            aabb_max = prim_max.max(0)

        bvh = build_bvh(prim_min, prim_max, aabb_min, aabb_max)

        if S == 0:
            shape_type = np.zeros((1,), np.int32)
            shape_pos = np.zeros((1, 3), np.float32)
            shape_param = np.zeros((1, 6), np.float32)
        else:
            shape_type = np.asarray([sh.type for sh in self.shapes], np.int32)
            shape_pos = np.asarray([sh.pos for sh in self.shapes], np.float32)
            shape_param = np.asarray([sh.param for sh in self.shapes], np.float32)

        env = self.env_img
        if self.env_power == 0.0:
            env = np.zeros((1, 1, 3), np.float32)  # reference loads black.png

        host = dict(
            mat_type=mat_type_np,
            mat_tex=np.asarray([m.tex for m in self.materials], np.int32),
            mat_color=np.asarray([m.color for m in self.materials], np.float32),
            mat_p0=np.asarray([m.p0 for m in self.materials], np.float32),
            mat_p1=np.asarray([m.p1 for m in self.materials], np.float32),
            prim_type=prim_type,
            prim_vidx=prim_vidx,
            prim_mat=prim_mat,
            prim_area=prim_area,
            tri_v0=np.concatenate([pos[:, 0], np.zeros((P - T, 3), np.float32)]),
            tri_e1=np.concatenate([e1, np.zeros((P - T, 3), np.float32)]),
            tri_e2=np.concatenate([e2, np.zeros((P - T, 3), np.float32)]),
            vtx_pos=pos.reshape(-1, 3) if T else np.zeros((3, 3), np.float32),
            vtx_normal=nrm.reshape(-1, 3) if T else np.zeros((3, 3), np.float32),
            vtx_uv=uv.reshape(-1, 2) if T else np.zeros((3, 2), np.float32),
            shape_type=shape_type,
            shape_pos=shape_pos,
            shape_param=shape_param,
            light_prim=light_prim,
            env_img=env,
            env_power=np.float32(self.env_power),
            bvh_min=bvh["bvh_min"],
            bvh_max=bvh["bvh_max"],
            bvh_prim=bvh["bvh_prim"],
            bvh_escape=bvh["bvh_escape"],
            aabb_min=aabb_min,
            aabb_max=aabb_max,
        )
        from ti_raytrace_tpu.accel.clusters import build_clusters
        from ti_raytrace_tpu.scene.packs import build_light_attr, build_prim_attr

        host["prim_attr"] = build_prim_attr(host, spectral=spectral)
        host["light_attr"] = build_light_attr(host, spectral=spectral)
        host.update(build_clusters(host))
        return host


def _smooth_normals(pos, nrm):
    """Area+angle-weighted normal smoothing across coincident vertices
    (reference process_normal, Scene.py:754-798 — which uses the BVH as a
    spatial hash; here a positional hash does the same join).

    pos/nrm: (T,3,3).  Neighbour normals only contribute when they agree
    with the vertex normal (dot > 0.5), like the reference.
    """
    T = pos.shape[0]
    flat_pos = pos.reshape(-1, 3)
    flat_nrm = nrm.reshape(-1, 3)
    ln = np.linalg.norm(flat_nrm, axis=-1, keepdims=True)
    unit_n = flat_nrm / np.maximum(ln, 1e-20)

    # corner angles and areas
    v0, v1, v2 = pos[:, 0], pos[:, 1], pos[:, 2]

    def corner_angle(a, b, c):
        e1 = b - a
        e2 = c - a
        e1 /= np.maximum(np.linalg.norm(e1, axis=-1, keepdims=True), 1e-20)
        e2 /= np.maximum(np.linalg.norm(e2, axis=-1, keepdims=True), 1e-20)
        return np.arccos(np.clip(np.sum(e1 * e2, -1), -1.0, 1.0))

    ang = np.stack(
        [corner_angle(v0, v1, v2), corner_angle(v1, v0, v2), corner_angle(v2, v0, v1)],
        axis=1,
    ).reshape(-1)
    e1 = v1 - v0
    e2 = v2 - v0
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
    area3 = np.repeat(area, 3)

    w = (ang * area3)[:, None] * unit_n  # weighted contribution per corner

    key = np.round(flat_pos / 1e-5).astype(np.int64)
    _, group, inv = np.unique(key, axis=0, return_index=True, return_inverse=True)

    # accumulate per group with the agreement test against each member's
    # own normal: O(sum of group_size^2) via a sparse double loop over
    # groups — groups are tiny (valence of a vertex).
    order = np.argsort(inv, kind="stable")
    sorted_inv = inv[order]
    boundaries = np.nonzero(np.diff(sorted_inv))[0] + 1
    starts = np.concatenate([[0], boundaries])
    ends = np.concatenate([boundaries, [sorted_inv.shape[0]]])

    out = np.zeros_like(flat_nrm)
    for s, e in zip(starts, ends):
        idx = order[s:e]
        nn = unit_n[idx]          # (g,3) member unit normals
        ww = w[idx]               # (g,3) weighted contributions
        agree = nn @ nn.T > 0.5   # (g,g)
        np.fill_diagonal(agree, True)
        acc = agree.astype(np.float32) @ ww
        out[idx] = acc
    out /= np.maximum(np.linalg.norm(out, axis=-1, keepdims=True), 1e-20)
    return out.reshape(T, 3, 3)
