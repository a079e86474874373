"""Pinhole camera: host orbit controls + device wavefront ray generation.

Re-implements reference Camera.py.  The intrinsics follow the reference's
full-frame model (Camera.py:26-34): fx = focal * width / 2.4, principal
point at the image centre.  Rays are generated for the whole film at once;
the per-frame sub-pixel jitter (Camera.py:131-142, active when frame != 0)
comes from the stateless per-frame RNG key instead of `ti.random()`.

Film indexing convention matches the reference Taichi fields: arrays are
(W, H, ...) indexed [x, y] with y up (y=0 is the image bottom).
"""

from dataclasses import dataclass
from functools import lru_cache
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

FULL_HGT = 2.4  # full-frame sensor height (reference Camera.py:9)


@dataclass(frozen=True)
class CameraSpec:
    width: int
    height: int
    focal: float = 2.0

    @property
    def fx(self) -> float:
        return self.focal * self.width / FULL_HGT

    @property
    def fy(self) -> float:
        return self.fx

    @property
    def cx(self) -> float:
        return self.width * 0.5

    @property
    def cy(self) -> float:
        return self.height * 0.5


class CameraState(NamedTuple):
    view: jnp.ndarray      # (4,4) world -> camera
    view_inv: jnp.ndarray  # (4,4) camera -> world
    eye: jnp.ndarray       # (3,)


def orbit_camera(target, yaw: float, pitch: float, scale: float) -> CameraState:
    """Orbit-rig view matrix (reference Camera.update, Camera.py:70-93).

    eye = target + scale * (cos p sin y, sin p, cos p cos y); the up vector
    follows the pitch so the camera rolls with it, like the reference.
    """
    target = np.asarray(target, np.float64)
    pitch = float(np.clip(pitch, -1.57, 1.57))
    eye = target + scale * np.array(
        [np.cos(pitch) * np.sin(yaw), np.sin(pitch), np.cos(pitch) * np.cos(yaw)]
    )
    up = np.array(
        [-np.sin(pitch) * np.sin(yaw), np.cos(pitch), -np.sin(pitch) * np.cos(yaw)]
    )
    zaxis = eye - target
    zaxis /= np.linalg.norm(zaxis)
    xaxis = np.cross(up, zaxis)
    xaxis /= np.linalg.norm(xaxis)
    yaxis = np.cross(zaxis, xaxis)
    view = np.eye(4)
    view[0, :3], view[0, 3] = xaxis, -np.dot(xaxis, eye)
    view[1, :3], view[1, 3] = yaxis, -np.dot(yaxis, eye)
    view[2, :3], view[2, 3] = zaxis, -np.dot(zaxis, eye)
    return CameraState(
        view=jnp.asarray(view, jnp.float32),
        view_inv=jnp.asarray(np.linalg.inv(view), jnp.float32),
        eye=jnp.asarray(eye, jnp.float32),
    )


def orbit_yaw(target, yaw: float, pitch: float, scale: float, step=0.003,
              limit=3.14):
    """One step of the reference's yaw orbit animation
    (Camera.yaw_cam, Camera.py:54-59): returns (new_yaw, CameraState)."""
    new_yaw = yaw + step if yaw < limit else yaw
    return new_yaw, orbit_camera(target, new_yaw, pitch, scale)


def orbit_pitch(target, yaw: float, pitch: float, scale: float, step=0.003,
                limit=0.5):
    """One step of the pitch orbit animation (Camera.pitch_cam:62-67)."""
    new_pitch = pitch + step if pitch < limit else pitch
    return new_pitch, orbit_camera(target, yaw, new_pitch, scale)


def frame_scene_camera(aabb_min, aabb_max, yaw=0.0, pitch=0.0) -> CameraState:
    """The examples' auto-framing rule (cornell_box.py:26-30): target the
    AABB centre from 0.8 x diagonal away."""
    aabb_min = np.asarray(aabb_min, np.float64)
    aabb_max = np.asarray(aabb_max, np.float64)
    centre = 0.5 * (aabb_min + aabb_max)
    size = aabb_max - aabb_min
    scale = float(np.linalg.norm(size)) * 0.8
    return orbit_camera(centre, yaw, pitch, scale)


def ray_directions(spec: CameraSpec, cam: CameraState, frame, key) -> jnp.ndarray:
    """Primary ray directions for the full film, (W*H, 3), unit length.

    Lane n corresponds to pixel (x=n // H, y=n % H).  Jitter is a uniform
    +-0.5px box filter, disabled on frame 0 (reference Camera.py:135-137).
    """
    W, H = spec.width, spec.height
    xi = jnp.arange(W, dtype=jnp.float32)[:, None]  # (W,1)
    yi = jnp.arange(H, dtype=jnp.float32)[None, :]  # (1,H)
    jit = jax.random.uniform(key, (2, W, H), dtype=jnp.float32) - 0.5
    on = (jnp.asarray(frame) != 0).astype(jnp.float32)
    jx = jit[0] * on
    jy = jit[1] * on
    x = (xi + jx - spec.cx) / spec.fx  # (W,H)
    y = (yi + jy - spec.cy) / spec.fy
    d_cam = jnp.stack([x, y, -jnp.ones_like(x)], axis=-1)  # (W,H,3)
    r3 = cam.view_inv[:3, :3]
    d_world = jnp.matmul(d_cam, r3.T, precision=jax.lax.Precision.HIGHEST)
    d_world = d_world / jnp.linalg.norm(d_world, axis=-1, keepdims=True)
    return d_world.reshape(W * H, 3)


def ray_origins(spec: CameraSpec, cam: CameraState) -> jnp.ndarray:
    return jnp.broadcast_to(cam.eye, (spec.width * spec.height, 3))


@lru_cache(maxsize=None)
def morton_pixel_order(width: int, height: int):
    """Static Z-order pixel permutation for a (width, height) film.

    Returns host int32 arrays (perm, inv): lane n of a morton-ordered
    wavefront covers raster pixel perm[n] (raster id = x * height + y,
    matching ray_directions' lane convention), and inv[raster] = lane.
    Generating camera rays directly in this order makes every 256-lane
    ray tile a compact Z-order pixel block — the coherence the per-bounce
    sort used to restore, now for free (and statically, so the film/flush
    stay in lane space and no sort/unsort gathers run at bounce 0)."""
    xs = np.arange(width, dtype=np.uint32)[:, None]
    ys = np.arange(height, dtype=np.uint32)[None, :]

    def spread(v):
        # interleave zeros between bits (16 -> 32 bit spread)
        v = v.astype(np.uint64)
        v = (v | (v << 8)) & np.uint64(0x00FF00FF)
        v = (v | (v << 4)) & np.uint64(0x0F0F0F0F)
        v = (v | (v << 2)) & np.uint64(0x33333333)
        v = (v | (v << 1)) & np.uint64(0x55555555)
        return v

    code = (spread(xs) | (spread(ys) << np.uint64(1)))  # (W, H)
    perm = np.argsort(code.reshape(-1), kind="stable").astype(np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=np.int32)
    return perm, inv


def ray_directions_morton(spec: CameraSpec, cam: CameraState, frame,
                          key) -> jnp.ndarray:
    """ray_directions, permuted into static morton pixel order: lane n is
    pixel morton_pixel_order(W, H)[0][n], with the SAME per-pixel jitter
    as the raster path (identical ray set, permuted lanes).

    Computed natively in planar (3, N) form from the morton pixel
    coordinate constants — no gather.  Returns PLANAR (3, N),
    unlike ray_directions' (N, 3)."""
    W, H = spec.width, spec.height
    perm, _ = morton_pixel_order(W, H)
    px = jnp.asarray((perm // H).astype(np.float32))
    py = jnp.asarray((perm % H).astype(np.float32))
    return ray_directions_from_pixels(spec, cam, frame, key, px, py)


def ray_directions_from_pixels(spec: CameraSpec, cam: CameraState, frame,
                               key, px, py) -> jnp.ndarray:
    """Planar (3, n) primary directions for an arbitrary pixel-coordinate
    list (px, py) — the lane-sliceable core of ray_directions_morton.
    The sharded production renderer feeds each device its own morton
    lane slice (parallel/shard.py), so ray generation never materializes
    the full film on one device."""
    n = px.shape[0]
    jit = jax.random.uniform(key, (2, n), dtype=jnp.float32) - 0.5
    on = (jnp.asarray(frame) != 0).astype(jnp.float32)
    x = (px + jit[0] * on - spec.cx) / spec.fx  # (n,)
    y = (py + jit[1] * on - spec.cy) / spec.fy
    r3 = cam.view_inv[:3, :3]
    dw = (
        r3[:, 0:1] * x[None, :]
        + r3[:, 1:2] * y[None, :]
        - r3[:, 2:3]
    )                                           # (3, n) planar
    inv_len = jax.lax.rsqrt(dw[0] * dw[0] + dw[1] * dw[1] + dw[2] * dw[2])
    return dw * inv_len[None, :]


def project(spec: CameraSpec, cam: CameraState, p):
    """World point -> (pixel_x, pixel_y, wi, valid): the light-tracing
    splat projection (reference get_image_point, Camera.py:145-158)."""
    ph = jnp.concatenate([p, jnp.ones_like(p[..., :1])], axis=-1)
    pv = jnp.matmul(ph, cam.view.T, precision=jax.lax.Precision.HIGHEST)
    z = pv[..., 2]
    safe_z = jnp.where(jnp.abs(z) > 1e-12, z, -1e-12)
    u = (-pv[..., 0] / safe_z * spec.fx + spec.cx).astype(jnp.int32)
    v = (-pv[..., 1] / safe_z * spec.fy + spec.cy).astype(jnp.int32)
    valid = (u >= 0) & (u < spec.width) & (v >= 0) & (v < spec.height) & (z <= 0.0)
    wi = p - cam.eye
    wi = wi / jnp.maximum(jnp.linalg.norm(wi, axis=-1, keepdims=True), 1e-20)
    return u, v, wi, valid
