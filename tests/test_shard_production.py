"""Sharded PRODUCTION path: render_film_frames_merged_sharded must equal
the same computation run shard-by-shard on one device (the mirror
discipline of the sharded-BDPT proof, test_render.py) — compaction,
merged groups, morton camera and the film key chain all included.

The PT sharding test asserts only shape/non-blackness; this is the
bit-exact equivalence proof for the shipped path (chip_smoke.py --four
runs the same comparison on four cards)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ti_raytrace_tpu.camera import morton_pixel_order
from ti_raytrace_tpu.examples.scenes import EXAMPLES, make_camera
from ti_raytrace_tpu.parallel.shard import (
    LaneFilm,
    _merged_lane_shard,
    lane_film_image,
    make_mesh,
    new_lane_film,
    render_film_frames_merged_sharded,
    replicate_scene,
)

SIZE = 32
KF = 2
GROUP = 2
COMPACTION = ((1, 2),)


@pytest.fixture(scope="module")
def cornell():
    scene, cfg = EXAMPLES["cornell_box"]()
    spec, cam = make_camera(scene, cfg, SIZE, SIZE)
    return scene, cfg, spec, cam


def test_sharded_merged_matches_per_shard(cornell):
    scene, _, spec, cam = cornell
    mesh = make_mesh()
    scene_r = replicate_scene(scene, mesh)
    fl = new_lane_film(spec, mesh, seed=3)
    # the film is DONATED to the render dispatch — keep independent
    # copies of the starting key/frame for the mirror
    key0 = jax.random.PRNGKey(3)
    frame0 = jnp.zeros((), jnp.int32)

    fl2, overflow = render_film_frames_merged_sharded(
        scene_r, spec, cam, fl, KF, GROUP, COMPACTION, True, mesh
    )
    img = np.asarray(lane_film_image(fl2, spec))
    assert int(fl2.frame) == KF
    assert img.shape == (SIZE, SIZE, 3)
    assert img.mean() > 0.0
    assert int(overflow) == 0

    # mirror: the exact same per-shard computation, one shard at a time
    W, H = spec.width, spec.height
    N = W * H
    perm, _ = morton_pixel_order(W, H)
    px = jnp.asarray((perm // H).astype(np.float32))
    py = jnp.asarray((perm % H).astype(np.float32))
    ns = N // mesh.size
    hdr_parts = []

    # one jit, same shapes per shard: compile once, execute 8x (unjitted
    # this mirror loop was 111 s of the quick tier)
    @jax.jit
    def one_shard(scene_, cam_, key_, i, px_sl, py_sl):
        return _merged_lane_shard(
            scene_, spec, cam_, jnp.zeros((3, ns), jnp.float32),
            frame0, key_, i, px_sl, py_sl,
            KF, GROUP, COMPACTION, True,
        )

    for i in range(mesh.size):
        sl = slice(i * ns, (i + 1) * ns)
        hdr_i, frame_i, key_i, ov_i = one_shard(
            scene, cam, key0, jnp.int32(i), px[sl], py[sl])
        hdr_parts.append(np.asarray(hdr_i))
        assert int(frame_i) == KF
    hdr_ref = np.concatenate(hdr_parts, axis=1)
    np.testing.assert_array_equal(np.asarray(fl2.hdr), hdr_ref)


def test_lane_film_image_unpermute(cornell):
    """lane_film_image inverts the morton lane order exactly."""
    _, _, spec, _ = cornell
    N = spec.width * spec.height
    perm, _ = morton_pixel_order(spec.width, spec.height)
    # lane n holds raster pixel perm[n]'s id as its 'radiance'
    hdr = jnp.asarray(
        np.broadcast_to(perm[None, :].astype(np.float32), (3, N))
    )
    fl = LaneFilm(hdr=hdr, frame=jnp.int32(1), key=jax.random.PRNGKey(0))
    img = np.asarray(lane_film_image(fl, spec))
    want = np.arange(N, dtype=np.float32).reshape(spec.width, spec.height)
    np.testing.assert_array_equal(img[..., 0], want)
