"""Interactive preview: orbit rig semantics + the pygame window layer
driven headlessly (SDL dummy video driver) + the run.py --preview loop
end to end on a tiny cornell render."""

import os

import numpy as np
import pytest

os.environ.setdefault("SDL_VIDEODRIVER", "dummy")

from ti_raytrace_tpu.examples.preview import (OrbitRig, PITCH_LIMIT,
                                              PygamePreview)


def test_orbit_rig_actions():
    rig = OrbitRig((0.0, 1.0, 0.0), yaw=0.2, pitch=0.1, scale=4.0)
    cam0 = rig.camera()
    assert rig.apply("yaw+")
    assert rig.yaw == pytest.approx(0.3)
    cam1 = rig.camera()
    assert not np.allclose(np.asarray(cam0.eye), np.asarray(cam1.eye))
    assert rig.apply("zoom_in")
    assert rig.scale < 4.0
    assert not rig.apply("bogus")
    # pitch clamps inside orbit_camera's singularity guard
    for _ in range(40):
        rig.apply("pitch+")
    assert rig.pitch == pytest.approx(PITCH_LIMIT)


def test_orbit_rig_mouse():
    rig = OrbitRig((0.0, 0.0, 0.0), yaw=0.0, pitch=0.0, scale=4.0)
    assert rig.drag(10, -5)
    assert rig.yaw == pytest.approx(0.1)
    assert rig.pitch == pytest.approx(-0.05)
    assert not rig.drag(0, 0)
    # pitch clamps like the reference's update() (Camera.py:70-71)
    rig.drag(0, 100000)
    assert rig.pitch == pytest.approx(PITCH_LIMIT)
    assert rig.wheel(2)
    assert rig.scale == pytest.approx(4.0 * 0.81)
    assert not rig.wheel(0)


def test_pygame_preview_mouse_drag_and_hud():
    """Synthetic mouse events under the SDL dummy driver: drag orbits,
    wheel dollies, release stops the drag; the HUD caption updates."""
    pygame = pytest.importorskip("pygame")
    rig = OrbitRig((0.0, 0.0, 0.0), 0.0, 0.0, 2.0)
    pv = PygamePreview(rig, 32, 32, "hud")
    try:
        post = pygame.event.post
        ev = pygame.event.Event
        post(ev(pygame.MOUSEMOTION, rel=(9, 0), buttons=(0, 0, 0)))
        assert pv.poll() is None  # motion without a press: no orbit
        post(ev(pygame.MOUSEBUTTONDOWN, button=1, pos=(5, 5)))
        post(ev(pygame.MOUSEMOTION, rel=(10, -20), buttons=(1, 0, 0)))
        assert pv.poll() == "camera"
        assert rig.yaw == pytest.approx(0.1)
        assert rig.pitch == pytest.approx(-0.2)
        post(ev(pygame.MOUSEBUTTONUP, button=1, pos=(15, 5)))
        post(ev(pygame.MOUSEMOTION, rel=(50, 50), buttons=(0, 0, 0)))
        assert pv.poll() is None  # released: motion no longer orbits
        post(ev(pygame.MOUSEWHEEL, y=1, x=0))
        assert pv.poll() == "camera"
        assert rig.scale == pytest.approx(1.8)
        pv.set_hud(17, 512, 23.4)
        assert pygame.display.get_caption()[0] == "hud — 17/512 spp  23.4 fps"
    finally:
        pv.close()


def test_pygame_preview_events_and_show():
    pygame = pytest.importorskip("pygame")
    rig = OrbitRig((0.0, 0.0, 0.0), 0.0, 0.0, 2.0)
    pv = PygamePreview(rig, 32, 32, "test")
    try:
        assert pv.poll() is None
        pygame.event.post(
            pygame.event.Event(pygame.KEYDOWN, key=pygame.K_RIGHT)
        )
        assert pv.poll() == "camera"
        assert rig.yaw == pytest.approx(0.1)
        img = (np.random.default_rng(0).random((32, 32, 3)) * 255).astype(
            np.uint8
        )
        pv.show(img)  # blit + flip under the dummy driver
        pygame.event.post(
            pygame.event.Event(pygame.KEYDOWN, key=pygame.K_ESCAPE)
        )
        assert pv.poll() == "quit"
    finally:
        pv.close()


def test_run_cli_preview_loop(tmp_path):
    """--preview renders progressively into the (dummy) window: the CLI
    loop exercises show()/poll() every frame and still writes the PNG."""
    pytest.importorskip("pygame")
    from ti_raytrace_tpu.examples.run import main

    out = str(tmp_path / "preview.png")
    main(["cornell_box", "--size", "16", "--frames", "2", "--out", out,
          "--snapshot-every", "1", "--preview", "--cpu"])
    assert os.path.exists(out)
