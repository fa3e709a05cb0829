"""Port parity: the interactive camera controller and the headless viewer
(``mort_tpu_torch.interactive``), the JAX package's tests/test_subsystems.py
controller tests: rotate_around is Rodrigues' rotation, WASD and the mouse
orbit move the camera as the JAX package's controller does (the same
float32 values), and ``view`` renders and writes its frames (here on the
CPU; without ``device`` it runs on the card)."""

import dataclasses
import io

import numpy as np
import pytest

from mort_tpu import interactive as jint
from mort_tpu_torch.camera import camera_from_numpy
from mort_tpu_torch.interactive import (
    CameraController, _ansi_preview, _rotate_around, view,
)
from mort_tpu_torch.render.renderer import to_u8_np
from mort_tpu_torch.scene.build import scene_from_numpy


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@pytest.fixture(scope="module")
def scene(three_sphere_scene):
    jdata, jmeta, jcam = three_sphere_scene
    data, meta = scene_from_numpy(_fields(jdata), _fields(jmeta))
    return data, meta, camera_from_numpy(_fields(jcam))


def _rodrigues(v, axis, theta):
    k = np.asarray(axis, np.float64)
    k = k / np.linalg.norm(k)
    v = np.asarray(v, np.float64)
    return (v * np.cos(theta) + np.cross(k, v) * np.sin(theta)
            + k * np.dot(k, v) * (1.0 - np.cos(theta)))


def test_rotate_around_matches_rodrigues_and_jax():
    """vec3.cuh:214-227 decomposition == classic Rodrigues rotation."""
    rng = np.random.RandomState(1)
    for _ in range(10):
        v, axis, theta = rng.randn(3), rng.randn(3), rng.uniform(-2, 2)
        got = _rotate_around(v, axis, theta)
        np.testing.assert_allclose(got, _rodrigues(v, axis, theta),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(got, jint._rotate_around(v, axis,
                                                               theta))


def test_camera_controller_wasd(scene):
    _, _, cam = scene
    ctl = CameraController(cam)
    lf0, la0 = cam.lookfrom.numpy(), cam.lookat.numpy()
    w = (lf0 - la0) / np.linalg.norm(lf0 - la0)
    u = np.cross(cam.vup.numpy(), w)
    u = u / np.linalg.norm(u)
    ctl.key("w")   # forward: -w (mort.cu:52-55)
    np.testing.assert_allclose(ctl.cam.lookfrom.numpy(), lf0 - w, atol=1e-6)
    np.testing.assert_allclose(ctl.cam.lookat.numpy(), la0 - w, atol=1e-6)
    ctl.key("s")   # back out
    ctl.key("d")   # strafe right: +u
    np.testing.assert_allclose(ctl.cam.lookfrom.numpy(), lf0 + u, atol=1e-5)
    ctl.key("a")
    np.testing.assert_allclose(ctl.cam.lookfrom.numpy(), lf0, atol=1e-5)


def test_camera_controller_orbit_preserves_distance(scene):
    _, _, cam = scene
    ctl = CameraController(cam)
    d0 = np.linalg.norm(cam.lookat.numpy() - cam.lookfrom.numpy())
    ctl.mouse_drag(37.0, -12.0)
    d1 = np.linalg.norm(ctl.cam.lookat.numpy() - ctl.cam.lookfrom.numpy())
    np.testing.assert_allclose(d0, d1, rtol=1e-4)
    assert not np.allclose(ctl.cam.lookat.numpy(), cam.lookat.numpy())
    # lookfrom is the orbit center and must not move (mort.cu:75-87)
    np.testing.assert_array_equal(ctl.cam.lookfrom.numpy(),
                                  cam.lookfrom.numpy())


def test_camera_controller_equals_jax(three_sphere_scene, scene):
    """One command stream through both controllers: the same cameras."""
    jctl = jint.CameraController(three_sphere_scene[2])
    ctl = CameraController(scene[2])
    for ev in [("key", "w"), ("mouse", 37.0, -12.0), ("key", "d"),
               ("key", "d"), ("mouse", -5.0, 0.0), ("key", "s"),
               ("mouse", 0.0, 9.0), ("key", "a")]:
        for c in (ctl, jctl):
            c.key(ev[1]) if ev[0] == "key" else c.mouse_drag(*ev[1:])
        for f in ("lookfrom", "lookat", "vup"):
            np.testing.assert_array_equal(getattr(ctl.cam, f).numpy(),
                                          np.asarray(getattr(jctl.cam, f)))


def test_view_loop(scene, tmp_path):
    data, meta, cam = scene
    log = io.StringIO()
    frame = view(data, meta, cam,
                 commands=[("key", "w"), ("frame",), ("mouse", 10, 0),
                           ("frame",)],
                 out_pattern=str(tmp_path / "f{}.png"), log=log,
                 device="cpu")
    assert frame is not None and np.isfinite(frame).all()
    assert (tmp_path / "f1.png").exists() and (tmp_path / "f2.png").exists()
    assert log.getvalue().count("Avg. time per frame:") == 2
    ansi = _ansi_preview(to_u8_np(frame))
    assert "\x1b[38;2;" in ansi and ansi.endswith("\x1b[0m")


def test_view_preview_refines_to_the_full_image(scene, tmp_path):
    """preview_spt: a camera held still refines one layer a frame to the
    progressive wavefront's full-spp image; a key press restarts it."""
    from mort_tpu_torch.render.progressive import (
        render_progressive_wavefront,
    )

    data, meta, cam = scene
    log = io.StringIO()
    frames = []
    for n in (1, 4):
        frames.append(view(data, meta, cam, [("frame",)] * n, log=log,
                           preview_spt=1, device="cpu"))
    full = render_progressive_wavefront(data, meta, cam, spt=1,
                                        device="cpu")
    np.testing.assert_allclose(frames[1], full.fb, rtol=1e-6, atol=1e-7)
    assert not np.allclose(frames[0], full.fb)
    moved = view(data, meta, cam, [("frame",), ("key", "w"), ("frame",)],
                 log=log, preview_spt=1, device="cpu")
    assert np.isfinite(moved).all()
