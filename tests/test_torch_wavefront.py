"""Port parity: the wavefront integrator, end to end on the CPU.

The port's scene-1 image at the golden config (test_golden.py) is held
against the JAX package's XLA-intersector wavefront image; its own
window/pool invariance is held as test_wavefront.py holds the JAX one.
"""

import dataclasses

import numpy as np
import pytest
import torch

from conftest import assert_images_close

from mort_tpu.render.wavefront import render_wavefront as j_render
from mort_tpu.scene import scenes as jsc
from mort_tpu_torch.camera import camera_from_numpy
from mort_tpu_torch.render.wavefront import default_pool, render_wavefront
from mort_tpu_torch.scene import scenes as tsc
from mort_tpu_torch.scene.build import scene_from_numpy

GOLDEN_WIDTH = 48
GOLDEN_SPP = 4
GOLDEN_DEPTH = 8
GOLDEN_SEED = 69420


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _golden_camera(cam):
    """test_golden.py's pinned render config."""
    h = max(1, int(GOLDEN_WIDTH * cam.image_height / cam.image_width))
    return cam.replace(image_width=GOLDEN_WIDTH, image_height=h,
                       sqrt_spp=int(np.sqrt(GOLDEN_SPP)),
                       bounce_limit=GOLDEN_DEPTH)


def _port(three_sphere_scene):
    jdata, jmeta, jcam = three_sphere_scene
    data, meta = scene_from_numpy(_fields(jdata), _fields(jmeta))
    return data, meta, camera_from_numpy(_fields(jcam))


def test_scene1_golden_config_matches_jax():
    jworld, jcam = jsc.random_spheres()
    jdata, jmeta = jworld.compile()
    jcam = _golden_camera(jcam)
    want = np.asarray(j_render(jdata, jmeta, jcam, seed=GOLDEN_SEED,
                               use_pallas=False))
    # the port builds scene 1 itself: its arrays equal the JAX package's
    # (test_torch_scene.py), so both render the same scene
    tworld, tcam = tsc.random_spheres()
    data, meta = tworld.compile()
    got = render_wavefront(data, meta, _golden_camera(tcam), "cpu",
                           seed=GOLDEN_SEED)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    assert_images_close(got.numpy(), want, msg="scene 1 port vs jax")


def test_window_invariance(three_sphere_scene):
    data, meta, cam = _port(three_sphere_scene)
    a = render_wavefront(data, meta, cam, "cpu", seed=3, window=1)
    b = render_wavefront(data, meta, cam, "cpu", seed=3, window=4)
    # the same per-sample radiance; only the deposit order differs
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)


def test_small_pool_and_spans(three_sphere_scene):
    """A tiny pool and several spans exercise the refill/retire edges."""
    data, meta, cam = _port(three_sphere_scene)
    a = render_wavefront(data, meta, cam, "cpu", seed=7)
    b = render_wavefront(data, meta, cam, "cpu", seed=7, pool=1024,
                         max_paths_per_call=1500)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)


def test_task_range_accumulates(three_sphere_scene):
    """Two task ranges through an external framebuffer give the full
    render (one chunk per pixel here, so every pixel is added once)."""
    data, meta, cam = _port(three_sphere_scene)
    n_tasks = cam.image_width * cam.image_height
    full = render_wavefront(data, meta, cam, "cpu", seed=5)
    fb = render_wavefront(data, meta, cam, "cpu", seed=5,
                          task_range=(0, n_tasks // 2), scrub_nan=False)
    fb = render_wavefront(data, meta, cam, "cpu", seed=5, fb=fb,
                          task_range=(n_tasks // 2, n_tasks))
    np.testing.assert_array_equal(fb.numpy(), full.numpy())


def test_return_stats(three_sphere_scene):
    data, meta, cam = _port(three_sphere_scene)
    img, st = render_wavefront(data, meta, cam, "cpu", seed=1,
                               return_stats=True)
    assert set(st) == {"iterations", "useful_segments", "slots_executed"}
    pool = default_pool(meta, cam.image_width * cam.image_height)
    assert st["slots_executed"] == st["iterations"] * 3 * pool  # CPU window
    n_paths = cam.image_width * cam.image_height * cam.sqrt_spp ** 2
    assert n_paths <= st["useful_segments"] <= st["slots_executed"]
    assert img.shape == (cam.image_height, cam.image_width, 3)


def test_unported_paths_raise(three_sphere_scene):
    """A mesh must come from ``make_mesh`` (tests/test_torch_sharding.py
    covers the sharded path); the kernel needs a card; an unknown accel
    mode is refused.  Light sampling renders (Cornell box)."""
    data, meta, cam = _port(three_sphere_scene)
    with pytest.raises(TypeError):
        render_wavefront(data, meta, cam, "cpu", mesh=object())
    with pytest.raises(ValueError):
        render_wavefront(data, meta, cam, "cpu", use_kernel=True)
    with pytest.raises(ValueError):
        render_wavefront(data, meta, cam, "cpu", accel="kdtree")
    w, c = tsc.cornell_box()                   # light sampling
    d6, m6 = w.compile()
    img = render_wavefront(d6, m6, c.replace(image_width=16, image_height=16,
                                             sqrt_spp=1, bounce_limit=4),
                           "cpu")
    assert img.shape == (16, 16, 3) and bool(torch.isfinite(img).all())
    assert float(img.mean()) > 0.0
