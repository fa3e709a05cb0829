"""Port parity: image IO and metrics (``mort_tpu_torch.io.image``,
``mort_tpu_torch.metrics``), the JAX package's tests/test_subsystems.py IO
and metrics tests: the PNG writer's flip and gamma, the dependency-free
encoder's bytes equal to the JAX package's for the same array, the NPZ
round trip, and ``render_metrics`` equal to the JAX package's dict for the
same camera, meta and wall time."""

import dataclasses
import io
import json
import os

import numpy as np
import pytest
import torch

from mort_tpu.io import image as jimage
from mort_tpu import metrics as jmetrics
from mort_tpu_torch import metrics
from mort_tpu_torch.camera import camera_from_numpy
from mort_tpu_torch.io.image import _save_png_pure, load_npz, save_npz, save_png
from mort_tpu_torch.scene import scenes as sc
from mort_tpu_torch.scene.build import scene_from_numpy


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _decode_png(path):
    from PIL import Image
    return np.asarray(Image.open(path).convert("RGB"))


def test_save_png_roundtrip_and_flip(tmp_path):
    u8 = (np.arange(4 * 3 * 3, dtype=np.uint8).reshape(4, 3, 3) * 5) % 251
    p = str(tmp_path / "a.png")
    save_png(p, u8)
    # writers flip the bottom-up framebuffer to top-down file order
    assert np.array_equal(_decode_png(p), u8[::-1])
    # a tensor gives the same file
    q = str(tmp_path / "b.png")
    save_png(q, torch.from_numpy(u8))
    assert open(p, "rb").read() == open(q, "rb").read()


def test_save_png_gamma_pipeline(tmp_path):
    lin = torch.full((2, 2, 3), 0.25)
    p = str(tmp_path / "g.png")
    save_png(p, lin)
    # gamma 2: sqrt(0.25) = 0.5 -> 256 * 0.5 = 128 (utils.h:41-43)
    assert np.all(_decode_png(p) == 128)


@pytest.mark.parametrize("shape", [(5, 7, 3), (1, 1, 3), (16, 9, 3)])
def test_pure_png_encoder_bytes_equal_jax(tmp_path, shape):
    arr = np.random.RandomState(3).randint(0, 256, size=shape,
                                           dtype=np.uint8)
    p, q = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    _save_png_pure(p, arr)
    jimage._save_png_pure(q, arr)
    assert open(p, "rb").read() == open(q, "rb").read()
    assert np.array_equal(_decode_png(p), arr)


def test_save_png_equals_jax_for_linear_radiance(tmp_path):
    """Float radiance: the same bytes through both packages' writers."""
    lin = np.random.RandomState(4).rand(6, 5, 3).astype(np.float32) * 1.3
    p, q = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    save_png(p, lin)
    jimage.save_png(q, lin)
    assert np.array_equal(_decode_png(p), _decode_png(q))


def test_npz_roundtrip(tmp_path):
    img = np.random.RandomState(0).rand(3, 4, 3).astype(np.float32)
    p = str(tmp_path / "x.npz")
    save_npz(p, torch.from_numpy(img), spp=np.int64(16))
    back = load_npz(p)
    assert np.array_equal(back["image"], img)
    assert int(back["spp"]) == 16
    # and the JAX package reads it
    assert np.array_equal(jimage.load_npz(p)["image"], img)


def test_frame_timer_and_metrics_equal_jax(three_sphere_scene):
    jdata, jmeta, jcam = three_sphere_scene
    _, meta = scene_from_numpy(_fields(jdata), _fields(jmeta))
    cam = camera_from_numpy(_fields(jcam))
    buf = io.StringIO()
    timer = metrics.FrameTimer(log=buf)
    with timer.frame():
        pass
    with timer.frame():
        pass
    assert timer.frames == 2 and timer.avg_ms >= 0.0
    timer.print_avg()
    assert "Avg. time per frame:" in buf.getvalue()   # mort.cu:119 format

    for kw in (dict(wall_s=2.0, compile_s=1.0, avg_path_len=3.5),
               dict(wall_s=0.123456)):
        m = metrics.render_metrics(cam, meta, **kw)
        assert m == jmetrics.render_metrics(jcam, jmeta, **kw)
    n_paths = cam.image_width * cam.image_height * cam.sqrt_spp ** 2
    m = metrics.render_metrics(cam, meta, wall_s=2.0, avg_path_len=3.5)
    assert m["paths"] == n_paths
    assert m["ray_segments_per_s"] == round(n_paths * 3.5 / 2.0, 1)
    out = io.StringIO()
    metrics.log_metrics(m, log=out)
    assert json.loads(out.getvalue())["spp"] == cam.sqrt_spp ** 2

    x, secs = metrics.timed(lambda: (torch.zeros(4), {"a": [1]}))
    assert secs >= 0.0 and x[0].shape == (4,)


def test_metrics_of_a_scene_equal_jax():
    """Media counts and the rest, on scene 7 (two media)."""
    from mort_tpu.scene import scenes as jsc

    jworld, jcam = jsc.build_scene(7)
    _jd, jmeta = jworld.compile()
    world, cam = sc.build_scene(7)
    _d, meta = world.compile()
    assert metrics.render_metrics(cam, meta, 1.5, avg_path_len=2.25) == \
        jmetrics.render_metrics(jcam, jmeta, 1.5, avg_path_len=2.25)


def test_trace_writes_a_chrome_trace(tmp_path):
    d = str(tmp_path / "trace")
    with metrics.trace(d) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert os.path.exists(os.path.join(d, "trace.json"))
    assert len(prof.key_averages()) > 0
