"""Port parity: progressive rendering and checkpoint/resume
(``mort_tpu_torch.render.progressive``), the JAX package's
tests/test_subsystems.py progressive tests without the mesh case, on the
CPU: the lockstep steps sum to the one-shot render, a resumed render equals
the uninterrupted one bit for bit on both paths, the checkpoint write is
atomic, and a checkpoint written by either package loads in the other.
The same scene goes through both packages (``three_sphere_scene``)."""

import dataclasses
import os

import numpy as np
import pytest

from conftest import assert_images_close

from mort_tpu.render import progressive as jprog
from mort_tpu_torch.camera import camera_from_numpy
from mort_tpu_torch.render.progressive import (
    RenderState, load_state, render_progressive,
    render_progressive_wavefront, save_state,
)
from mort_tpu_torch.render.renderer import render
from mort_tpu_torch.render.wavefront import render_wavefront
from mort_tpu_torch.scene.build import scene_from_numpy


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@pytest.fixture(scope="module")
def scene(three_sphere_scene):
    jdata, jmeta, jcam = three_sphere_scene
    data, meta = scene_from_numpy(_fields(jdata), _fields(jmeta))
    return data, meta, camera_from_numpy(_fields(jcam))


class _Interrupted(BaseException):
    pass


class _StopAfter:
    """on_step callback that interrupts once n samples are done."""

    def __init__(self, n):
        self.n = n

    def __call__(self, state):
        if state.samples_done >= self.n:
            raise _Interrupted


def _interrupted(fn, *args, **kwargs):
    try:
        return fn(*args, **kwargs)
    except _Interrupted:
        return None


def test_progressive_lockstep_matches_oneshot(scene):
    data, meta, cam = scene
    spp = cam.sqrt_spp ** 2
    one = render_progressive(data, meta, cam, samples_per_step=spp,
                             device="cpu")
    three = render_progressive(data, meta, cam, samples_per_step=2,
                               device="cpu")
    assert one.samples_done == three.samples_done == spp
    assert one.fb.dtype == np.float32 and one.fb.shape == (
        cam.image_height, cam.image_width, 3)
    # same samples; the per-call 1/spp scaling rounds differently per split
    np.testing.assert_allclose(one.fb, three.fb, atol=1e-6)
    assert_images_close(one.fb, render(data, meta, cam, device="cpu").numpy(),
                        frac_ok=1.0, atol=1e-5, mean_tol=1e-6)


def test_progressive_lockstep_checkpoint_resume(scene, tmp_path):
    data, meta, cam = scene
    ckpt = str(tmp_path / "state.npz")
    full = render_progressive(data, meta, cam, samples_per_step=1,
                              device="cpu")
    _interrupted(render_progressive, data, meta, cam, samples_per_step=1,
                 checkpoint_path=ckpt, on_step=_StopAfter(2), device="cpu")
    loaded = load_state(ckpt)
    assert loaded.samples_done == 2 and loaded.seed == 69420
    resumed = render_progressive(data, meta, cam, samples_per_step=1,
                                 state=loaded, device="cpu")
    assert resumed.samples_done == cam.sqrt_spp ** 2
    assert np.array_equal(resumed.fb, full.fb)


def test_progressive_wavefront_resume_bit_identical(scene, tmp_path):
    """Resumed == uninterrupted, bit for bit (layer-aligned deposits)."""
    data, meta, cam = scene
    ckpt = str(tmp_path / "wf.npz")
    full = render_progressive_wavefront(data, meta, cam, spt=1,
                                        device="cpu")
    assert full.samples_done == cam.sqrt_spp ** 2
    _interrupted(render_progressive_wavefront, data, meta, cam, spt=1,
                 checkpoint_path=ckpt, on_step=_StopAfter(2), device="cpu")
    loaded = load_state(ckpt)
    assert 0 < loaded.samples_done < cam.sqrt_spp ** 2
    resumed = render_progressive_wavefront(data, meta, cam, spt=1,
                                           state=loaded, device="cpu")
    assert np.array_equal(resumed.fb, full.fb)
    # two layers a step give the same bits
    two = render_progressive_wavefront(data, meta, cam, spt=1,
                                       layers_per_step=2, device="cpu")
    assert np.array_equal(two.fb, full.fb)
    # and the one-shot wavefront render agrees (same samples, another
    # accumulation order)
    oneshot = render_wavefront(data, meta, cam, "cpu", spt=1).numpy()
    np.testing.assert_allclose(full.fb, oneshot, atol=1e-5)
    with pytest.raises(ValueError):
        render_progressive_wavefront(data, meta, cam, spt=3,
                                     state=load_state(ckpt), device="cpu")
    with pytest.raises(ValueError):
        render_wavefront(data, meta, cam, "cpu", layer_range=(0, 1),
                         task_range=(0, 4))


def test_save_state_atomic_and_partial_image_scaling(tmp_path):
    fb = np.full((2, 2, 3), 0.25, np.float32)
    st = RenderState(fb=fb, samples_done=2, seed=7, spp_total=8)
    # partial estimator rescaled to a proper mean for previews
    assert np.allclose(st.image, fb * 4.0)
    path = str(tmp_path / "s.npz")
    save_state(path, st)
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp.npz")]
    back = load_state(path)
    assert back.samples_done == 2 and back.seed == 7 and back.spp_total == 8
    assert np.array_equal(back.fb, fb)


def test_checkpoints_cross_packages(scene, tmp_path):
    """A checkpoint the JAX package writes resumes in the port, bit for bit
    as if uninterrupted; one the port writes loads in the JAX package."""
    data, meta, cam = scene
    full = render_progressive_wavefront(data, meta, cam, spt=1,
                                        device="cpu")
    part = []
    _interrupted(render_progressive_wavefront, data, meta, cam, spt=1,
                 on_step=lambda s: (part.append(RenderState(
                     s.fb.copy(), s.samples_done, s.seed, s.spp_total)),
                     _StopAfter(2)(s)), device="cpu")
    st = part[-1]
    jpath = str(tmp_path / "jax.npz")
    jprog.save_state(jpath, jprog.RenderState(fb=st.fb,
                                              samples_done=st.samples_done,
                                              seed=st.seed,
                                              spp_total=st.spp_total))
    loaded = load_state(jpath)
    assert (loaded.samples_done, loaded.seed, loaded.spp_total) == (
        st.samples_done, st.seed, st.spp_total)
    resumed = render_progressive_wavefront(data, meta, cam, spt=1,
                                           state=loaded, device="cpu")
    assert np.array_equal(resumed.fb, full.fb)

    ppath = str(tmp_path / "port.npz")
    save_state(ppath, resumed)
    j = jprog.load_state(ppath)
    assert (j.samples_done, j.seed, j.spp_total) == (
        resumed.samples_done, resumed.seed, resumed.spp_total)
    assert j.fb.dtype == np.float32 and np.array_equal(j.fb, resumed.fb)
    with np.load(ppath) as z:
        assert sorted(z.files) == ["fb", "samples_done", "seed", "spp_total"]


def test_progressive_wavefront_matches_jax(three_sphere_scene, scene):
    """The same scene, camera and seed through both packages' progressive
    wavefront (two layers a step): the images agree by the image rule."""
    data, meta, cam = scene
    want = jprog.render_progressive_wavefront(*three_sphere_scene, spt=1,
                                              layers_per_step=2)
    got = render_progressive_wavefront(data, meta, cam, spt=1,
                                       layers_per_step=2, device="cpu")
    assert got.samples_done == want.samples_done == cam.sqrt_spp ** 2
    assert_images_close(got.fb, np.asarray(want.fb))
