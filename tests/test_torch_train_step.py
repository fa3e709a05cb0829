"""Port parity: the single-device train step (``parallel/sharding.py``).

``make_train_step(meta, device="cpu")`` against the JAX package's
``make_train_step(meta, make_mesh(1))`` on the Cornell box (the setup of
test_pallas_kernel.py::test_fd_gradient_through_train_step_cornell): the
same scene, camera, target and seed; both take their default CPU route (the
XLA intersector in JAX, ``intersect_best`` under plain autograd in the
port).  Then finite differences of the port's own step, the identity cache
of its device operands, and a ``mesh`` that is not the port's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mort_tpu.parallel.sharding import (
    make_mesh, make_train_step as j_make_train_step,
)
from mort_tpu.render.renderer import render as j_render
from mort_tpu.scene import scenes as jsc
from mort_tpu_torch.camera import camera_from_numpy
from mort_tpu_torch.parallel.sharding import _DIFF_FIELDS, make_train_step
from mort_tpu_torch.parallel.sharding import make_mesh as make_mesh_port
from mort_tpu_torch.scene.build import scene_from_numpy

SEED = 11


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@pytest.fixture(scope="module")
def cornell():
    """The Cornell box at 12x12, 4 spp, depth 6, in both packages, and the
    target: the JAX package's image of it, times 0.9."""
    jworld, jcam = jsc.cornell_box()
    jdata, jmeta = jworld.compile()
    jcam = jcam.replace(image_width=12, image_height=12, sqrt_spp=2,
                        bounce_limit=6)
    target = np.asarray(j_render(jdata, jmeta, jcam)) * 0.9
    data, meta = scene_from_numpy(_fields(jdata), _fields(jmeta))
    cam = camera_from_numpy(_fields(jcam))
    return (jdata, jmeta, jcam), (data, meta, cam), target


@pytest.fixture(scope="module")
def port_step(cornell):
    _j, (data, meta, cam), target = cornell
    step = make_train_step(meta, device="cpu")
    loss, grads = step(data, cam, target, SEED)
    return step, float(loss), {k: g.numpy() for k, g in grads.items()}


def test_loss_and_grads_match_jax(cornell, port_step):
    (jdata, jmeta, jcam), _p, target = cornell
    j_step = j_make_train_step(jmeta, make_mesh(1))
    j_loss, j_grads = j_step(jdata, jcam, target, SEED)
    j_grads = {k: np.asarray(v) for k, v in j_grads.items()}
    _step, loss, grads = port_step
    np.testing.assert_allclose(loss, float(j_loss), rtol=1e-4)
    assert set(grads) == set(_DIFF_FIELDS) == set(j_grads)
    scale = max(np.abs(g).max() for g in j_grads.values())
    assert scale > 0
    for k in _DIFF_FIELDS:
        assert np.isfinite(grads[k]).all(), k
        assert grads[k].shape == j_grads[k].shape, k
        # atol relative to the largest |g| over all leaves: leaves whose
        # true gradient is 0 carry float32 noise on both sides
        np.testing.assert_allclose(grads[k], j_grads[k], rtol=1e-3,
                                   atol=1e-5 * scale, err_msg=k)


def test_kernel_route_step_matches_intersect_best_step(cornell, port_step):
    """The closest-hit Function (its plain version on the CPU) gives the
    step of the intersect_best route.  Except on ``sph_cvec``: the packed
    sphere record carries the motion terms for every sphere (as the JAX
    package's ``pack_spheres`` does), so the Function gives a static sphere
    the gradient of a motion it could have, where intersect_best (like
    JAX's XLA route) gives 0."""
    _j, (data, meta, cam), target = cornell
    _step, loss, grads = port_step
    k_loss, k_grads = make_train_step(meta, device="cpu", use_kernel=True)(
        data, cam, target, SEED)
    np.testing.assert_allclose(float(k_loss), loss, rtol=1e-5)
    scale = max(np.abs(g).max() for g in grads.values())
    assert not data.sph_cvec.any()       # the Cornell box does not move
    assert np.abs(k_grads["sph_cvec"].numpy()).max() > 0
    assert not grads["sph_cvec"].any()
    for k in set(_DIFF_FIELDS) - {"sph_cvec"}:
        np.testing.assert_allclose(k_grads[k].numpy(), grads[k], rtol=1e-3,
                                   atol=1e-5 * scale, err_msg=k)


def test_fd_through_the_step(cornell, port_step):
    """Central FD of the step's own loss, as the JAX package's test does: a
    component whose FD moves with the step size (a branch flip) is left
    out; at least two must be checked."""
    _j, (data, meta, cam), target = cornell
    step, _loss, grads = port_step

    def loss_with(field, idx, eps):
        arr = getattr(data, field).clone()
        arr[idx] += eps
        loss, _ = step(data.replace(**{field: arr}), cam, target, SEED)
        return float(loss)

    checked = 0
    for field, idx, e1 in (
            ("tex_color", (0, 0), 1e-2),
            ("mat_ior", (int(np.argmax(data.mat_ior.numpy())),), 2e-3),
            ("quad_Q", (0, 0), 2e-2)):
        auto = float(grads[field][idx])
        f = lambda e: loss_with(field, idx, e)  # noqa: E731
        fd1 = (f(e1) - f(-e1)) / (2 * e1)
        fd2 = (f(e1 / 2) - f(-e1 / 2)) / e1
        if abs(fd1 - fd2) > 0.05 * max(abs(fd1), abs(fd2)) + 1e-7:
            continue
        np.testing.assert_allclose(auto, fd2, rtol=0.05, atol=1e-6,
                                   err_msg=f"{field}[{idx}]")
        if abs(fd2) > 1e-8:
            checked += 1
    assert checked >= 2, f"only {checked} stable FD components"


def test_identity_cache(cornell):
    """The same scene, camera and target objects reuse the device operands
    of the last call; a new object uploads again."""
    _j, (data, meta, cam), target = cornell
    cam = cam.replace(image_width=4, image_height=4, sqrt_spp=1,
                      bounce_limit=2)
    target = target[:4, :4]
    step = make_train_step(meta, device="cpu")
    step(data, cam, target)
    first = step.prep_cache["val"]
    step(data, cam, target)
    assert step.prep_cache["val"] is first
    assert step.prep_cache["key"][0] is data
    data2 = data.replace()
    step(data2, cam, target)
    assert step.prep_cache["val"] is not first
    assert step.prep_cache["key"][0] is data2


def test_new_scene_keeps_the_other_operands(cornell):
    """A miss on a new scene alone keeps the camera's operands, the target
    block and the pixel ids of the last call; a new target or image size
    makes the target block and the pixel ids again, and a new camera of
    the same size its own operands alone."""
    _j, (data, meta, cam), target = cornell
    cam = cam.replace(image_width=4, image_height=4, sqrt_spp=1,
                      bounce_limit=2)
    target = target[:4, :4]
    step = make_train_step(meta, device="cpu")
    step(data, cam, target)
    _d, cam0, target0, pix0, _o = step.prep_cache["val"]
    step(data.replace(), cam, target)
    _d, cam1, target1, pix1, _o = step.prep_cache["val"]
    assert cam1 is cam0 and target1 is target0 and pix1 is pix0
    step(data, cam, target.copy())
    _d, cam2, target2, pix2, _o = step.prep_cache["val"]
    assert cam2 is cam0 and target2 is not target0 and pix2 is not pix0
    torch.testing.assert_close(target2, target0, rtol=0, atol=0)
    torch.testing.assert_close(pix2, pix0, rtol=0, atol=0)
    cam3 = cam.replace()
    step(data, cam3, target)
    _d, cam4, target4, pix4, _o = step.prep_cache["val"]
    assert cam4 is not cam0
    assert target4 is not target2 and pix4 is not pix2
    small = cam.replace(image_width=2, image_height=2)
    step(data, small, target[:2, :2])
    assert step.prep_cache["val"][3].shape == (4,)


def test_mesh_is_not_ported(cornell):
    """A mesh must come from ``make_mesh`` (the sharded step is covered by
    tests/test_torch_sharding.py), and its device is the step's."""
    _j, (_data, meta, _cam), _t = cornell
    with pytest.raises(TypeError):
        make_train_step(meta, device="cpu", mesh=object())
    with pytest.raises(ValueError):
        make_train_step(meta, make_mesh_port(1, devices=["cpu"]),
                        device="cuda")
