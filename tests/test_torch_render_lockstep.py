"""Port parity: the lockstep render (``render/integrator.py``,
``render/renderer.py``) on the CPU.

The port's scene-1 image at the golden config is held against the JAX
package's lockstep ``render`` (XLA intersector) and against the port's own
wavefront (the same estimator); the closest hit's kernel route (the
autograd Function, plain on the CPU) against the ``intersect_best`` route;
``to_u8`` against the JAX package's.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from conftest import assert_images_close

from mort_tpu.render.renderer import render as j_render, to_u8 as j_to_u8
from mort_tpu.scene import scenes as jsc
from mort_tpu_torch.camera import camera_from_numpy
from mort_tpu_torch.render import closest_hit as ch
from mort_tpu_torch.render.renderer import render, to_u8, to_u8_np
from mort_tpu_torch.render.wavefront import render_wavefront
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


@pytest.fixture(scope="module")
def scene1():
    world, cam = tsc.random_spheres()
    data, meta = world.compile()
    return data, meta, _golden_camera(cam)


def test_scene1_golden_config_matches_jax(scene1):
    jworld, jcam = jsc.random_spheres()
    jdata, jmeta = jworld.compile()
    want = np.asarray(j_render(jdata, jmeta, _golden_camera(jcam),
                               seed=GOLDEN_SEED, use_pallas=False))
    data, meta, cam = scene1
    got = render(data, meta, cam, seed=GOLDEN_SEED, device="cpu")
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    assert_images_close(got.numpy(), want, msg="lockstep port vs jax")


def test_render_matches_wavefront(scene1):
    """The lockstep and the wavefront integrators compute the same
    per-sample radiance; only the accumulation order differs."""
    data, meta, cam = scene1
    a = render(data, meta, cam, seed=GOLDEN_SEED, device="cpu")
    b = render_wavefront(data, meta, cam, "cpu", seed=GOLDEN_SEED)
    assert_images_close(a.numpy(), b.numpy(), msg="lockstep vs wavefront")


def test_kernel_route_matches_intersect_best():
    """The Function route (closest_hit_reference on the CPU, media after
    it) against the intersect_best route, on the Cornell box (quads and a
    light) and on scene 7's smoke box (media)."""
    for idx in (6, 7):
        world, cam = tsc.build_scene(idx)
        data, meta = world.compile()
        cam = cam.replace(image_width=20, image_height=20, sqrt_spp=2,
                          bounce_limit=5)
        before = dict(ch.launch_count)
        a = render(data, meta, cam, seed=3, device="cpu", use_kernel=True)
        b = render(data, meta, cam, seed=3, device="cpu", use_kernel=False)
        assert ch.launch_count == before        # the CPU launches nothing
        assert float(a.mean()) > 0.0
        assert_images_close(a.numpy(), b.numpy(), msg=f"scene {idx}")


def test_ray_batches_tile_the_image(three_sphere_scene):
    """Pixel batches (a ragged tail that repeats the last pixel) give the
    image of one batch: every pixel's samples are its own."""
    jdata, jmeta, jcam = three_sphere_scene
    data, meta = scene_from_numpy(_fields(jdata), _fields(jmeta))
    cam = camera_from_numpy(_fields(jcam))
    a = render(data, meta, cam, seed=4, device="cpu")
    b = render(data, meta, cam, seed=4, device="cpu", ray_batch=100)
    assert a.shape == (cam.image_height, cam.image_width, 3)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert not a.requires_grad


def test_to_u8_matches_jax():
    rs = np.random.RandomState(0)
    lin = (rs.randn(64, 48, 3) * 0.7 + 0.4).astype(np.float32)
    lin[0, :4] = [[-1.0] * 3, [0.0] * 3, [0.998001] * 3, [5.0] * 3]
    want = np.asarray(j_to_u8(jnp.asarray(lin)))
    got = to_u8(torch.from_numpy(lin))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(to_u8_np(lin), want)
