"""Port parity: gradients of the lockstep render with respect to the ten
differentiable scene leaves (``parallel.sharding._DIFF_FIELDS``).

The port's ``radiance_for_pixels(differentiable=True)`` is held against the
JAX package's on the same scene, camera and seed (the ``_grads_for``
pattern of test_pallas_kernel.py): its kernel route (the closest-hit
Function, whose backward is ``closest_hit_bwd_reference`` here) against
JAX's custom VJP (interpret mode), and its ``intersect_best`` route under
plain autograd against JAX's XLA route.  Then central finite differences
on the port alone, by the method of test_pallas_kernel.py.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mort_tpu import World as JWorld, make_camera as j_make_camera
from mort_tpu.parallel.sharding import _extract_diff as j_extract_diff
from mort_tpu.render.renderer import radiance_for_pixels as j_radiance
from mort_tpu_torch.camera import camera_from_numpy
from mort_tpu_torch.parallel.sharding import (
    _DIFF_FIELDS, _extract_diff, _merge_diff,
)
from mort_tpu_torch.render.renderer import radiance_for_pixels
from mort_tpu_torch.scene.build import World, scene_from_numpy

SEED = 5
WEIGHTS = (0.6, 0.3, 0.1)


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _mixed_world(W, n_sph=7, n_quad=5, moving=False):
    """test_pallas_kernel.py::_mixed_world, for either package's World."""
    rng = np.random.RandomState(1)
    w = W()
    m = w.lambertian(w.solid_color([0.5, 0.5, 0.5]))
    for i in range(n_sph):
        c = rng.randn(3) * 3
        if moving and i % 2 == 0:
            w.sphere(c, 0.3 + rng.rand(), m, center2=c + rng.randn(3) * 0.5)
        else:
            w.sphere(c, 0.3 + rng.rand(), m)
    for _ in range(n_quad):
        w.quad(rng.randn(3) * 3, rng.randn(3) * 2, rng.randn(3) * 2, m)
    return w


def _media_world(W):
    """test_pallas_kernel.py's moving and media world."""
    w = _mixed_world(W, n_sph=6, n_quad=2, moving=True)
    iso = w.lambertian(w.solid_color([0.4, 0.4, 0.9]))
    b = w.sphere([0, 0, 0], 2.5, w.dielectric(1.5), skip=True)
    w.constant_medium(b, 0.3, iso)
    return w


def _jax_grads(jdata, jmeta, jcam, use_pallas):
    """The JAX side (test_pallas_kernel.py::_grads_for), with the image."""
    pix = jnp.arange(jcam.image_width * jcam.image_height, dtype=jnp.int32)

    def loss(diff):
        img = j_radiance(jdata.replace(**diff), jmeta, jcam, jnp.uint32(SEED),
                         pix, differentiable=True, use_pallas=use_pallas,
                         pallas_interpret=True)
        return jnp.mean(img * jnp.asarray(WEIGHTS)), img

    (val, img), grads = jax.value_and_grad(loss, has_aux=True)(
        j_extract_diff(jdata))
    return (float(val), np.asarray(img),
            {k: np.asarray(v) for k, v in grads.items()})


def _port_grads(data, meta, cam, use_kernel, accel=None, seed=SEED):
    pix = torch.arange(cam.image_width * cam.image_height)
    diff = {k: v.detach().clone().requires_grad_()
            for k, v in _extract_diff(data).items()}
    img = radiance_for_pixels(_merge_diff(data, diff), meta, cam, seed, pix,
                              differentiable=True, use_kernel=use_kernel,
                              accel=accel)
    val = torch.mean(img * torch.tensor(WEIGHTS))
    grads = torch.autograd.grad(val, list(diff.values()), allow_unused=True,
                                materialize_grads=True)
    return (float(val.detach()), img.detach().numpy(),
            {k: g.numpy() for k, g in zip(diff, grads)})


def _compare(port, jax_side):
    v_p, img_p, g_p = port
    v_j, img_j, g_j = jax_side
    # the same paths were taken: the images agree per pixel
    np.testing.assert_allclose(img_p, img_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(v_p, v_j, rtol=1e-5)
    # atol: 1e-5 of the largest |g| over all leaves, not per leaf: a leaf
    # whose true gradient is 0 carries float32 noise on both sides (the
    # sphere centres of the lambertian "mixed" world: under a constant sky
    # a path's weight is its albedos, whatever the geometry; measured
    # |g| ~ 1e-17 there, with unrelated signs)
    scale = max(np.abs(g).max() for g in g_j.values())
    assert scale > 0
    for k in _DIFF_FIELDS:
        assert np.isfinite(g_p[k]).all(), k
        # JAX's own two routes agree to rtol 2e-4 (test_pallas_kernel.py)
        np.testing.assert_allclose(g_p[k], g_j[k], rtol=1e-3,
                                   atol=1e-5 * scale, err_msg=k)


def _port_scene(jworld, jcam):
    jdata, jmeta = jworld.compile()
    data, meta = scene_from_numpy(_fields(jdata), _fields(jmeta))
    return (jdata, jmeta), (data, meta, camera_from_numpy(_fields(jcam)))


CASES = {
    # test_pallas_kernel.py::test_vjp_gradients_match_xla_path
    "mixed": (lambda W: _mixed_world(W, n_sph=5, n_quad=3),
              dict(image_width=12, samples_per_pixel=4, bounce_limit=4,
                   vfov=60, lookfrom=[0, 1, 8], lookat=[0, 0, 0])),
    # ... _match_xla_path_moving_and_media
    "moving_media": (_media_world,
                     dict(image_width=10, samples_per_pixel=4,
                          bounce_limit=4, vfov=60, lookfrom=[0, 1, 8],
                          lookat=[0, 0, 0])),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_route_grads_match_jax_kernel(case):
    build, cam_kw = CASES[case]
    (jdata, jmeta), (data, meta, cam) = _port_scene(
        build(JWorld), j_make_camera(**cam_kw))
    jcam = j_make_camera(**cam_kw)
    _compare(_port_grads(data, meta, cam, use_kernel=True),
             _jax_grads(jdata, jmeta, jcam, use_pallas=True))


def test_intersect_best_route_grads_match_jax_xla():
    build, cam_kw = CASES["mixed"]
    jcam = j_make_camera(**cam_kw)
    (jdata, jmeta), (data, meta, cam) = _port_scene(build(JWorld), jcam)
    _compare(_port_grads(data, meta, cam, use_kernel=False),
             _jax_grads(jdata, jmeta, jcam, use_pallas=False))


def _fd_world():
    """test_pallas_kernel.py::test_fd_gradients_bvh_scale_geometry_and_ior's
    scene: a 660-primitive moving field, a noise-textured hero sphere and a
    glass sphere in front of it, well clear of the field."""
    w = _mixed_world(World, n_sph=400, n_quad=260, moving=True)
    w.sphere([0.0, 1.0, 30.0], 1.4, w.lambertian(w.noise_texture(0.5)))
    w.sphere([0.5, 1.0, 32.2], 0.7, w.dielectric(1.5))
    return w


def test_fd_sphere_center_and_ior_through_bvh():
    """Central FD of the port's own render, through the kernel route with
    the "bvh" tables forced.  Per-pixel FD images at two step sizes give a
    stability mask (autodiff is the frozen-visibility interior derivative,
    so silhouette pixels are expected to disagree and are left out); one
    gradient of the FD-stable weighted sum is held against the same
    weighting of the FD image."""
    data, meta = _fd_world().compile()
    cam = camera_from_numpy(_fields(j_make_camera(
        image_width=16, aspect_ratio=1.0, samples_per_pixel=4,
        bounce_limit=5, vfov=50, lookfrom=[0, 1, 33.8], lookat=[0, 1, 30])))
    pix = torch.arange(cam.image_width * cam.image_height)
    cent = data.sph_center.numpy()
    hero = int(np.argmin(((cent - np.array([0.0, 1.0, 30.0])) ** 2).sum(1)))
    glass = int(np.argmax(data.mat_ior.numpy()))

    def img_with(field, idx, eps):
        arr = getattr(data, field).clone()
        arr[idx] += eps
        with torch.no_grad():
            out = radiance_for_pixels(data.replace(**{field: arr}), meta, cam,
                                      SEED, pix, differentiable=True,
                                      use_kernel=True, accel="bvh")
        return out.sum(-1).numpy().astype(np.float64)

    def fd_check(field, idx, e1):
        fd1 = (img_with(field, idx, e1) - img_with(field, idx, -e1)) / (2 * e1)
        e2 = e1 / 3.0
        fd2 = (img_with(field, idx, e2) - img_with(field, idx, -e2)) / (2 * e2)
        stable = (np.abs(fd1 - fd2)
                  <= 0.07 * np.maximum(np.abs(fd1), np.abs(fd2)) + 1e-3)
        wgt = torch.from_numpy(stable.astype(np.float32))
        if (np.abs(fd2) * stable).max() < 1e-3:
            return False                    # no stable interior signal
        leaf = getattr(data, field).clone().requires_grad_()
        out = radiance_for_pixels(data.replace(**{field: leaf}), meta, cam,
                                  SEED, pix, differentiable=True,
                                  use_kernel=True, accel="bvh")
        (g,) = torch.autograd.grad((out.sum(-1) * wgt).sum(), [leaf])
        auto = float(g[idx])
        want = float((fd2 * stable).sum())
        np.testing.assert_allclose(auto, want, rtol=0.1,
                                   atol=0.05 * np.abs(fd2 * stable).max(),
                                   err_msg=f"{field}[{idx}]")
        return True

    hits = sum(fd_check("sph_center", (hero, ax), 2e-3) for ax in range(3))
    assert hits >= 2, f"only {hits} checked sphere-center FD components"
    assert fd_check("mat_ior", (glass,), 2e-3), "ior FD failed"


def test_fd_albedo_scalar():
    """The scalar-loss FD of test_pallas_kernel.py::
    test_vjp_gradients_bvh_scale on tex_color (multilinear in the path
    estimator, so FD is clean), through the forced "bvh" tables."""
    data, meta = _mixed_world(World, n_sph=400, n_quad=260,
                              moving=True).compile()
    cam = camera_from_numpy(_fields(j_make_camera(
        image_width=8, samples_per_pixel=4, bounce_limit=3, vfov=60,
        lookfrom=[0, 1, 8], lookat=[0, 0, 0])))
    _v, _img, grads = _port_grads(data, meta, cam, use_kernel=True,
                                  accel="bvh")
    for k, g in grads.items():
        assert np.isfinite(g).all(), k
    pix = torch.arange(cam.image_width * cam.image_height)

    def loss_at(eps):
        tex = data.tex_color.clone()
        tex[0, 0] += eps
        with torch.no_grad():
            img = radiance_for_pixels(data.replace(tex_color=tex), meta, cam,
                                      SEED, pix, differentiable=True,
                                      use_kernel=True, accel="bvh")
        return float(torch.mean(img * torch.tensor(WEIGHTS)).double())

    e = 1e-2
    fd = (loss_at(e) - loss_at(-e)) / (2 * e)
    np.testing.assert_allclose(float(grads["tex_color"][0, 0]), fd,
                               rtol=5e-3, atol=1e-7)
