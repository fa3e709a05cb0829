"""Port parity: light sampling (``render/shade.py``) and constant media
(``intersect.media_pass``).

The same numpy points, directions and uniforms go through the JAX package
and the port.  Lights: scene 6 (a quad and a sphere light, two-way pick)
and scene 8 (one quad light).  Media: scenes 7 (two boxes of smoke) and 8
(the subsurface sphere and the scene-wide fog), fed the same surface hits.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from mort_tpu.render import shade as jsh
from mort_tpu.render.intersect import (
    T_MIN, intersect_best as j_intersect_best, media_pass as j_media_pass,
    quad_frames as j_quad_frames,
)
from mort_tpu.render.vec import V3 as JV3
from mort_tpu.scene import scenes as jsc
from mort_tpu_torch.render import shade as tsh
from mort_tpu_torch.render.intersect import (
    K_MEDIUM0, intersect_best, media_pass, quad_frames,
)
from mort_tpu_torch.render.vec import V3
from mort_tpu_torch.scene.build import scene_from_numpy

SEED = 69420


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _scene(idx):
    jdata, jmeta = jsc.build_scene(idx)[0].compile()
    data, meta = scene_from_numpy(_fields(jdata), _fields(jmeta))
    return jdata, jmeta, data, meta


def _points_dirs(n, seed, lo, hi, aim_lo, aim_hi):
    """Points in the scene's box and directions, half of them aimed at
    random points of the lights' box (so that many reach a light)."""
    rs = np.random.RandomState(seed)
    p = rs.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    aim = rs.uniform(aim_lo, aim_hi, (n, 3)).astype(np.float32) - p
    d[: n // 2] = aim[: n // 2]
    u = rs.rand(3, n).astype(np.float32)
    return p, d, u


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("idx,box,aim", [
    (6, (0.0, 555.0), ([100.0, 0.0, 100.0], [343.0, 554.0, 332.0])),
    (8, ([-1000.0, 0.0, -1000.0], [1000.0, 600.0, 1000.0]),
     ([123.0, 554.0, 147.0], [423.0, 554.0, 412.0])),
], ids=["scene6", "scene8"])
def test_lights_match_jax(idx, box, aim):
    jdata, jmeta, data, meta = _scene(idx)
    assert len(meta.lights) == (2 if idx == 6 else 1)
    p, d, (pick_u, u1, u2) = _points_dirs(4096, idx, *box, *aim)
    jqf, qf = j_quad_frames(jdata), quad_frames(data)
    jp, jd = JV3.from_rows(jnp.asarray(p)), JV3.from_rows(jnp.asarray(d))
    tp = V3.from_rows(torch.from_numpy(p))
    td = V3.from_rows(torch.from_numpy(d))

    want = np.asarray(jsh.lights_pdf_value(jdata, jmeta, jqf, jp, jd))
    got = tsh.lights_pdf_value(data, meta, qf, tp, td).numpy()
    assert (want > 0).mean() > 0.01
    _close(got, want)

    want = jsh.lights_sample(jdata, jmeta, jp, jnp.asarray(pick_u),
                             jnp.asarray(u1), jnp.asarray(u2))
    got = tsh.lights_sample(data, meta, tp, torch.from_numpy(pick_u),
                            torch.from_numpy(u1), torch.from_numpy(u2))
    for g, w in zip(got, want):
        _close(g.numpy(), np.asarray(w))
    # the sampled directions, fed back, give the same pdf on both sides
    _close(tsh.lights_pdf_value(data, meta, qf, tp, got).numpy(),
           np.asarray(jsh.lights_pdf_value(jdata, jmeta, jqf, jp, want)))


def _camera_rays(idx, n=4096):
    from mort_tpu_torch.camera import (
        camera_from_numpy, derive_basis, get_rays_soa,
    )
    jcam = jsc.build_scene(idx)[1]
    cam = camera_from_numpy(_fields(jcam))
    rs = np.random.RandomState(idx)
    pix = rs.randint(0, cam.image_width * cam.image_height, n)
    smp = rs.randint(0, cam.sqrt_spp ** 2, n)
    bounce = rs.randint(0, 8, n)
    ro, rd, tme = get_rays_soa(cam, derive_basis(cam), SEED,
                               torch.from_numpy(pix), torch.from_numpy(smp))
    return (ro.to_rows().numpy(), rd.to_rows().numpy(), tme.numpy(), pix,
            smp, bounce)


@pytest.mark.parametrize("idx", [7, 8])
def test_media_pass_matches_jax(idx):
    """Both sides get the JAX package's surface hits for the same rays."""
    jdata, jmeta, data, meta = _scene(idx)
    assert meta.media
    ro, rd, tme, pix, smp, bounce = _camera_rays(idx)
    jqf, qf = j_quad_frames(jdata), quad_frames(data)
    R = ro.shape[0]
    surf = dataclasses.replace(jmeta, media=())
    bt, bk, bi = j_intersect_best(
        jdata, surf, jqf, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(tme),
        jnp.uint32(SEED), jnp.zeros(R, jnp.int32), jnp.zeros(R, jnp.int32), 0)
    jargs = (jnp.uint32(SEED), jnp.asarray(pix, jnp.int32),
             jnp.asarray(smp, jnp.int32), jnp.asarray(bounce, jnp.int32))
    wt, wk, wi = map(np.asarray, j_media_pass(
        jdata, jmeta, jqf, JV3.from_rows(jnp.asarray(ro)),
        JV3.from_rows(jnp.asarray(rd)), *jargs, T_MIN, bt, bk, bi))
    gt, gk, gi = media_pass(
        data, meta, qf, V3.from_rows(torch.from_numpy(ro)),
        V3.from_rows(torch.from_numpy(rd)), SEED, torch.from_numpy(pix),
        torch.from_numpy(smp), torch.from_numpy(bounce), T_MIN,
        torch.from_numpy(np.array(bt)), torch.from_numpy(np.array(bk)),
        torch.from_numpy(np.array(bi)))
    in_medium = wk >= K_MEDIUM0
    assert in_medium.mean() > 0.01 and (~in_medium).any()
    np.testing.assert_array_equal(gk.numpy(), wk)
    np.testing.assert_array_equal(gi.numpy(), wi)
    fin = np.isfinite(wt)
    assert (np.isfinite(gt.numpy()) == fin).all()
    np.testing.assert_allclose(gt.numpy()[fin], wt[fin], rtol=1e-5)


@pytest.mark.parametrize("idx", [7, 8])
def test_intersect_best_media_matches_jax(idx):
    """The port's reference intersector, media included, against the JAX
    package's on camera rays."""
    jdata, jmeta, data, meta = _scene(idx)
    ro, rd, tme, pix, smp, bounce = _camera_rays(idx, 2048)
    jqf = j_quad_frames(jdata)
    wt, wk, wi = map(np.asarray, j_intersect_best(
        jdata, jmeta, jqf, jnp.asarray(ro), jnp.asarray(rd),
        jnp.asarray(tme), jnp.uint32(SEED), jnp.asarray(pix, jnp.int32),
        jnp.asarray(smp, jnp.int32), jnp.asarray(bounce, jnp.int32)))
    gt, gk, gi = intersect_best(
        data, meta, quad_frames(data), torch.from_numpy(ro),
        torch.from_numpy(rd), torch.from_numpy(tme), SEED,
        torch.from_numpy(pix), torch.from_numpy(smp),
        torch.from_numpy(bounce))
    assert (wk >= K_MEDIUM0).any()
    np.testing.assert_array_equal(gk.numpy(), wk)
    np.testing.assert_array_equal(gi.numpy(), wi)
    fin = np.isfinite(wt)
    # surfaces: two float32 evaluations of the same expanded quadratic
    # (test_torch_closest_hit.py's bound); media: the same ops
    np.testing.assert_allclose(gt.numpy()[fin], wt[fin], rtol=1e-4)
