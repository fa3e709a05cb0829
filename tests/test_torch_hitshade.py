"""Port parity: finalize_and_shade on the same hit batch as the JAX package.

Both sides get the same rays and the same closest-hit results (the JAX
XLA intersector's, media included), so the comparison isolates the shading
arithmetic: materials, light sampling and the mixture pdf, media phase
rows and fallback (image/noise) textures.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from mort_tpu.render.hitshade import finalize_and_shade as j_shade
from mort_tpu.render.intersect import (
    intersect_best as j_intersect_best, quad_frames as j_quad_frames,
)
from mort_tpu.render.primtable import build_prim_table as j_prim_table
from mort_tpu.render.vec import V3 as JV3
from mort_tpu.scene import scenes as jsc
from mort_tpu_torch.camera import camera_from_numpy, derive_basis, get_rays_soa
from mort_tpu_torch.render.hitshade import finalize_and_shade
from mort_tpu_torch.render.intersect import quad_frames
from mort_tpu_torch.render.primtable import build_prim_table
from mort_tpu_torch.render.vec import V3
from mort_tpu_torch.scene.build import scene_from_numpy

SEED = 69420


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _shade_both(jdata, jmeta, jcam, n=2048):
    cam = camera_from_numpy(_fields(jcam))
    rs = np.random.RandomState(11)
    W, H = cam.image_width, cam.image_height
    pix = rs.randint(0, W * H, n).astype(np.int64)
    smp = rs.randint(0, cam.sqrt_spp ** 2, n).astype(np.int64)
    bounce = rs.randint(0, 8, n).astype(np.int64)
    ro, rd, tme = get_rays_soa(cam, derive_basis(cam), SEED,
                               torch.from_numpy(pix), torch.from_numpy(smp))
    ro, rd, tme = ro.to_rows().numpy(), rd.to_rows().numpy(), tme.numpy()

    jqf = j_quad_frames(jdata)
    jtable, jmat = j_prim_table(jdata, jmeta, jqf)
    bt, bk, bi = j_intersect_best(
        jdata, jmeta, jqf, jnp.asarray(ro), jnp.asarray(rd),
        jnp.asarray(tme), jnp.uint32(SEED), jnp.asarray(pix, jnp.int32),
        jnp.asarray(smp, jnp.int32), jnp.asarray(bounce, jnp.int32))
    want = j_shade(jdata, jmeta, jqf, jtable, jmat,
                   JV3.from_rows(jnp.asarray(ro)), JV3.from_rows(jnp.asarray(rd)),
                   jnp.asarray(tme), bt, bk, bi, jnp.uint32(SEED),
                   jnp.asarray(pix, jnp.int32), jnp.asarray(smp, jnp.int32),
                   jnp.asarray(bounce, jnp.int32))

    data, meta = scene_from_numpy(_fields(jdata), _fields(jmeta))
    qf = quad_frames(data)
    table, mat = build_prim_table(data, meta, qf)
    got = finalize_and_shade(
        data, meta, qf, table, mat, V3.from_rows(torch.from_numpy(ro)),
        V3.from_rows(torch.from_numpy(rd)), torch.from_numpy(tme),
        torch.from_numpy(np.array(bt)),
        torch.from_numpy(np.array(bk)).to(torch.int32),
        torch.from_numpy(np.array(bi)).to(torch.int32), SEED,
        torch.from_numpy(pix), torch.from_numpy(smp),
        torch.from_numpy(bounce))
    assert np.asarray(want.hit).any()
    return got, want


def _compare(got, want):
    for name in ("hit", "scatter_ok", "skip_pdf"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    # p = ro + rd * t: the same float32 ops on the same inputs
    for g, w in zip(got.p, want.p):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    # weight / new_dir / emission pass through sqrt, division and
    # sin/cos, whose float32 results may differ by an ulp or two between
    # XLA's CPU kernels and torch's; atol covers components near zero
    for name in ("weight", "new_dir", "emission"):
        for g, w in zip(getattr(got, name), getattr(want, name)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-6, err_msg=name)


def test_shade_matches_jax_scene1():
    world, jcam = jsc.random_spheres()
    jdata, jmeta = world.compile()
    _compare(*_shade_both(jdata, jmeta, jcam))


def test_shade_matches_jax_three_spheres(three_sphere_scene):
    jdata, jmeta, jcam = three_sphere_scene
    _compare(*_shade_both(jdata, jmeta, jcam))


@pytest.mark.parametrize("idx", [3, 4, 6, 7, 8])
def test_shade_matches_jax_features(idx):
    """Image textures (3), noise (4), lights with a two-way pick (6),
    media (7) and all of them at once (8)."""
    jworld, jcam = jsc.build_scene(idx)
    jdata, jmeta = jworld.compile()
    got, want = _shade_both(jdata, jmeta, jcam)
    _compare(got, want)
