"""Port parity: texture evaluation (hash-lattice Perlin noise, marble
turbulence, image point fetches, checker nesting).

The same numpy inputs go through ``mort_tpu.render.textures`` and
``mort_tpu_torch.render.textures``.  The lattice hashes are integer
arithmetic and must agree bit for bit; the noise values are float32
polynomials of the same fractions (1e-6 abs); the image texels are exact.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from mort_tpu.render import textures as jtx
from mort_tpu.scene import scenes as jsc
from mort_tpu_torch.render import textures as ttx
from mort_tpu_torch.scene.build import scene_from_numpy
from mort_tpu_torch.scene.types import TEX_IMAGE, TEX_NOISE


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _lattice(n=4096, seed=0):
    """Random int32 lattice points, negative ones and the int32 extremes
    included."""
    rs = np.random.RandomState(seed)
    ijk = rs.randint(-2 ** 31, 2 ** 31 - 1, size=(n, 3), dtype=np.int64)
    ijk[: n // 2] = rs.randint(-300, 300, size=(n // 2, 3))
    ijk[:6] = [[0, 0, 0], [-1, -1, -1], [2 ** 31 - 1, -2 ** 31, 1],
               [-2 ** 31, 2 ** 31 - 1, -1], [1, -1, 0], [-7, 3, -11]]
    return ijk.astype(np.int32)


@pytest.mark.parametrize("salt", [0, 0x51ED270B, 0xA3DA4E16, 0xFFFFFFFF])
def test_hash3_bit_equal(salt):
    ijk = _lattice()
    want = np.asarray(jtx._hash3(*(jnp.asarray(ijk[:, k]) for k in range(3)),
                                 salt)).astype(np.int64)
    got = ttx._hash3(*(torch.from_numpy(ijk[:, k]) for k in range(3)), salt)
    assert got.dtype == torch.int64
    assert ((got >= 0) & (got < 2 ** 32)).all()
    np.testing.assert_array_equal(got.numpy(), want)


def test_corner_hashes_bit_equal():
    """The shared-product corner hashes of ``_perlin_noise`` ((i+1)*H as
    i*H + H mod 2^32) equal independent ``_hash3`` calls, on both sides."""
    ijk = _lattice(seed=1)
    salt = jtx.noise_salt(0)
    assert ttx.noise_salt(0) == salt
    hx0 = ttx._mullo(ttx._u32(torch.from_numpy(ijk[:, 0])), ttx._HX)
    hy0 = ttx._mullo(ttx._u32(torch.from_numpy(ijk[:, 1])), ttx._HY)
    hz0 = ttx._mullo(ttx._u32(torch.from_numpy(ijk[:, 2])), ttx._HZ)
    for di in (0, 1):
        for dj in (0, 1):
            for dk in (0, 1):
                c = ijk.astype(np.int64) + [di, dj, dk]
                c = ((c + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32)
                want = np.asarray(jtx._hash3(
                    *(jnp.asarray(c[:, k]) for k in range(3)),
                    salt)).astype(np.int64)
                h = ((hx0 + di * ttx._HX) & ttx._M32) ^ \
                    ((hy0 + dj * ttx._HY) & ttx._M32) ^ \
                    ((hz0 + dk * ttx._HZ) & ttx._M32)
                got = ttx._avalanche(h, salt)
                np.testing.assert_array_equal(got.numpy(), want)


def _points(n=4096, seed=2, scale=40.0):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, 3) * scale).astype(np.float32)


@pytest.mark.parametrize("scale", [0.5, 40.0, 900.0])
def test_perlin_and_turbulence_match_jax(scale):
    p = _points(scale=scale)
    salt = jtx.noise_salt(1)
    want = np.asarray(jtx._perlin_noise(jnp.asarray(p), salt))
    got = ttx._perlin_noise(torch.from_numpy(p), salt).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    want = np.asarray(jtx._turbulence(jnp.asarray(p), salt))
    got = ttx._turbulence(torch.from_numpy(p), salt).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("idx", [2, 3, 4, 8])
def test_texture_value_matches_jax(idx):
    """Every texture row of the scene at random (u, v, p): checker (2),
    image (3, 8), noise (4, 8) and solid colours."""
    jdata, jmeta = jsc.build_scene(idx)[0].compile()
    data, meta = scene_from_numpy(_fields(jdata), _fields(jmeta))
    T = len(meta.tex_kind)
    rs = np.random.RandomState(idx)
    n = 4096
    tid = rs.randint(0, T, n).astype(np.int32)
    u = rs.uniform(-0.1, 1.1, n).astype(np.float32)
    v = rs.uniform(-0.1, 1.1, n).astype(np.float32)
    p = (rs.randn(n, 3) * 300.0).astype(np.float32)
    want = np.asarray(jtx.texture_value(jdata, jmeta, jnp.asarray(tid),
                                        jnp.asarray(u), jnp.asarray(v),
                                        jnp.asarray(p)))
    got = ttx.texture_value(data, meta, torch.from_numpy(tid),
                            torch.from_numpy(u), torch.from_numpy(v),
                            torch.from_numpy(p)).numpy()
    assert got.shape == (n, 3) and got.dtype == np.float32
    kinds = np.asarray(meta.tex_kind)[tid]
    noise = kinds == TEX_NOISE
    # image texels and solid colours exactly; noise within 1e-5
    np.testing.assert_array_equal(got[~noise], want[~noise])
    np.testing.assert_allclose(got[noise], want[noise], rtol=0, atol=1e-5)
    if idx in (3, 8):
        assert (kinds == TEX_IMAGE).any()
    if idx in (4, 8):
        assert noise.any()
