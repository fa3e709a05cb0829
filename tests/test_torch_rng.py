"""Port parity: Philox4x32-10 in torch is bit-exact with the JAX package."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from mort_tpu import rng as jrng
from mort_tpu_torch import rng as trng


def _np(words):
    return [w.numpy().astype(np.uint32) for w in words]


@pytest.mark.parametrize("bounce", [0, 1, 17])
def test_philox_bit_identical_to_numpy(bounce):
    pix = np.arange(4096, dtype=np.uint32)
    smp = (pix * 7 + 3).astype(np.uint32)
    for slot in (0, 3, 9):
        got = trng.philox4x32(torch.from_numpy(pix.astype(np.int64)),
                              torch.from_numpy(smp.astype(np.int64)),
                              bounce, slot, 69420, trng.SEED2)
        want = jrng.philox4x32_np(pix, smp, np.uint32(bounce),
                                  np.uint32(slot), 69420, jrng.SEED2)
        for g, w in zip(_np(got), want):
            np.testing.assert_array_equal(g, w)


def test_constants_match():
    for name in ("PHILOX_M0", "PHILOX_M1", "PHILOX_W0", "PHILOX_W1",
                 "PHILOX_ROUNDS", "SEED2", "DEFAULT_SEED", "SLOT_CAM_PIXEL",
                 "SLOT_CAM_LENS", "SLOT_MIX", "SLOT_MAT_DIR",
                 "SLOT_LIGHT_DIR", "SLOT_FUZZ", "SLOT_MEDIUM0", "MAX_MEDIA",
                 "SLOTS_PER_BOUNCE"):
        assert getattr(trng, name) == getattr(jrng, name), name


def test_uniform4_matches_jax_bitwise():
    rs = np.random.RandomState(0)
    pix = rs.randint(0, 1 << 31, 2048).astype(np.int64)
    smp = rs.randint(0, 4096, 2048).astype(np.int64)
    bnc = rs.randint(0, 50, 2048).astype(np.int64)
    # per-lane bounce counters, as the wavefront passes them
    got = trng.uniform4(12345, torch.from_numpy(pix), torch.from_numpy(smp),
                        1 + torch.from_numpy(bnc), trng.SLOT_FUZZ)
    want = jrng.uniform4(12345, jnp.asarray(pix, jnp.uint32),
                         jnp.asarray(smp, jnp.uint32),
                         jnp.asarray(1 + bnc, jnp.uint32), jrng.SLOT_FUZZ)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_known_vector_reproduces_exactly():
    """The pinned vector of tests/test_rng.py::test_known_vector_stability."""
    u = trng.uniform4(69420, torch.tensor(123), torch.tensor(4), 2, 1)
    got = [float(x) for x in u]
    expected = [0.7667282223701477, 0.9874579310417175,
                0.48183852434158325, 0.6557576656341553]
    np.testing.assert_allclose(got, expected, rtol=0, atol=0)


def test_negative_counter_wraps_like_uint32():
    got = trng.philox4x32(torch.tensor([-1, -2]), 0, 0, 0, 1, 2)
    want = jrng.philox4x32_np(np.array([-1, -2]).astype(np.uint32), 0, 0, 0,
                              1, 2)
    for g, w in zip(_np(got), want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", [0, 69420, 2 ** 31 + 5, 2 ** 32 - 1, -7])
def test_tensor_seed_equals_int_seed(seed):
    """The seed as an int64 tensor of one element (the operand a captured
    train step reads) gives the int seed's words and uniforms bit for bit,
    and the numpy mirror's and the JAX package's, with u32 wrap-around of a
    negative seed; per-lane bounce counters and int counter words alike."""
    rs = np.random.RandomState(seed & 0xFFFF)
    pix = rs.randint(0, 1 << 31, 1024).astype(np.int64)
    smp = rs.randint(0, 4096, 1024).astype(np.int64)
    bnc = rs.randint(0, 50, 1024).astype(np.int64)
    key = torch.tensor(seed, dtype=torch.int64)
    u32 = np.uint32(seed & 0xFFFFFFFF)
    for bounce in (3, 1 + torch.from_numpy(bnc)):
        b_np = bounce if isinstance(bounce, int) else (1 + bnc)
        args = (torch.from_numpy(pix), torch.from_numpy(smp), bounce,
                trng.SLOT_LIGHT_DIR)
        got = trng.philox4x32(*args, key, trng.SEED2)
        ints = trng.philox4x32(*args, seed, trng.SEED2)
        want = jrng.philox4x32_np(pix.astype(np.uint32),
                                  smp.astype(np.uint32),
                                  np.asarray(b_np).astype(np.uint32),
                                  np.uint32(trng.SLOT_LIGHT_DIR), u32,
                                  jrng.SEED2)
        for g, i, w in zip(_np(got), _np(ints), want):
            np.testing.assert_array_equal(g, i)
            np.testing.assert_array_equal(g, w)
        u_key = trng.uniform4(key.reshape(1), *args)
        u_int = trng.uniform4(seed, *args)
        u_jax = jrng.uniform4(u32, jnp.asarray(pix, jnp.uint32),
                              jnp.asarray(smp, jnp.uint32),
                              jnp.asarray(b_np, jnp.uint32),
                              jrng.SLOT_LIGHT_DIR)
        for k, i, j in zip(u_key, u_int, u_jax):
            assert torch.equal(k.view(torch.int32), i.view(torch.int32))
            np.testing.assert_array_equal(k.numpy(), np.asarray(j))
