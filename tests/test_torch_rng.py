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


_LANES = torch.arange(6, dtype=torch.int64) * 7


@pytest.mark.parametrize("case", [
    "int", "negative int", "np.uint32", "0-dim", "[1]", "expanded",
    "int32 [1]", "lanes", "int32 lanes", "strided lanes", "[1, 6] of [3, 6]",
    "[3, 1] of [3, 6]", "bool lanes"])
def test_operand_sorts_each_word(case):
    """``rng._operand`` sorts a word into a value, a stride-0 pointer (one
    element read at every lane) or a stride-1 pointer (an int64 tensor of
    the draw's lanes, contiguous), copying only where the kernel cannot
    read the operand as it is."""
    col = torch.arange(3, dtype=torch.int64)[:, None]
    x, shape, want = {
        "int": (5, (6,), (5, None, 0)),
        "negative int": (-2, (6,), (2 ** 32 - 2, None, 0)),
        "np.uint32": (np.uint32(2 ** 32 - 1), (6,), (2 ** 32 - 1, None, 0)),
        "0-dim": (torch.tensor(2 ** 40 + 3), (6,), "same 0"),
        "[1]": (torch.tensor([9]), (6,), "same 0"),
        "expanded": (_LANES[2:3].expand(6), (6,), "same 0"),
        "int32 [1]": (torch.tensor([9], dtype=torch.int32), (6,), "copy 0"),
        "lanes": (_LANES, (6,), "same 1"),
        "int32 lanes": (_LANES.to(torch.int32), (6,), "copy 1"),
        "strided lanes": (torch.arange(12)[::2], (6,), "copy 1"),
        "[1, 6] of [3, 6]": (_LANES[None, :], (3, 6), "copy 1"),
        "[3, 1] of [3, 6]": (col, (3, 6), "copy 1"),
        "bool lanes": (_LANES > 10, (6,), "copy 1"),
    }[case]
    value, t, stride = trng._operand(x, shape)
    if isinstance(want, tuple):
        assert (value, t, stride) == want
        return
    kind, want_stride = want.split()
    assert value == 0 and stride == int(want_stride)
    assert t.dtype == torch.int64
    assert (t.data_ptr() == x.data_ptr()) == (kind == "same")
    if stride == 0:
        assert int(t.reshape(-1)[0]) == int(x.reshape(-1)[0])
    else:
        assert t.is_contiguous() and t.shape == shape
        assert torch.equal(t, x.to(torch.int64).broadcast_to(shape))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16, torch.complex64])
@pytest.mark.parametrize("shape", [(), (5,)])
def test_operand_refuses_float_words(dtype, shape):
    """A float word is refused: the plain route's ``_word`` would truncate
    it, the kernel reads int64 only."""
    with pytest.raises(TypeError, match="integer tensor"):
        trng._operand(torch.ones(shape, dtype=dtype), (5,))


def test_cpu_operands_take_the_plain_route():
    """CPU tensors and ints take ``uniform4_plain``, counted under "plain",
    with the plain version's bits."""
    pix = torch.arange(100, dtype=torch.int64)
    before = dict(trng.launch_count)
    got = trng.uniform4(torch.tensor([3]), pix, 4, 1 + pix % 5, 2)
    ints = trng.uniform4(3, 123, 4, 2, 1)
    assert trng.launch_count == {"kernel": before["kernel"],
                                 "plain": before["plain"] + 2}
    for g, w in zip(got + ints,
                    trng.uniform4_plain(3, pix, 4, 1 + pix % 5, 2)
                    + trng.uniform4_plain(3, 123, 4, 2, 1)):
        assert g.device.type == "cpu"
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


def test_launch_passes_each_word_as_sorted(monkeypatch):
    """``rng._launch`` hands the kernel each counter word as (pointer,
    value, stride), the seed as (pointer, value), SEED2, the lane count,
    the four rows of one [4, N] output and the current stream; its
    outputs are those rows in the counters' broadcast shape."""
    import contextlib
    import types

    from mort_tpu_torch import _build

    calls = []

    class Lib:
        @staticmethod
        def mort_philox_uniform4(*args):
            calls.append(args)
            return 0

    monkeypatch.setattr(_build, "load_library", lambda name: Lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=77))
    pix = torch.arange(6, dtype=torch.int64)
    seed = torch.tensor([12])
    bounce = torch.tensor(4)
    out = trng._launch(torch.device("cpu"), pix, -1, bounce, 3, seed)
    (args,) = calls
    assert args[:12] == (pix.data_ptr(), 0, 1, None, 2 ** 32 - 1, 0,
                         bounce.data_ptr(), 0, 0, None, 3, 0)
    assert args[12:16] == (seed.data_ptr(), 0, trng.SEED2, 6)
    assert args[16:20] == tuple(o.data_ptr() for o in out)
    assert args[17] - args[16] == 6 * 4 and args[20] == 77
    assert all(o.shape == (6,) and o.dtype == torch.float32 for o in out)
    with pytest.raises(ValueError, match="one element"):
        trng._launch(torch.device("cpu"), pix, 0, 0, 0, pix)
    empty = trng._launch(torch.device("cpu"), pix[:0], 0, 0, 0, 7)
    assert len(calls) == 1 and all(o.shape == (0,) for o in empty)


@pytest.mark.parametrize("case", ["launch", "float word", "seed of two",
                                  "no lanes", "refused launch"])
def test_kernel_count_counts_launches(case, monkeypatch):
    """``launch_count["kernel"]`` counts launches that reached the card: a
    refused operand, a draw of no lanes and a launch the runtime refused
    leave it as it was."""
    import contextlib
    import types

    from mort_tpu_torch import _build

    rcs = []

    class Lib:
        @staticmethod
        def mort_philox_uniform4(*args):
            rcs.append(1 if case == "refused launch" else 0)
            return rcs[-1]

    monkeypatch.setattr(_build, "load_library", lambda name: Lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    pix = torch.arange(6, dtype=torch.int64)
    args, error = {
        "launch": ((pix, 0, 1, 2, 3), None),
        "float word": ((pix.double(), 0, 1, 2, 3), TypeError),
        "seed of two": ((pix, 0, 1, 2, pix[:2]), ValueError),
        "no lanes": ((pix[:0], 0, 1, 2, 3), None),
        "refused launch": ((pix, 0, 1, 2, 3), RuntimeError),
    }[case]
    before = dict(trng.launch_count)
    with pytest.raises(error) if error else contextlib.nullcontext():
        trng._launch(torch.device("cpu"), *args)
    launched = case == "launch"
    assert rcs == ([0] if launched else [1] if case == "refused launch"
                   else [])
    assert trng.launch_count == {"kernel": before["kernel"] + launched,
                                 "plain": before["plain"]}


@pytest.mark.parametrize("name", ["closest_hit", "philox", "noise"])
def test_signatures_name_the_exports(name):
    """``_build.SIGNATURES[name]`` declares exactly the functions that
    ``csrc/<name>.cu`` defines in its ``extern "C"`` block."""
    import re

    from mort_tpu_torch import _build

    src = (_build.CSRC / f"{name}.cu").read_text()
    block = src.split('extern "C" {', 1)[1].split('}  // extern "C"', 1)[0]
    defined = set(re.findall(r"^[A-Za-z_][\w\s\*]*?\b(\w+)\(", block,
                             re.MULTILINE))
    assert defined == set(_build.SIGNATURES[name])
