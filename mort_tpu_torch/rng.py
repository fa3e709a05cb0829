"""Counter-based Philox4x32-10, bit-exact with ``mort_tpu.rng``.

Every random draw is a pure function of its counter

    u = philox4x32(counter=(pixel, sample, bounce+1, slot), key=(seed, SEED2))

so any re-batching or compaction of rays draws identical samples, and no
``torch.Generator`` or other global RNG state exists.

Torch's ``uint32`` has too few kernels to rely on, so the 32-bit words live
in ``int64`` tensors holding values in [0, 2^32).  A plain int64 product of
two u32 words can exceed 2^63, so ``mulhi``/``mullo`` are built from 16-bit
limbs of the (constant) multiplier: every partial product stays below 2^49.

On the card ``uniform4`` launches one kernel (``csrc/philox.cu``) that
computes the block in registers; the limb code (``uniform4_plain``) is the
plain version, which the CPU takes and the kernel equals bit for bit.

``philox4x32_np``/``uniform4_np`` are the numpy mirror of the same stream
(the JAX package's, used by oracles and fixtures that run without a
device).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .device import constant

# Philox4x32 round constants.
PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
PHILOX_ROUNDS = 10

# Second key word; the first is the user seed.
SEED2 = 0xC0FFEE42
DEFAULT_SEED = 69420

# Draw-slot layout (identical to mort_tpu.rng).  Camera-level draws use
# bounce counter 0; per-bounce draws use bounce counter (1 + bounce).
SLOT_CAM_PIXEL = 0      # (jitter_x, jitter_y, time, _)
SLOT_CAM_LENS = 1       # (defocus_u, defocus_v, _, _)

SLOT_MIX = 0            # (mixture_choice, light_pick, dielectric_u, _)
SLOT_MAT_DIR = 1        # (u1, u2, _, _) cosine / isotropic direction
SLOT_LIGHT_DIR = 2      # (u1, u2, _, _) light sphere-cone / quad sample
SLOT_FUZZ = 3           # (u1, u2, _, _) metal fuzz unit vector
SLOT_MEDIUM0 = 4        # one block; medium m reads word m (m < MAX_MEDIA)
MAX_MEDIA = 4
SLOTS_PER_BOUNCE = SLOT_MEDIUM0 + 1

_M32 = 0xFFFFFFFF
# the first key word's schedule: round r adds r * PHILOX_W0 (mod 2^32)
_W0_STEPS = tuple(r * PHILOX_W0 for r in range(PHILOX_ROUNDS))


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) words of the 64-bit product a * m, for u32 words ``a`` held
    in int64 and a u32 constant ``m``: m = mh * 2^16 + ml, so with
    p = a * ml and q = a * mh + (p >> 16) (both < 2^49), a * m =
    q * 2^16 + (p & 0xFFFF)."""
    p = a * (m & 0xFFFF)
    q = a * (m >> 16) + (p >> 16)
    return q >> 16, ((q & 0xFFFF) << 16) | (p & 0xFFFF)


def _word(x, device):
    """A counter word in [0, 2^32) (u32 wrap-around of negative ints, as
    ``jnp.asarray(x, uint32)`` does): a tensor becomes int64 on its device;
    a Python int stays a Python int, which the ops below take as a scalar,
    so a constant word makes no host-to-device copy (a captured CUDA graph
    allows none).  Every partial product stays below 2^49, so the int and
    int64 arithmetic give the same words."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64) & _M32
    if isinstance(x, (int, np.integer)):
        return int(x) & _M32
    return torch.as_tensor(x, device=device).to(torch.int64) & _M32


def _device_of(*xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cpu")


def philox4x32(c0, c1, c2, c3, k0, k1: int):
    """One Philox4x32-10 block: four u32 words (int64 tensors) from four
    counter words (tensors or ints, broadcast together).

    ``k0``, the seed: an int, or an int64 tensor of one element (u32
    wrap-around as for a counter word), which a captured CUDA graph reads
    as an operand, so that one capture serves every seed.  Its key
    schedule (``+ PHILOX_W0`` a round) is then one [PHILOX_ROUNDS] tensor;
    both give the same words."""
    dev = _device_of(c0, c1, c2, c3, k0)
    c0, c1, c2, c3 = (_word(c, dev) for c in (c0, c1, c2, c3))
    if isinstance(k0, torch.Tensor):
        keys0 = ((_word(k0.reshape(()), dev)
                  + constant(_W0_STEPS, torch.int64, dev)) & _M32).unbind(0)
    else:
        keys0 = [(int(k0) + w) & _M32 for w in _W0_STEPS]
    k1 = int(k1) & _M32
    for k0 in keys0:
        hi0, lo0 = _mulhilo(c0, PHILOX_M0)
        hi1, lo1 = _mulhilo(c2, PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k1 = (k1 + PHILOX_W1) & _M32
    return torch.broadcast_tensors(
        *(c if isinstance(c, torch.Tensor)
          else torch.tensor(c, dtype=torch.int64, device=dev)
          for c in (c0, c1, c2, c3)))


def _bits_to_unit(x: torch.Tensor) -> torch.Tensor:
    # 24-bit mantissa -> [0, 1), float32 exact.
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


# uniform4's draws by route: "kernel" the Philox kernel's launches (one a
# draw of CUDA operands that reached the card; a draw of no lanes launches
# none), "plain" the draws of ``uniform4_plain`` that returned (a captured
# draw counts once, its replays not at all)
launch_count = {"kernel": 0, "plain": 0}


def uniform4(seed, pixel, sample, bounce_plus1, slot):
    """Four independent uniforms in [0, 1) for the given counter.

    ``pixel``/``sample`` may be tensors (broadcast together);
    ``bounce_plus1`` and ``slot`` are tensors or ints (0 = camera-level);
    ``seed`` an int or an int64 tensor of one element (``philox4x32``).
    Where any operand is a CUDA tensor, one launch of the Philox kernel on
    the current stream (``_launch``); else ``uniform4_plain``.  Both give
    the same bits.
    """
    words = (pixel, sample, bounce_plus1, slot, seed)
    for x in words:
        if isinstance(x, torch.Tensor) and x.is_cuda:
            return _launch(x.device, *words)
    out = uniform4_plain(seed, pixel, sample, bounce_plus1, slot)
    launch_count["plain"] += 1
    return out


def uniform4_plain(seed, pixel, sample, bounce_plus1, slot):
    """``uniform4`` by the limb code, on any device: the kernel's plain
    version."""
    r = philox4x32(pixel, sample, bounce_plus1, slot, seed, SEED2)
    return tuple(_bits_to_unit(w) for w in r)


def _operand(x, shape):
    """How the kernel reads one counter or key word of a draw of ``shape``:
    ``(value, None, 0)`` for an int (its u32 wrap-around); ``(0, t, 0)``
    for an integer tensor whose every element lies at one address (one
    element, or one expanded), t int64 with that element first;
    ``(0, t, 1)`` else, t the word broadcast to ``shape`` as a contiguous
    int64 tensor (the tensor itself where it is one).  Raises on a float or
    complex tensor, which ``_word`` would truncate."""
    if not isinstance(x, torch.Tensor):
        return int(x) & _M32, None, 0
    if x.is_floating_point() or x.is_complex():
        raise TypeError(f"uniform4: a counter or key word must be an int or "
                        f"an integer tensor, got {x.dtype}")
    if all(st == 0 or n == 1 for n, st in zip(x.shape, x.stride())):
        return 0, x if x.dtype == torch.int64 else x.as_strided(
            (1,), (1,)).to(torch.int64), 0
    t = x.to(torch.int64)
    if t.shape != shape:
        t = t.broadcast_to(shape)
    return 0, t.contiguous(), 1


def _launch(dev, pixel, sample, bounce_plus1, slot, seed):
    """``uniform4`` by the kernel on CUDA device ``dev``: four float32 rows
    of one [4, N] buffer, each viewed as the counters' broadcast shape.
    Operands not on ``dev`` are copied there (none on the main paths)."""
    from ._build import load_library

    def on(x):
        if isinstance(x, (int, np.integer)):
            return int(x)
        return torch.as_tensor(x, device=dev)

    counters = [on(c) for c in (pixel, sample, bounce_plus1, slot)]
    seed = on(seed)
    if isinstance(seed, torch.Tensor) and seed.numel() != 1:
        raise ValueError(f"uniform4: the seed must be an int or a tensor of "
                         f"one element, got shape {tuple(seed.shape)}")
    shapes = {c.shape for c in counters if isinstance(c, torch.Tensor)}
    # one shape (the main paths' lanes) needs no broadcast_shapes
    shape = shapes.pop() if len(shapes) == 1 else torch.broadcast_shapes(
        *shapes)
    words = [_operand(c, shape) for c in counters] + [_operand(seed, ())]
    n = math.prod(shape)
    out = torch.empty((4, n), dtype=torch.float32, device=dev)
    if n:
        def ptr(t):
            return None if t is None else t.data_ptr()

        args = [a for value, t, stride in words[:4]
                for a in (ptr(t), value, stride)]
        value, t, _ = words[4]
        base = out.data_ptr()
        lib = load_library("philox")
        with torch.cuda.device(dev):
            rc = lib.mort_philox_uniform4(
                *args, ptr(t), value, SEED2, n,
                *(base + 4 * n * k for k in range(4)),
                torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"philox kernel launch failed: CUDA error "
                               f"{rc}")
        launch_count["kernel"] += 1
    return out.view(4, *shape).unbind(0)


# -- numpy mirror ------------------------------------------------------------

def _mulhilo_np(a, b):
    """(hi, lo) u32 words of a * b in 16-bit limbs (numpy has no u64 mulhi
    that wraps without overflow warnings)."""
    a = np.asarray(a, np.uint32)
    b = np.uint32(b)
    with np.errstate(over="ignore"):
        lo = a * b
        ah, al = a >> np.uint32(16), a & np.uint32(0xFFFF)
        bh, bl = b >> np.uint32(16), b & np.uint32(0xFFFF)
        t = al * bl
        u = ah * bl + (t >> np.uint32(16))
        v = al * bh + (u & np.uint32(0xFFFF))
        hi = ah * bh + (u >> np.uint32(16)) + (v >> np.uint32(16))
    return hi, lo


def philox4x32_np(c0, c1, c2, c3, k0, k1):
    """``philox4x32`` in numpy: four uint32 arrays."""
    c0, c1, c2, c3 = (np.asarray(c, np.uint32) for c in (c0, c1, c2, c3))
    k0, k1 = np.uint32(k0), np.uint32(k1)
    with np.errstate(over="ignore"):
        for _ in range(PHILOX_ROUNDS):
            hi0, lo0 = _mulhilo_np(c0, PHILOX_M0)
            hi1, lo1 = _mulhilo_np(c2, PHILOX_M1)
            c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
            k0 = np.uint32((int(k0) + PHILOX_W0) & _M32)
            k1 = np.uint32((int(k1) + PHILOX_W1) & _M32)
    return c0, c1, c2, c3


def uniform4_np(seed, pixel, sample, bounce_plus1, slot):
    """``uniform4`` in numpy: four float32 arrays in [0, 1)."""
    r = philox4x32_np(pixel, sample, bounce_plus1, slot, seed, SEED2)
    return tuple((w >> np.uint32(8)).astype(np.float32)
                 * np.float32(1.0 / (1 << 24)) for w in r)
