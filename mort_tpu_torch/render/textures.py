"""Vectorised texture evaluation (the valueDispatch analogue,
textures.cuh:327-349).

The port of ``mort_tpu.render.textures``: the hash-lattice Perlin noise,
the marble turbulence, image point fetches and one checker nesting level.
Dispatch over texture kinds is a masked evaluation of each kind the scene
has (static ``SceneMeta`` flags prune the rest), never per-ray control flow.
A texture row is looked up by plain indexing (``arr[tid]``); the JAX
package's compare-select chain ``_take_rows`` served the TPU, which has no
vector gather, and gives the same values.

uint32 arithmetic: torch's ``uint32`` has too few kernels (on CUDA
especially), so 32-bit words live in int64 tensors holding values in
[0, 2^32).  Casting a negative lattice coordinate to uint32 wraps it
(``& 0xFFFFFFFF``), xor and shifts act on the low 32 bits unchanged, and the
low word of a product comes from 16-bit limbs of the constant multiplier
(``_mullo``), so no partial product reaches 2^63.

The marble noise texture on CUDA operands, with no gradient recorded
through it, is one launch of ``csrc/noise.cu`` a call (``marble_kernel``),
which evaluates every noise texture on its own lanes only; the limb code
(``marble_plain``, one noise texture a call) is the CPU's and autograd's
route and the kernel's plain version, which it equals on the card.
"""

from __future__ import annotations

import torch

from ..device import constant
from ..scene.build import SceneData, SceneMeta
from ..scene.types import TEX_CHECKER, TEX_IMAGE, TEX_NOISE

# Lattice-hash constants (three large odd multipliers + an avalanche mix).
_HX = 0x8DA6B343
_HY = 0xD8163841
_HZ = 0xCB1AB31F
_HM = 0x9E3779B1
_M32 = 0xFFFFFFFF

# Edge-direction gradients have length sqrt(2); scaled to unit length so the
# noise field's amplitude matches the reference's unit random vectors.
_INV_SQRT2 = 0.7071067811865476


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 (or int64) values as u32 words in int64 (wraps negatives)."""
    return x.to(torch.int64) & _M32


def _mullo(a: torch.Tensor, m: int) -> torch.Tensor:
    """Low 32 bits of a * m for u32 words ``a`` (int64) and a u32 constant
    ``m = mh * 2^16 + ml``: a * ml < 2^48 and the low 16 bits of a * mh,
    shifted up, stay below 2^32."""
    return (a * (m & 0xFFFF) + (((a * (m >> 16)) & 0xFFFF) << 16)) & _M32


def _avalanche(h: torch.Tensor, salt: int) -> torch.Tensor:
    h = (h + (int(salt) & _M32)) & _M32
    h = h ^ (h >> 13)
    h = _mullo(h, _HM)
    return h ^ (h >> 16)


def _hash3(i, j, k, salt):
    """Lattice hash of integer coordinates (int32 tensors): a u32 word in
    int64, bit-equal to the JAX package's ``_hash3``."""
    return _avalanche(_mullo(_u32(i), _HX) ^ _mullo(_u32(j), _HY)
                      ^ _mullo(_u32(k), _HZ), salt)


def _grad_dot(h, wx, wy, wz):
    """Dot of a hashed gradient with the corner weight vector: the 12
    edge directions of improved Perlin noise, scaled to unit length."""
    hh = h & 15
    u = torch.where(hh < 8, wx, wy)
    v = torch.where(hh < 4, wy,
                    torch.where((hh == 12) | (hh == 14), wx, wz))
    u = torch.where((h & 1) != 0, -u, u)
    v = torch.where((h & 2) != 0, -v, v)
    return (u + v) * _INV_SQRT2


def _perlin_noise(p, salt):
    """Perlin noise with the reference's double smoothing
    (textures.cuh:174-196 + 232-250): the lattice weights use the
    twice-smoothed fractions, the gradient offsets the once-smoothed ones.
    The corner hashes share their lattice products ((i+1)*H = i*H + H mod
    2^32), as the JAX package does.  p: [R,3] -> [R]."""
    pf = torch.floor(p)
    uvw = p - pf
    uvw1 = uvw * uvw * (3.0 - 2.0 * uvw)
    ijk = pf.to(torch.int32)

    uu = uvw1 * uvw1 * (3.0 - 2.0 * uvw1)
    hx0 = _mullo(_u32(ijk[..., 0]), _HX)
    hy0 = _mullo(_u32(ijk[..., 1]), _HY)
    hz0 = _mullo(_u32(ijk[..., 2]), _HZ)
    hx = (hx0, (hx0 + _HX) & _M32)
    hy = (hy0, (hy0 + _HY) & _M32)
    hz = (hz0, (hz0 + _HZ) & _M32)
    accum = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    for di in (0, 1):
        for dj in (0, 1):
            for dk in (0, 1):
                h = _avalanche(hx[di] ^ hy[dj] ^ hz[dk], salt)
                coeff = (
                    (di * uu[..., 0] + (1 - di) * (1.0 - uu[..., 0]))
                    * (dj * uu[..., 1] + (1 - dj) * (1.0 - uu[..., 1]))
                    * (dk * uu[..., 2] + (1 - dk) * (1.0 - uu[..., 2]))
                )
                gd = _grad_dot(h, uvw1[..., 0] - di, uvw1[..., 1] - dj,
                               uvw1[..., 2] - dk)
                accum = accum + coeff * gd
    return accum


def _turbulence(p, salt, depth=7):
    """Sum of |octaves| (textures.cuh:252-265)."""
    accum = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    temp_p = p
    weight = 1.0
    for _ in range(depth):
        accum = accum + weight * _perlin_noise(temp_p, salt)
        weight *= 0.5
        temp_p = temp_p * 2.0
    return torch.abs(accum)


def noise_salt(nid: int) -> int:
    """Per-noise-texture hash salt (each texture is an independent field,
    like the reference's per-texture permutation tables)."""
    return ((int(nid) + 1) * 0x51ED270B) & _M32


def _base_value(data: SceneData, meta: SceneMeta, kind_arr, tid, u, v, p):
    """Evaluate non-checker textures at texture rows ``tid`` [R]."""
    tid = tid.long()
    kinds = kind_arr[tid]
    out = data.tex_color[tid]           # solid_color (textures.cuh:24-27)

    if meta.n_images > 0:
        img_ids = data.tex_image_id[tid]
        uc = torch.clamp(u, 0.0, 1.0)
        vc = 1.0 - torch.clamp(v, 0.0, 1.0)   # flip V (textures.cuh:133-134)
        exact = meta.images_u8_exact or (True,) * meta.n_images
        # a true float32 divide: on CUDA a division by a Python scalar is
        # a multiply by its reciprocal, which is not the u8/255 value
        d255 = constant(255.0, torch.float32, p.device)
        for img_id in range(meta.n_images):
            H, W = data.images[img_id].shape[0], data.images[img_id].shape[1]
            i = torch.clamp((uc * W).to(torch.int32), 0, W - 1).long()
            j = torch.clamp((vc * H).to(torch.int32), 0, H - 1).long()
            if exact[img_id]:
                texel = data.images_packed[img_id][j, i]   # r<<16|g<<8|b
                val = torch.stack([(texel >> 16) & 0xFF, (texel >> 8) & 0xFF,
                                   texel & 0xFF], dim=-1).to(torch.float32)
                val = val / d255
            else:
                # float/HDR image: sampled from the f32 texels
                val = data.images[img_id][j, i]
            sel = (kinds == TEX_IMAGE) & (img_ids == img_id)
            out = torch.where(sel[..., None], val, out)

    if meta.n_noise > 0:
        if _kernel_route(p, out, data.tex_noise_scale):
            out = marble_kernel(data, kind_arr, tid, p, out)
        else:
            for nid in range(meta.n_noise):
                out = marble_plain(data, kinds, tid, p, out, nid)
                launch_count["plain"] += 1

    return out


# _base_value's marble evaluations by route: "kernel" the noise kernel's
# launches that the runtime accepted (one a call on CUDA operands with no
# gradient recorded; a call of no lanes launches none), "plain" the
# evaluations of ``marble_plain`` that returned, one a noise texture (a
# captured call counts once, its replays not at all)
launch_count = {"kernel": 0, "plain": 0}


def _card(t: torch.Tensor) -> bool:
    """``_kernel_route``'s device test (CPU tests stand a card in here)."""
    return t.is_cuda


def _kernel_route(p, *operands) -> bool:
    """Whether the marble kernel evaluates the noise: ``p`` on a card and
    autograd recording no gradient through ``p`` or ``operands`` (the
    kernel has no backward)."""
    return _card(p) and not (torch.is_grad_enabled() and any(
        t.requires_grad for t in (p, *operands)))


def marble_plain(data: SceneData, kinds, tid, p, out, nid: int):
    """Noise texture ``nid`` at the lanes of rows ``tid`` whose kind
    (``kinds``) is noise, ``out`` elsewhere, by the limb code: the
    kernel's plain version, on any device and under autograd."""
    noise_ids = data.tex_image_id[tid]
    scale = data.tex_noise_scale[tid]
    s = scale[..., None] * p
    # marble: 0.5*(1 + sin(s.z + 10*turb(s))) (textures.cuh:198-202)
    marble = 0.5 * (1.0 + torch.sin(
        s[..., 2] + 10.0 * _turbulence(s, noise_salt(nid))))
    sel = (kinds == TEX_NOISE) & (noise_ids == nid)
    return torch.where(sel[..., None], marble[..., None], out)


def _checked(name, t, dtype, shape, dev):
    if t.dtype != dtype:
        raise TypeError(f"marble_kernel: {name} must be {dtype}, got "
                        f"{t.dtype}")
    if t.device != dev:
        raise ValueError(f"marble_kernel: {name} is on {t.device}, the "
                         f"points on {dev}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"marble_kernel: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")
    return t.contiguous()


def marble_kernel(data: SceneData, kind_arr, tid, p, out):
    """``marble_plain`` of every noise texture by the kernel
    (``csrc/noise.cu``): one launch on the current stream, into a new
    tensor of ``out``'s shape; the kernel reads the texture table
    (``kind_arr``, ``data.tex_image_id``, ``data.tex_noise_scale``) at each
    lane's row itself, and a lane on a noise row takes its noise id's
    field.  ``p``, ``out``:
    float32 [..., 3]; ``tid``: int64 of their lane shape; every operand on
    ``p``'s device (refused otherwise, before any launch)."""
    from .._build import load_library

    dev = p.device
    lanes = tuple(tid.shape)
    n_tex = kind_arr.shape[0]
    p = _checked("p", p, torch.float32, lanes + (3,), dev)
    tid = _checked("tid", tid, torch.int64, lanes, dev)
    out = _checked("out", out, torch.float32, lanes + (3,), dev)
    kind_arr = _checked("the texture kinds", kind_arr, torch.int32,
                        (n_tex,), dev)
    noise_id = _checked("tex_image_id", data.tex_image_id, torch.int32,
                        (n_tex,), dev)
    scale = _checked("tex_noise_scale", data.tex_noise_scale,
                     torch.float32, (n_tex,), dev)
    new = torch.empty_like(out)
    n = tid.numel()
    if n:
        lib = load_library("noise")
        with torch.cuda.device(dev):
            rc = lib.mort_noise_marble(
                p.data_ptr(), tid.data_ptr(), kind_arr.data_ptr(),
                noise_id.data_ptr(), scale.data_ptr(), n_tex, TEX_NOISE,
                out.data_ptr(), new.data_ptr(), n,
                torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"noise kernel launch failed: CUDA error "
                               f"{rc}")
        launch_count["kernel"] += 1
    return new


def texture_value(data: SceneData, meta: SceneMeta, tid, u, v, p):
    """Full texture dispatch incl. one checker nesting level
    (textures.cuh:327-349 + 52-60).  tid: [R] texture rows; u, v: [R];
    p: [R,3].  Returns [R,3]."""
    kind_arr = constant(tuple(meta.tex_kind), torch.int32, p.device)
    if TEX_CHECKER not in meta.tex_kind:
        return _base_value(data, meta, kind_arr, tid, u, v, p)

    tid = tid.long()
    kinds = kind_arr[tid]
    inv_scale = data.tex_inv_scale[tid]
    grid = torch.floor(inv_scale[..., None] * p).to(torch.int32)
    is_even = torch.remainder(grid[..., 0] + grid[..., 1] + grid[..., 2],
                              2) == 0
    child = torch.where(is_even, data.tex_child_even[tid],
                        data.tex_child_odd[tid])
    eff = torch.where(kinds == TEX_CHECKER, child, tid.to(torch.int32))
    return _base_value(data, meta, kind_arr, eff, u, v, p)
