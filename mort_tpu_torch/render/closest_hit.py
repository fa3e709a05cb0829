"""Closest sphere/quad hit + joined shading row: the hand-written kernel.

The port of the accel-``"none"`` part of ``mort_tpu.render.pallas_intersect``
(``_closest_hit`` / ``_make_kernel``, ``pack_for_kernel``,
``closest_hit_pallas``).  The TPU kernel's limb-packed bf16 dots and one-hot
MXU gathers existed only to serve the MXU; here the per-(ray, primitive)
terms are plain float32 arithmetic and the winner's joined row is one
indexed load, in ``csrc/closest_hit.cu``.

Public layout (the JAX package's): ``(t [R] with +inf on a miss, kind int32,
idx int32, row_t [32, R] f32)``, with the winner's 27 joined columns in rows
0..26 and t, kind, idx in rows ``ROW_T``, ``ROW_KIND``, ``ROW_IDX``.  A miss
reads joined row 0 (as the JAX kernel's gather does) and writes t = +inf,
kind ``K_NONE``, idx 0.

Arithmetic (the same in the kernel and in ``closest_hit_reference``, op for
op, each op rounded once — the kernel uses the ``__f*_rn`` intrinsics so
that nvcc contracts nothing into an FMA): the sphere quadratic uses the
expanded formula that the JAX kernel's coefficient tables encode
(``pack_spheres``), with motion blur folded in,

    half_b = (ro.rd - c.rd) - cv.(t rd)
    c_term = ((((|ro|^2 - 2 c.ro) - 2 cv.(t ro)) + (c.c - r^2))
              + t (2 c.cv)) + t^2 |cv|^2

and roots stay scaled by a = |rd|^2 (the JAX kernel's choice): the near
root ``-half_b - sqrt(disc)`` is taken when it exceeds ``t_min * a``, else
the far one, and the winner is unscaled once per ray as ``root * (1/a)``.
Quads use the general plane/window test of ``intersect.quad_pass``.
Earlier rows win ties (strict ``<``), and a sphere beats a quad on an exact
tie.  Non-surface and padding rows never win.

Dispatch: a CUDA tensor always launches the kernel (a failure raises); a
CPU tensor takes the plain version.  ``launch_count`` counts launches.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ..scene.build import SceneData, SceneMeta
from .intersect import (
    INF, K_NONE, K_QUAD, K_SPHERE, T_MIN, QuadFrames, first_min,
)
from .vec import V3

ROW_K = 32    # rows of the ray-minor output
ROW_T = 27
ROW_KIND = 28
ROW_IDX = 29

SPH_COLS = 10    # cx cy cz  vx vy vz  c.c-r^2  2c.cv  |cv|^2  surface
QUAD_COLS = 13   # n(3) D  vxw(3) qa  wxu(3) qb  surface

# Kernel launches since import (or since a caller reset it to 0).
launch_count = 0


@dataclass(frozen=True)
class PackedScene:
    """Every kernel operand, built once per render span."""
    sph: torch.Tensor      # [Ns_rows, SPH_COLS] f32
    n_sph: int             # sphere rows to scan (the rest is padding)
    quad: torch.Tensor     # [Nq_rows, QUAD_COLS] f32
    n_quad: int
    joined: torch.Tensor   # [Ns_rows + Nq_rows, 27] f32 (primtable)
    quad_base: int         # global row of quad 0 in ``joined`` (= Ns_rows)


def _dot3(ax, ay, az, bx, by, bz):
    return (ax * bx + ay * by) + az * bz


def pack_scene(data: SceneData, meta: SceneMeta, qf: QuadFrames,
               table: torch.Tensor) -> PackedScene:
    """Per-primitive records for the closest-hit scan (host-side
    precompute of every ray-independent term), and the joined table."""
    c, cv, r = data.sph_center, data.sph_cvec, data.sph_radius
    cx, cy, cz = c.unbind(1)
    vx, vy, vz = cv.unbind(1)
    sph = torch.stack([
        cx, cy, cz, vx, vy, vz,
        _dot3(cx, cy, cz, cx, cy, cz) - r * r,
        2.0 * _dot3(cx, cy, cz, vx, vy, vz),
        _dot3(vx, vy, vz, vx, vy, vz),
        data.sph_surface.to(torch.float32),
    ], dim=1).contiguous()
    quad = torch.cat([
        qf.normal, qf.D[:, None], qf.vxw, qf.qa[:, None], qf.wxu,
        qf.qb[:, None], data.quad_surface.to(torch.float32)[:, None],
    ], dim=1).contiguous()
    return PackedScene(sph=sph, n_sph=int(meta.n_spheres), quad=quad,
                       n_quad=int(meta.n_quads),
                       joined=table.contiguous(),
                       quad_base=int(data.sph_center.shape[0]))


def stack_rays(ro: V3, rd: V3, time: torch.Tensor) -> torch.Tensor:
    """[8, R] ray-minor stack: ro xyz, rd xyz, time, 0."""
    return torch.stack([ro.x, ro.y, ro.z, rd.x, rd.y, rd.z, time,
                        torch.zeros_like(time)], dim=0).contiguous()


def closest_hit_reference(packed: PackedScene, rays: torch.Tensor,
                          t_min: float = T_MIN, chunk: int = 256):
    """The plain PyTorch version of the kernel: the same ops in the same
    order (module docstring), elementwise over [R, chunk] tensors.
    Returns the [32, R] row output."""
    R = rays.shape[1]
    dev = rays.device
    ox, oy, oz, dx, dy, dz, tm = (rays[k][:, None] for k in range(7))
    a = _dot3(dx, dy, dz, dx, dy, dz)
    ro_rd = _dot3(ox, oy, oz, dx, dy, dz)
    ro_sq = _dot3(ox, oy, oz, ox, oy, oz)
    tdx, tdy, tdz = tm * dx, tm * dy, tm * dz
    tox, toy, toz = tm * ox, tm * oy, tm * oz
    tt = tm * tm
    tmin_a = a * t_min

    best = torch.full((R,), INF, dtype=torch.float32, device=dev)
    best_i = torch.zeros(R, dtype=torch.int64, device=dev)
    for s in range(0, packed.n_sph, chunk):
        cx, cy, cz, vx, vy, vz, ctc_r2, ccv2, vv, surf = \
            packed.sph[s:min(s + chunk, packed.n_sph)].unbind(1)
        half_b = ((ro_rd - _dot3(dx, dy, dz, cx, cy, cz))
                  - _dot3(tdx, tdy, tdz, vx, vy, vz))
        c_term = (((((ro_sq - 2.0 * _dot3(ox, oy, oz, cx, cy, cz))
                     - 2.0 * _dot3(tox, toy, toz, vx, vy, vz))
                    + ctc_r2) + tm * ccv2) + tt * vv)
        disc = half_b * half_b - a * c_term
        ok = disc >= 0.0
        sq = torch.sqrt(torch.where(ok, disc, 0.0))
        root1 = -half_b - sq
        root = torch.where(root1 > tmin_a, root1, root1 + 2.0 * sq)
        valid = ok & (root > tmin_a) & (surf != 0.0)
        ct, ci = first_min(torch.where(valid, root, INF))
        better = ct < best
        best = torch.where(better, ct, best)
        best_i = torch.where(better, ci + s, best_i)
    st = best * (1.0 / a[:, 0])

    qt = torch.full((R,), INF, dtype=torch.float32, device=dev)
    qi = torch.zeros(R, dtype=torch.int64, device=dev)
    for s in range(0, packed.n_quad, chunk):
        (nx, ny, nz, D, ax_, ay_, az_, qa, bx_, by_, bz_, qb,
         surf) = packed.quad[s:min(s + chunk, packed.n_quad)].unbind(1)
        den = _dot3(nx, ny, nz, dx, dy, dz)
        ok = torch.abs(den) >= 1e-8
        num = D - _dot3(nx, ny, nz, ox, oy, oz)
        t = torch.where(ok, num / torch.where(ok, den, 1.0), -1.0)
        alpha = ((_dot3(ax_, ay_, az_, ox, oy, oz) - qa)
                 + t * _dot3(ax_, ay_, az_, dx, dy, dz))
        beta = ((_dot3(bx_, by_, bz_, ox, oy, oz) - qb)
                + t * _dot3(bx_, by_, bz_, dx, dy, dz))
        valid = (ok & (t > t_min) & (alpha >= 0.0) & (alpha <= 1.0)
                 & (beta >= 0.0) & (beta <= 1.0) & (surf != 0.0))
        ct, ci = first_min(torch.where(valid, t, INF))
        better = ct < qt
        qt = torch.where(better, ct, qt)
        qi = torch.where(better, ci + s, qi)

    q_better = qt < st                 # sphere wins ties (world.cuh order)
    t = torch.where(q_better, qt, st)
    idx = torch.where(q_better, qi, best_i)
    kind = torch.where(t < INF, torch.where(q_better, K_QUAD, K_SPHERE),
                       K_NONE)
    g = torch.where(q_better, qi + packed.quad_base, best_i)
    row = torch.zeros((ROW_K, R), dtype=torch.float32, device=dev)
    row[:packed.joined.shape[1]] = packed.joined[g].T
    row[ROW_T] = t
    row[ROW_KIND] = kind.to(torch.float32)
    row[ROW_IDX] = idx.to(torch.float32)
    return row


def _check(name, x, dtype, device, ndim, cols=None):
    if x.dtype != dtype or x.device != device or x.dim() != ndim \
            or not x.is_contiguous() or (cols is not None
                                         and x.shape[1] != cols):
        raise ValueError(
            f"closest_hit: {name} must be a contiguous {dtype} tensor with "
            f"{ndim} dims{'' if cols is None else f' and {cols} columns'} "
            f"on {device}; got {x.dtype} {tuple(x.shape)} on {x.device} "
            f"(contiguous={x.is_contiguous()})")


def _launch(packed: PackedScene, rays: torch.Tensor, t_min: float):
    global launch_count
    from .._build import load_library

    dev = rays.device
    _check("rays", rays, torch.float32, dev, 2)
    if rays.shape[0] != 8:
        raise ValueError(f"closest_hit: rays must be [8, R], got "
                         f"{tuple(rays.shape)}")
    _check("sph", packed.sph, torch.float32, dev, 2, SPH_COLS)
    _check("quad", packed.quad, torch.float32, dev, 2, QUAD_COLS)
    _check("joined", packed.joined, torch.float32, dev, 2)
    n_join, k_join = packed.joined.shape
    if (k_join > ROW_T or packed.n_sph > packed.sph.shape[0]
            or packed.n_quad > packed.quad.shape[0]
            or packed.quad_base + packed.n_quad > n_join
            or packed.n_sph > packed.quad_base or n_join < 1):
        raise ValueError("closest_hit: inconsistent PackedScene shapes")
    R = rays.shape[1]
    if R >= 2 ** 31 // ROW_K:
        raise ValueError(f"closest_hit: {R} rays exceed the int32 range")
    out = torch.empty((ROW_K, R), dtype=torch.float32, device=dev)
    lib = load_library("closest_hit")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mort_closest_hit(
            rays.data_ptr(), R,
            packed.sph.data_ptr(), packed.n_sph,
            packed.quad.data_ptr(), packed.n_quad,
            packed.joined.data_ptr(), k_join, packed.quad_base,
            ctypes.c_float(t_min), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(
            f"closest_hit kernel launch failed: CUDA error {rc} "
            f"({lib.mort_cuda_error_string(rc).decode()})")
    launch_count += 1
    return out


def closest_hit(packed: PackedScene, ro: V3, rd: V3, time: torch.Tensor,
                t_min: float = T_MIN):
    """Closest hit of R rays: (t [R] with +inf misses, kind int32 [R],
    idx int32 [R], row_t [32, R]).  CUDA tensors launch the kernel; CPU
    tensors take ``closest_hit_reference``."""
    rays = stack_rays(ro, rd, time)
    if rays.device.type == "cuda":
        row = _launch(packed, rays, t_min)
    elif rays.device.type == "cpu":
        row = closest_hit_reference(packed, rays, t_min)
    else:
        raise ValueError(f"closest_hit: unsupported device {rays.device}")
    return split_row(row)


def split_row(row: torch.Tensor):
    """The public layout (t, kind int32, idx int32, row_t) of a [32, R]
    output."""
    return (row[ROW_T], row[ROW_KIND].to(torch.int32),
            row[ROW_IDX].to(torch.int32), row)
