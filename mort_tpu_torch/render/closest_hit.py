"""Closest sphere/quad hit + joined shading row: the hand-written kernel.

The port of ``mort_tpu.render.pallas_intersect`` (``_closest_hit`` /
``_make_kernel`` in its accel modes ``"none"``, ``"cull"`` and ``"bvh"``,
``cluster_boxes``, ``cluster_tree``, ``auto_accel``, ``pack_for_kernel``,
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

Accel modes (``PackedScene.accel``): ``"none"`` tests every primitive;
``"cull"`` tests the CL-sized sub-clusters of ``cluster_boxes`` behind an
AABB slab test; ``"bvh"`` traverses the implicit heap ``cluster_tree`` over
them.  A mode changes which primitives a ray tests, not the function's
value: the kernel keeps the lexicographic minimum over (t, row) and prunes
only boxes that cannot hold a winner or a tie, so every mode returns the
result of ``"none"`` bit for bit, and ``closest_hit_reference`` is the
plain version of all three.  ``auto_accel`` is the JAX package's policy.

Dispatch: a CUDA tensor always launches the kernel of the packed mode (a
failure raises; no mode falls back to another); a CPU tensor takes the
plain version whatever the mode.  ``launch_count[mode]`` counts launches.
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

CK = 512         # sphere/quad rows are padded to CK for the sub-clusters
CL = 128         # primitives per sub-cluster (one AABB)
STACK = 32       # bvh traversal stack depth: holds a heap of 2^30 leaves
BIG = 3.0e38     # inverted-box bound
BOX_COLS = 8     # cull boxes: lo xyz, hi xyz, 0, 0
NODE_COLS = 6    # bvh nodes: lo xyz, hi xyz

# The auto accel policy's crossover (the JAX package's BVH_MIN_PRIMS):
# "none" up to 8192 primitives, "bvh" above.
BVH_MIN_PRIMS = 8192
ACCELS = ("none", "cull", "bvh")
_MODE = {"none": 0, "cull": 1, "bvh": 2}

# Kernel launches per mode since import (or since a caller reset them).
launch_count = dict.fromkeys(ACCELS, 0)


def auto_accel(n_prims: int) -> str:
    """The accel mode picked when none is asked for."""
    return "none" if n_prims <= BVH_MIN_PRIMS else "bvh"


@dataclass(frozen=True)
class PackedScene:
    """Every kernel operand, built once per render span."""
    sph: torch.Tensor      # [Ns_rows, SPH_COLS] f32
    n_sph: int             # sphere rows to scan (the rest is padding)
    quad: torch.Tensor     # [Nq_rows, QUAD_COLS] f32
    n_quad: int
    joined: torch.Tensor   # [Ns_rows + Nq_rows, 27] f32 (primtable)
    quad_base: int         # global row of quad 0 in ``joined`` (= Ns_rows)
    accel: str = "none"    # "none", "cull" or "bvh"
    # "cull": cluster_boxes [n_sub, BOX_COLS]; "bvh": cluster_tree
    # [2L, NODE_COLS]; "none": empty
    accel_tab: torch.Tensor | None = None
    n_sph_sub: int = 0     # sub-clusters that hold sphere rows (the first)
    n_accel: int = 0       # "cull": n_sub; "bvh": L (leaf s is node L + s)


def _dot3(ax, ay, az, bx, by, bz):
    return (ax * bx + ay * by) + az * bz


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _n_sph_sub(data: SceneData, meta: SceneMeta) -> int:
    if not meta.n_spheres:
        return 0
    return _round_up(max(data.sph_center.shape[0], CK), CK) // CL


def _sub_boxes(lo, hi, surf, n_pad):
    """Per-row boxes -> [n_pad // CL, 8] sub-cluster boxes; skip and
    padding rows get inverted boxes (min > max)."""
    n = lo.shape[0]
    lo = torch.where(surf[:, None], lo, BIG)
    hi = torch.where(surf[:, None], hi, -BIG)
    pad = torch.full((n_pad - n, 3), BIG, dtype=lo.dtype, device=lo.device)
    lo = torch.cat([lo, pad]).reshape(-1, CL, 3).amin(dim=1)
    hi = torch.cat([hi, -pad]).reshape(-1, CL, 3).amax(dim=1)
    return torch.cat([lo, hi, torch.zeros_like(lo[:, :2])], dim=1)


def cluster_boxes(data: SceneData, meta: SceneMeta) -> torch.Tensor:
    """[n_sub, 8] f32 conservative AABBs (min xyz, max xyz, 0, 0) of the
    CL-sized sub-clusters of primitive rows, sphere sub-clusters first
    (rows padded to a CK multiple), then quad sub-clusters — the JAX
    package's ``cluster_boxes``.  Moving spheres get their swept box over
    t in [0, 1]; quads a +-1e-4 pad around their four corners."""
    parts = []
    if meta.n_spheres:
        c, cv = data.sph_center, data.sph_cvec
        r = torch.abs(data.sph_radius)[:, None]
        parts.append(_sub_boxes(torch.minimum(c, c + cv) - r,
                                torch.maximum(c, c + cv) + r,
                                data.sph_surface, _n_sph_sub(data, meta) * CL))
    if meta.n_quads:
        Q, u, v = data.quad_Q, data.quad_u, data.quad_v
        corners = torch.stack([Q, Q + u, Q + v, Q + u + v], dim=0)
        n_pad = _round_up(max(Q.shape[0], CK), CK)
        parts.append(_sub_boxes(corners.amin(dim=0) - 1e-4,
                                corners.amax(dim=0) + 1e-4,
                                data.quad_surface, n_pad))
    return torch.cat(parts, dim=0).contiguous()


def cluster_tree(cbox: torch.Tensor) -> torch.Tensor:
    """Implicit-heap AABB tree over the (Morton-ordered, so spatially
    coherent) sub-clusters: [2L, 6] f32 (lo xyz, hi xyz) with node 1 the
    root, children (2k, 2k+1) and leaves at [L, L + n_sub); row 0 and
    padding leaves carry inverted boxes — the JAX package's
    ``cluster_tree``."""
    n_sub = cbox.shape[0]
    L = 1
    while L < n_sub:
        L *= 2
    pad = torch.full((L - n_sub, 3), BIG, dtype=cbox.dtype,
                     device=cbox.device)
    levels = [(torch.cat([cbox[:, 0:3], pad]),
               torch.cat([cbox[:, 3:6], -pad]))]
    while levels[0][0].shape[0] > 1:
        lo, hi = levels[0]
        levels.insert(0, (torch.minimum(lo[0::2], lo[1::2]),
                          torch.maximum(hi[0::2], hi[1::2])))
    root_pad = torch.full((1, 3), BIG, dtype=cbox.dtype, device=cbox.device)
    los = torch.cat([root_pad] + [lo for lo, _ in levels])
    his = torch.cat([-root_pad] + [hi for _, hi in levels])
    return torch.cat([los, his], dim=1).contiguous()


def pack_scene(data: SceneData, meta: SceneMeta, qf: QuadFrames,
               table: torch.Tensor, accel: str = "none") -> PackedScene:
    """Per-primitive records for the closest-hit scan (host-side
    precompute of every ray-independent term), the joined table and the
    accel mode's boxes or tree."""
    if accel not in ACCELS:
        raise ValueError(f"closest_hit: accel must be one of {ACCELS}, got "
                         f"{accel!r}")
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
    accel_tab, n_accel = None, 0
    if accel != "none":
        accel_tab = cluster_boxes(data, meta)
        n_accel = accel_tab.shape[0]
        if accel == "bvh":
            accel_tab = cluster_tree(accel_tab)
            n_accel = accel_tab.shape[0] // 2
    return PackedScene(sph=sph, n_sph=int(meta.n_spheres), quad=quad,
                       n_quad=int(meta.n_quads),
                       joined=table.contiguous(),
                       quad_base=int(data.sph_center.shape[0]),
                       accel=accel, accel_tab=accel_tab,
                       n_sph_sub=_n_sph_sub(data, meta), n_accel=n_accel)


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
    accel = packed.accel
    accel_ptr = 0
    if accel != "none":
        tab, n_acc, n_ss = packed.accel_tab, packed.n_accel, packed.n_sph_sub
        cols = BOX_COLS if accel == "cull" else NODE_COLS
        _check("accel_tab", tab, torch.float32, dev, 2, cols)
        n_leaves = n_acc if accel == "cull" else tab.shape[0] - n_acc
        if ((accel == "bvh" and (tab.shape[0] != 2 * n_acc
                                 or n_acc > 2 ** (STACK - 2)))
                or (accel == "cull" and tab.shape[0] != n_acc)
                or n_ss * CL < packed.n_sph
                or (n_leaves - n_ss) * CL < packed.n_quad):
            raise ValueError("closest_hit: inconsistent accel table")
        accel_ptr = tab.data_ptr()
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
            ctypes.c_float(t_min), _MODE[accel], accel_ptr,
            packed.n_sph_sub, packed.n_accel, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(
            f"closest_hit kernel launch failed ({accel}): CUDA error {rc} "
            f"({lib.mort_cuda_error_string(rc).decode()})")
    launch_count[accel] += 1
    return out


def closest_hit(packed: PackedScene, ro: V3, rd: V3, time: torch.Tensor,
                t_min: float = T_MIN):
    """Closest hit of R rays: (t [R] with +inf misses, kind int32 [R],
    idx int32 [R], row_t [32, R]).  CUDA tensors launch the kernel of
    ``packed.accel``; CPU tensors take ``closest_hit_reference``."""
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
