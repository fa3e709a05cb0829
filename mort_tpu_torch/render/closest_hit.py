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

Gradient (the port of ``_closest_hit_vjp`` and ``_t_winner``): the winner
(kind, idx) is a detached discrete choice, as in the JAX package; given
it, t is an analytic function of the ray and the winner's record, and the
row a gather of the joined table.  Where an operand needs a gradient,
``closest_hit`` runs through the autograd Function ``_ClosestHit``, whose
backward launches the CUDA kernel
``closest_hit_bwd`` on a CUDA tensor (``launch_count["bwd"]``) and takes
``closest_hit_bwd_reference`` on a CPU tensor.  It does not depend on the
accel mode: every mode gives the same winner.  The cull boxes and the bvh
tree are built detached (a traversal decision has no gradient).
"""

from __future__ import annotations

import ctypes
import dataclasses
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

# Kernel launches per forward mode and of the backward ("bwd") since import
# (or since a caller reset them).
launch_count = dict.fromkeys(ACCELS + ("bwd",), 0)


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
        # traversal decisions are not differentiable (the JAX package's
        # stop_gradient on its boxes and tree)
        with torch.no_grad():
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


def _launch(packed: PackedScene, rays: torch.Tensor, t_min: float,
            n_tests: torch.Tensor | None = None):
    """Launch the forward kernel of ``packed.accel``; returns the [32, R]
    output.  ``n_tests``: an optional int64 [2] card tensor to which the
    launch adds the sphere and quad tests it performs (rows whose surface
    flag is 0 are not tests); the results do not depend on it."""
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
    count_ptr = 0
    if n_tests is not None:
        _check("n_tests", n_tests, torch.int64, dev, 1)
        if n_tests.shape[0] != 2:
            raise ValueError("closest_hit: n_tests must be int64 [2]")
        count_ptr = n_tests.data_ptr()
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
            packed.n_sph_sub, packed.n_accel, out.data_ptr(), count_ptr,
            stream)
    if rc != 0:
        raise RuntimeError(
            f"closest_hit kernel launch failed ({accel}): CUDA error {rc} "
            f"({lib.mort_cuda_error_string(rc).decode()})")
    launch_count[accel] += 1
    return out


def closest_hit_bwd_reference(rays, kind, idx, dt, drow, sph, quad,
                              joined_shape, quad_base, t_min=T_MIN,
                              absolute=False):
    """The plain PyTorch version of the backward kernel: the vector-Jacobian
    product of (t, row) for the detached winner, as the JAX package's
    ``_closest_hit_vjp`` bwd with ``_t_winner``'s guards.

    ``rays`` [8, R], ``kind``/``idx`` int32 [R] (the forward's winner),
    cotangents ``dt`` [R] and ``drow`` [32, R]; ``sph`` [Ns, 10] and
    ``quad`` [Nq, 13] the records the forward scanned.  Returns
    (d_rays [8, R], d_sph, d_quad, d_joined of ``joined_shape``).

    The row's t output aliases t, so its cotangent folds in (rows 28-31
    carry none); miss lanes contribute nothing (the forward read joined row
    0 for them).  The root (near or far) is chosen again with the forward's
    exact rounding (the ops of ``closest_hit_reference``); then, with
    root = -half_b -+ sqrt(disc) and t = root / a,

        sphere: the partials of t through half_b, c_term and a = |rd|^2
                into the record columns c, cv, c.c-r^2, 2c.cv, |cv|^2 and
                the ray;
        quad:   t = (D - n.o) / (n.d): dD = 1/den, dn = -(o + t d)/den,
                do = -n/den, dd = -t n/den.

    ``a`` is guarded to 1 where it is 0 and ``disc`` clamped at 1e-30, so a
    lane's cotangent is never NaN x 0.

    ``absolute=True`` sums |term| instead of each term into d_sph, d_quad and
    d_joined: the scale against which a sum taken in another order (the
    kernel's atomics) is held."""
    mag = torch.abs if absolute else (lambda x: x)
    dev = rays.device
    hit = kind != K_NONE
    dte = torch.where(hit, dt + drow[ROW_T], 0.0)
    d_rays = torch.zeros_like(rays)
    d_sph = torch.zeros_like(sph)
    d_quad = torch.zeros_like(quad)
    d_joined = torch.zeros(joined_shape, dtype=torch.float32, device=dev)
    k_join = joined_shape[1]
    lanes = hit.nonzero().squeeze(1)
    g = torch.where(kind == K_QUAD, idx + quad_base, idx).long()
    d_joined.index_add_(0, g[lanes], mag(drow[:k_join, lanes].T))

    s = (kind == K_SPHERE).nonzero().squeeze(1)
    if s.numel():
        j = idx[s].long()
        cx, cy, cz, vx, vy, vz, ctc_r2, ccv2, vv, _ = sph[j].unbind(1)
        ox, oy, oz, dx, dy, dz, tm = (rays[k][s] for k in range(7))
        # the forward's ops, in its order (closest_hit_reference)
        a = _dot3(dx, dy, dz, dx, dy, dz)
        ro_rd = _dot3(ox, oy, oz, dx, dy, dz)
        ro_sq = _dot3(ox, oy, oz, ox, oy, oz)
        half_b = ((ro_rd - _dot3(dx, dy, dz, cx, cy, cz))
                  - _dot3(tm * dx, tm * dy, tm * dz, vx, vy, vz))
        c_term = (((((ro_sq - 2.0 * _dot3(ox, oy, oz, cx, cy, cz))
                     - 2.0 * _dot3(tm * ox, tm * oy, tm * oz, vx, vy, vz))
                    + ctc_r2) + tm * ccv2) + (tm * tm) * vv)
        disc = half_b * half_b - a * c_term
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        root1 = -half_b - sq
        far = ~(root1 > a * t_min)
        root = torch.where(far, root1 + 2.0 * sq, root1)
        # d root / d(half_b, c_term, a), then t = root / a
        sgn = torch.where(far, 1.0, -1.0)
        live = disc > 1e-30
        sq_g = torch.sqrt(torch.clamp(disc, min=1e-30))
        a_ok = a > 0.0
        a_g = torch.where(a_ok, a, 1.0)
        G = dte[s] / a_g
        g_hb = G * (torch.where(live, sgn * half_b / sq_g, 0.0) - 1.0)
        g_ct = G * torch.where(live, -sgn * a_g / (2.0 * sq_g), 0.0)
        g_a = torch.where(
            a_ok, G * torch.where(live, -sgn * c_term / (2.0 * sq_g), 0.0)
            - G * root / a_g, 0.0)
        # half_b = o.d - c.d - tm cv.d
        # c_term = |o|^2 - 2 c.o - 2 tm cv.o + (c.c-r^2) + tm 2c.cv
        #          + tm^2 |cv|^2
        dcx = -g_hb * dx - 2.0 * g_ct * ox
        dcy = -g_hb * dy - 2.0 * g_ct * oy
        dcz = -g_hb * dz - 2.0 * g_ct * oz
        zero = torch.zeros_like(G)
        d_sph.index_add_(0, j, mag(torch.stack([
            dcx, dcy, dcz, tm * dcx, tm * dcy, tm * dcz,
            g_ct, g_ct * tm, g_ct * tm * tm, zero], dim=1)))
        ex, ey, ez = ox - cx - tm * vx, oy - cy - tm * vy, oz - cz - tm * vz
        d_rays[:7, s] = torch.stack([
            g_hb * dx + 2.0 * g_ct * ex,
            g_hb * dy + 2.0 * g_ct * ey,
            g_hb * dz + 2.0 * g_ct * ez,
            g_hb * ex + 2.0 * g_a * dx,
            g_hb * ey + 2.0 * g_a * dy,
            g_hb * ez + 2.0 * g_a * dz,
            -g_hb * _dot3(vx, vy, vz, dx, dy, dz)
            + g_ct * (ccv2 + 2.0 * tm * vv
                      - 2.0 * _dot3(vx, vy, vz, ox, oy, oz))])

    q = (kind == K_QUAD).nonzero().squeeze(1)
    if q.numel():
        j = idx[q].long()
        nx, ny, nz, D = quad[j, :4].unbind(1)
        ox, oy, oz, dx, dy, dz = (rays[k][q] for k in range(6))
        den = _dot3(nx, ny, nz, dx, dy, dz)
        den_g = torch.where(torch.abs(den) >= 1e-8, den, 1.0)
        t = (D - _dot3(nx, ny, nz, ox, oy, oz)) / den_g
        G = dte[q] / den_g
        zero = torch.zeros_like(G)
        d_quad.index_add_(0, j, mag(torch.stack(
            [-G * (ox + t * dx), -G * (oy + t * dy), -G * (oz + t * dz), G]
            + [zero] * (QUAD_COLS - 4), dim=1)))
        d_rays[:6, q] = torch.stack([-G * nx, -G * ny, -G * nz,
                                     -G * t * nx, -G * t * ny, -G * t * nz])
    return d_rays, d_sph, d_quad, d_joined


def _launch_bwd(rays, kind, idx, dt, drow, sph, quad, joined_shape,
                quad_base, t_min):
    """Launch the backward kernel (its plain version is
    ``closest_hit_bwd_reference``); the gradient buffers are allocated
    zeroed here and the kernel adds into them with atomics."""
    from .._build import load_library

    dev = rays.device
    _check("rays", rays, torch.float32, dev, 2)
    R = rays.shape[1]
    if rays.shape[0] != 8 or R >= 2 ** 31 // ROW_K:
        raise ValueError(f"closest_hit_bwd: rays must be [8, R < 2^26], got "
                         f"{tuple(rays.shape)}")
    for name, x, dtype in (("kind", kind, torch.int32),
                           ("idx", idx, torch.int32),
                           ("dt", dt, torch.float32)):
        _check(name, x, dtype, dev, 1)
        if x.shape[0] != R:
            raise ValueError(f"closest_hit_bwd: {name} must have {R} lanes")
    _check("drow", drow, torch.float32, dev, 2)
    if tuple(drow.shape) != (ROW_K, R):
        raise ValueError(f"closest_hit_bwd: drow must be [{ROW_K}, {R}]")
    _check("sph", sph, torch.float32, dev, 2, SPH_COLS)
    _check("quad", quad, torch.float32, dev, 2, QUAD_COLS)
    n_join, k_join = joined_shape
    if k_join > ROW_T or quad_base + quad.shape[0] > n_join:
        raise ValueError("closest_hit_bwd: inconsistent table shapes")
    d_rays = torch.empty_like(rays)
    d_sph = torch.zeros_like(sph)
    d_quad = torch.zeros_like(quad)
    d_joined = torch.zeros(joined_shape, dtype=torch.float32, device=dev)
    lib = load_library("closest_hit")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mort_closest_hit_bwd(
            rays.data_ptr(), R, kind.data_ptr(), idx.data_ptr(),
            dt.data_ptr(), drow.data_ptr(), sph.data_ptr(), quad.data_ptr(),
            k_join, quad_base, ctypes.c_float(t_min), d_rays.data_ptr(),
            d_sph.data_ptr(), d_quad.data_ptr(), d_joined.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(
            f"closest_hit_bwd kernel launch failed: CUDA error {rc} "
            f"({lib.mort_cuda_error_string(rc).decode()})")
    launch_count["bwd"] += 1
    return d_rays, d_sph, d_quad, d_joined


class _ClosestHit(torch.autograd.Function):
    """The closest hit with a gradient (the JAX package's custom VJP): the
    ray stack and the three record tables are inputs, so gradients reach
    ``pack_scene`` and ``build_prim_table``; ``packed`` supplies only the
    static fields (counts, quad_base, accel mode and its detached table)."""

    @staticmethod
    def forward(ctx, rays, sph, quad, joined, packed, t_min):
        p = dataclasses.replace(packed, sph=sph, quad=quad, joined=joined)
        row = _forward_row(p, rays, t_min)
        t = row[ROW_T].clone()
        kind = row[ROW_KIND].to(torch.int32)
        idx = row[ROW_IDX].to(torch.int32)
        ctx.mark_non_differentiable(kind, idx)
        ctx.save_for_backward(rays, sph, quad, kind, idx)
        ctx.static = (tuple(joined.shape), packed.quad_base, t_min)
        return t, kind, idx, row

    @staticmethod
    def backward(ctx, dt, _dkind, _didx, drow):
        rays, sph, quad, kind, idx = ctx.saved_tensors
        joined_shape, quad_base, t_min = ctx.static
        bwd = (_launch_bwd if rays.device.type == "cuda"
               else closest_hit_bwd_reference)
        d_rays, d_sph, d_quad, d_joined = bwd(
            rays, kind, idx, dt.contiguous(), drow.contiguous(), sph, quad,
            joined_shape, quad_base, t_min)
        return d_rays, d_sph, d_quad, d_joined, None, None


def closest_hit(packed: PackedScene, ro: V3, rd: V3, time: torch.Tensor,
                t_min: float = T_MIN):
    """Closest hit of R rays: (t [R] with +inf misses, kind int32 [R],
    idx int32 [R], row_t [32, R]).  CUDA tensors launch the kernel of
    ``packed.accel``; CPU tensors take ``closest_hit_reference``.
    Differentiable in the rays and in ``packed``'s sph, quad and joined
    tables: where one of them needs a gradient the call goes through
    ``_ClosestHit``, otherwise (a forward render) straight to the kernel."""
    rays = stack_rays(ro, rd, time)
    operands = (rays, packed.sph, packed.quad, packed.joined)
    if torch.is_grad_enabled() and any(x.requires_grad for x in operands):
        return _ClosestHit.apply(*operands, packed, t_min)
    return split_row(_forward_row(packed, rays, t_min))


def _forward_row(packed: PackedScene, rays: torch.Tensor, t_min: float):
    """The [32, R] output: the kernel on a CUDA tensor, its plain version on
    a CPU tensor."""
    if rays.device.type == "cuda":
        return _launch(packed, rays, t_min)
    if rays.device.type == "cpu":
        return closest_hit_reference(packed, rays, t_min)
    raise ValueError(f"closest_hit: unsupported device {rays.device}")


def split_row(row: torch.Tensor):
    """The public layout (t, kind int32, idx int32, row_t) of a [32, R]
    output."""
    return (row[ROW_T], row[ROW_KIND].to(torch.int32),
            row[ROW_IDX].to(torch.int32), row)
