"""Closest sphere/quad hit + joined shading row: the hand-written kernel.

The port of ``mort_tpu.render.pallas_intersect`` (``_closest_hit`` /
``_make_kernel`` in its accel modes ``"none"``, ``"cull"`` and ``"bvh"``,
``cluster_boxes``, ``auto_accel``, ``pack_for_kernel``,
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

Accel modes (``PackedScene.accel``): ``"none"`` tests every sphere, every
quad that is neither axis-aligned nor a face of a closed axis-aligned box
(``gen_rows``), the axis-aligned quads group by orientation with a test
specialised to the axes (``aaq_tab``, ``aaq_groups``), then each box of
``SceneMeta.aab`` behind a slab test (``aab_tab``) and only the faces of the
boxes a ray enters (``aab_faces``); ``"cull"`` tests the CL-sized
sub-clusters of ``cluster_boxes`` whose box a ray enters, sub-cluster-major:
the pairs (ray, entered sub-cluster) are binned by sub-cluster in ray order
(launches of at most CULL_MAX_PAIRS bin slots, ``cull_slices``; the
scratch sized by the library), a block tests one bin's rays against its
sub-cluster's rows staged in shared memory, and each ray's sphere and quad
(t, row) minima are integer minima of keys (t bits, row);
``"bvh"`` traverses ``bvh_tree``, an implicit heap whose leaves are single
rows (the JAX package's ``cluster_tree`` had the 128-row sub-clusters for
leaves: a TPU vector step, but 128 tests for a GPU thread).  A mode
changes which primitives a ray tests, not the function's value: the
kernel keeps the lexicographic minimum over (t, row) and prunes only boxes
that cannot hold a winner or a tie, so every mode returns the result of
the plain scan over every primitive bit for bit, and
``closest_hit_reference`` is the plain version of all three.
``auto_accel`` is the JAX package's policy.

The boxes of ``"cull"`` and ``"bvh"`` are widened (``_widen``, AAB_SLACK,
SPHERE_ERR): the float32 sphere test reports hits outside a sphere's box
near its silhouette, and a quad's pad is thinner than its window test's
rounding near coordinate 1000.

The box slab test of ``"none"`` decides only which faces are tested: the
faces' t is the general quad test's, not the slab's (the JAX package's
``_aab_best`` reads t off the slab, an ulp away from ``(D - n.o)/(n.d)``).
A box is entered when its slab interval, widened by ``AAB_SLACK`` times
(max |o| + max |box corner|), reaches (t_min, bound]: the +-1e-4 pad alone
is thinner than the rounding of the face test's window at the scene's
coordinates (PERF.md).

The specialised test of an axis-aligned quad (``aaq_tables``) is the
general test with the frame's exact zeros left out: ``quad_frames`` gives an
axis-aligned quad a normal, ``vxw`` and ``wxu`` whose off-axis components
are exact zeros (cross products of axis vectors), so for a finite ray each
3-term dot of the general test is exactly its one nonzero product (up to
the sign of a zero, which no comparison sees), and the specialised test
returns the general test's t bit for bit.  n_k, D, a_i, qa, b_j and qb are
read from the quad's record (n_k is not assumed to be +-1).  A ray with a
non-finite component (where the general test's 0 * inf is NaN) takes the
general test on these rows in the kernel, and a row whose frame is no
longer axis-aligned (``quad_u``/``quad_v`` moved by a gradient step) goes
to ``gen_rows``, so the result is the plain scan's for every ray.  The JAX package's ``_aaq_group_best`` takes t
as ``(Q_k - ro_k) * (1 / rd_k)``, an ulp away; that formula is not adopted.

Dispatch: a CUDA tensor always launches the kernel of the packed mode (a
failure raises; no mode falls back to another); a CPU tensor takes the
plain version whatever the mode.  ``launch_count[mode]`` counts launches.

Gradient (the port of ``_closest_hit_vjp`` and ``_t_winner``): the winner
(kind, idx) is a detached discrete choice, as in the JAX package; given
it, t is an analytic function of the ray and the winner's record, and the
row a gather of the joined table.  Where an operand needs a gradient,
``closest_hit`` runs through the autograd Function ``_ClosestHit``, whose
backward launches the CUDA kernels ``closest_hit_bwd_*`` on a CUDA tensor
(``launch_count["bwd"]``, one a backward) and takes
``closest_hit_bwd_reference`` on a CPU tensor.  It does not depend on the
accel mode: every mode gives the same winner.  The cull boxes and the bvh
tree are built detached (a traversal decision has no gradient).  The
kernels sum each table entry's terms in a fixed order, pairwise trees over
the lanes of a warp, the warps of a ``BWD_TILE``-lane tile and the tiles,
each in order, with no float atomic: two launches give the same bits, and
``closest_hit_bwd_ordered``, the plain mirror of that order, gives them
too.  ``closest_hit_bwd_reference`` sums with ``index_add_`` in its own
order: the three agree within a float tolerance of each entry's sum of
|terms|, and their d_rays bit for bit.
"""

from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass

import torch

from ..device import constant
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
BIG = 3.0e38     # inverted-box bound
BOX_COLS = 8     # cull boxes: lo xyz, hi xyz, r_min, 0 (cull_boxes);
                 # aab_tab: lo xyz, hi xyz, max |corner|, 0
NODE_COLS = 12   # bvh node k: the boxes of children 2k and 2k+1 (bvh_tree)
QUAD_PAD = 1e-4  # pad of a quad's box around its four corners
# Every slab test widens its box so that no hit the sphere or quad test
# reports is pruned by the rounding of the test or of the slab: by
# AAB_SLACK * (max |o| + the box's largest |coordinate|) (the window test of
# a quad near coordinate 1000; "none" takes max |corner| of a closed box),
# and, in "cull" and "bvh" where the box holds spheres, by the sphere
# test's error: a hit it reports lies within sqrt(r^2 + k S^2) of the
# centre, S = max |o| + the sphere's largest |coordinate|, k = SPHERE_ERR =
# 64 * 2^-24 (the expanded quadratic cancels near silhouettes; the largest
# k seen on grazing rays is 17.3 * 2^-24, tests/test_torch_bvh.py).  In
# "cull" and "bvh" the part of max |o| is added per ray, the rest is built
# into the boxes (``_widen``).
AAB_SLACK = 2.0 ** -16
SPHERE_ERR = 2.0 ** -18
# n_tests counters: sphere tests, quad tests (the general test), box or node
# slab tests, axis-aligned quad tests (the specialised test of "none"), and
# the pairs (ray, entered sub-cluster) of "cull"'s bins
N_TESTS = 5
# The most bin slots (ray x sub-cluster) of one "cull" launch: _launch
# splits a larger ray set (cull_slices).  2^25 keeps spread16k's 128
# sub-clusters at R = 2^18 in one launch (128 MB of int32 bins); the bins'
# slots are int32, so a launch needs R n_sub < 2^31.
CULL_MAX_PAIRS = 1 << 25
AAQ_COLS = 8     # aaq_tab: n_k D a_i qa b_j qb row live (aaq_tables)
AAQ_GROUP_COLS = 5   # aaq_groups: start n k i j

# The auto accel policy's crossover (the JAX package's BVH_MIN_PRIMS):
# "none" up to 8192 primitives, "bvh" above.
BVH_MIN_PRIMS = 8192
ACCELS = ("none", "cull", "bvh")
# mort_closest_hit's modes ("cull" has its own entry, mort_closest_hit_cull)
_MODE = {"none": 0, "bvh": 2}

# The backward's order of adds (closest_hit_bwd_ordered): pairwise trees
# over the lanes of a warp, over the warps of a tile of BWD_TILE lanes (the
# kernel's block), then over the tiles; BWD_LEVELS, the units a group
# gathers at each level (None: all)
WARP = 32
BWD_TILE = 256
BWD_LEVELS = (WARP, BWD_TILE // WARP, None)
REC_TERMS = 9    # record partials a hit lane adds (a quad's past 4 are 0)

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
    # "cull": cull_boxes [n_sub, BOX_COLS]; "bvh": bvh_tree's nodes
    # [L, NODE_COLS]; "none": empty
    accel_tab: torch.Tensor | None = None
    n_sph_sub: int = 0     # "cull": sub-clusters that hold sphere rows (the
                           # first)
    n_accel: int = 0       # "cull": n_sub; "bvh": L (leaf s is node L + s)
    # "none": the closed axis-aligned boxes of SceneMeta.aab [n_box,
    # BOX_COLS], their face rows [n_box, 6] int32 in (lo_x, hi_x, lo_y,
    # hi_y, lo_z, hi_z) order, and every other quad row [n_gen] int32
    aab_tab: torch.Tensor | None = None
    aab_faces: torch.Tensor | None = None
    gen_rows: torch.Tensor | None = None
    # "none": the axis-aligned quads by orientation (aaq_tables):
    # [n_aaq, AAQ_COLS] f32 and the groups [n_groups, AAQ_GROUP_COLS] int32
    aaq_tab: torch.Tensor | None = None
    aaq_groups: torch.Tensor | None = None


def _dot3(ax, ay, az, bx, by, bz):
    return (ax * bx + ay * by) + az * bz


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _n_sph_sub(data: SceneData, meta: SceneMeta) -> int:
    if not meta.n_spheres:
        return 0
    return _round_up(max(data.sph_center.shape[0], CK), CK) // CL


def _sphere_bounds(data: SceneData):
    """Per-sphere (lo [Ns, 3], hi [Ns, 3]): a moving sphere's swept box
    over t in [0, 1]."""
    c, cv = data.sph_center, data.sph_cvec
    r = torch.abs(data.sph_radius)[:, None]
    return torch.minimum(c, c + cv) - r, torch.maximum(c, c + cv) + r


def _group_boxes(lo, hi, surf, n_pad, group):
    """Per-row boxes [n, 3] -> (lo, hi) [n_pad // group, 3] of groups of
    ``group`` consecutive rows; skip and padding rows count as inverted
    boxes (min > max), so a group of only such rows stays inverted."""
    n = lo.shape[0]
    lo = torch.where(surf[:, None], lo, BIG)
    hi = torch.where(surf[:, None], hi, -BIG)
    pad = torch.full((n_pad - n, 3), BIG, dtype=lo.dtype, device=lo.device)
    return (torch.cat([lo, pad]).reshape(-1, group, 3).amin(dim=1),
            torch.cat([hi, -pad]).reshape(-1, group, 3).amax(dim=1))


def cluster_boxes(data: SceneData, meta: SceneMeta) -> torch.Tensor:
    """[n_sub, 8] f32 conservative AABBs (min xyz, max xyz, 0, 0) of the
    CL-sized sub-clusters of primitive rows, sphere sub-clusters first
    (rows padded to a CK multiple), then quad sub-clusters — the JAX
    package's ``cluster_boxes``.  Moving spheres get their swept box over
    t in [0, 1]; quads a +-1e-4 pad around their four corners."""
    parts = []
    if meta.n_spheres:
        parts.append(_group_boxes(*_sphere_bounds(data), data.sph_surface,
                                  _n_sph_sub(data, meta) * CL, CL))
    if meta.n_quads:
        n_pad = _round_up(max(data.quad_Q.shape[0], CK), CK)
        parts.append(_group_boxes(*quad_bounds(data), data.quad_surface,
                                  n_pad, CL))
    lo, hi = (torch.cat(x) for x in zip(*parts))
    return torch.cat([lo, hi, torch.zeros_like(lo[:, :2])], dim=1
                     ).contiguous()


def quad_bounds(data: SceneData):
    """Per-quad (lo [Nq, 3], hi [Nq, 3]): the min and max of its four
    corners, padded by QUAD_PAD."""
    Q, u, v = data.quad_Q, data.quad_u, data.quad_v
    corners = torch.stack([Q, Q + u, Q + v, Q + u + v], dim=0)
    return corners.amin(dim=0) - QUAD_PAD, corners.amax(dim=0) + QUAD_PAD


def box_tables(data: SceneData, meta: SceneMeta, off_axis=()):
    """The closed axis-aligned boxes of ``meta.aab`` (the port of the JAX
    package's ``pack_aab`` and of the row list of ``pack_quads_general``):
    (aab_tab [n_box, 8] f32 = lo xyz, hi xyz of the six faces' padded
    corners (``quad_bounds``), max |lo|, |hi|, 0; aab_faces [n_box, 6]
    int32 face rows; gen_rows [n_gen] int32, the quad rows below
    ``meta.n_quads`` of ``SceneMeta.aaq_class`` 9 — neither a box's face
    (-2) nor axis-aligned (0-8, ``aaq_tables``) — in registry order, then
    the rows ``off_axis`` (``aaq_off_axis``)).  The index tensors are
    ``device.constant``s of ``meta`` and ``off_axis``: no host data is
    copied once they exist."""
    dev = data.quad_Q.device
    gen = tuple(r for r in range(meta.n_quads)
                if not meta.aaq_class or meta.aaq_class[r] == 9)
    gen_rows = constant(gen + tuple(off_axis), torch.int32, dev)
    faces = constant(tuple(map(tuple, meta.aab)), torch.int32,
                     dev).reshape(-1, 6)
    lo, hi = quad_bounds(data)
    f = faces.long()
    lo, hi = lo[f].amin(dim=1), hi[f].amax(dim=1)
    scale = torch.maximum(lo.abs(), hi.abs()).amax(dim=1, keepdim=True)
    tab = torch.cat([lo, hi, scale, torch.zeros_like(scale)], dim=1)
    return tab.contiguous(), faces.contiguous(), gen_rows


def aaq_groups_of(meta: SceneMeta) -> dict:
    """{class: [registry rows]} of the axis-aligned surface quads
    (``SceneMeta.aaq_class`` 0-8: u along axis class // 3, v along class %
    3), the JAX package's ``aaq_groups_of``."""
    groups = {}
    for row, c in enumerate(meta.aaq_class):
        if 0 <= c <= 8:
            groups.setdefault(c, []).append(row)
    return groups


def quad_records(data: SceneData, qf: QuadFrames) -> torch.Tensor:
    """[Nq, QUAD_COLS] f32: each quad's n, D, vxw, qa, wxu, qb and surface
    flag, the record the kernels test."""
    return torch.cat([
        qf.normal, qf.D[:, None], qf.vxw, qf.qa[:, None], qf.wxu,
        qf.qb[:, None], data.quad_surface.to(torch.float32)[:, None],
    ], dim=1).contiguous()


def aaq_off_axis(meta: SceneMeta, quad: torch.Tensor) -> tuple:
    """The registry rows of ``SceneMeta.aaq_class`` 0-8 whose normal, vxw
    or wxu in ``quad`` (``quad_records``) has a nonzero off-axis component
    (a gradient step moved ``quad_u`` or ``quad_v`` off the axes), in
    ``aaq_tables``' order: the specialised test would not give their bits,
    so they go to the general test.  One read of the frames on the host,
    the only one of the pack: a caller that captures the pack computes it
    first, outside the capture."""
    groups = aaq_groups_of(meta)
    cand = [r for c in sorted(groups) for r in groups[c]]
    if not cand:
        return ()
    dev = quad.device
    rec = quad[torch.tensor(cand, dtype=torch.int64, device=dev)]
    cls = torch.tensor([c for c in sorted(groups) for _ in groups[c]],
                       dtype=torch.int64, device=dev)
    lane = torch.arange(len(cand), device=dev)
    # the normal (cols 0-2) along k, vxw (4-6) along i, wxu (8-10) along
    # j; every other component of the three must be exact zeros
    i, j = cls // 3, cls % 3
    on = torch.zeros((len(cand), QUAD_COLS), dtype=torch.bool, device=dev)
    on[lane, 3 - i - j] = on[lane, 4 + i] = on[lane, 8 + j] = True
    frame = torch.tensor([0, 1, 2, 4, 5, 6, 8, 9, 10], device=dev)
    ok = ((rec == 0.0) | on)[:, frame].all(dim=1)
    return tuple(r for r, exact in zip(cand, ok.tolist()) if not exact)


def aaq_tables(meta: SceneMeta, quad: torch.Tensor, off_axis=()):
    """The axis-aligned quads of "none" (the port of the JAX package's
    ``pack_aaq``, whose groups it keeps, without its 8-row padding), from
    ``quad``, the [Nq, QUAD_COLS] records of ``quad_records``, less the
    rows ``off_axis`` (``aaq_off_axis``), which the general test takes.

    Returns (aaq_tab [n_aaq, AAQ_COLS] f32, aaq_groups [n_groups,
    AAQ_GROUP_COLS] int32).  Group g is the rows [start, start + n) of the
    table, the quads of one class in registry order, classes ascending;
    its normal lies along axis k, u along i and v along j.  A row holds
    the operands of the specialised test, n_k, D, a_i (of vxw), qa, b_j
    (of wxu), qb, then the registry row (float32-exact below 2^24) and its
    live flag (the surface flag: a skip row is never tested).  The index
    tensors are ``device.constant``s of ``meta`` and ``off_axis``."""
    groups = aaq_groups_of(meta)
    dev = quad.device
    rows, descs = [], []
    for c in sorted(groups):
        i, j = c // 3, c % 3
        keep = [r for r in groups[c] if r not in off_axis]
        if keep:
            descs.append((len(rows), len(keep), 3 - i - j, i, j))
            rows += keep
    if not rows:
        return (torch.zeros((0, AAQ_COLS), dtype=torch.float32, device=dev),
                torch.zeros((0, AAQ_GROUP_COLS), dtype=torch.int32,
                            device=dev))
    r = constant(tuple(rows), torch.int64, dev)
    rec = quad[r]
    k, i, j = constant(tuple(d[2:] for d in descs for _ in range(d[1])),
                       torch.int64, dev).unbind(1)
    lane = torch.arange(len(rows), device=dev)
    tab = torch.stack([rec[lane, k], rec[:, 3], rec[lane, 4 + i], rec[:, 7],
                       rec[lane, 8 + j], rec[:, 11], r.to(torch.float32),
                       (rec[:, 12] != 0.0).to(torch.float32)], dim=1)
    return tab.contiguous(), constant(tuple(descs), torch.int32, dev)


def sphere_pad(scale, r):
    """The widening that holds every sphere hit the float32 test reports,
    for the distance ``scale`` and the radius ``r``: sqrt(r^2 + 2 k scale^2)
    - r with k = SPHERE_ERR (0 where r is BIG: no sphere).  It is concave
    in scale and 0 at 0, so the pad of max |o| + c is at most the pad of
    max |o| (the kernel's, per ray) plus the pad of c (a box's, built in)."""
    x = 2.0 * SPHERE_ERR * scale * scale
    return x / (torch.sqrt(r * r + x) + r)


def _group_radius(data: SceneData, n, n_pad, group):
    """[n_pad // group, 1]: the smallest radius of the surface spheres of
    each group of ``group`` consecutive rows among rows [0, n), BIG where a
    group has none."""
    r = torch.where(data.sph_surface[:n], data.sph_radius[:n].abs(), BIG)
    r = torch.cat([r, r.new_full((n_pad - n,), BIG)])
    return r.reshape(-1, group).amin(dim=1, keepdim=True)


def _widen(lo, hi, r):
    """Boxes (lo, hi) [n, 3] widened by their pad: AAB_SLACK times their
    largest |coordinate| plus the ``sphere_pad`` of that coordinate and
    their spheres' smallest radius ``r`` [n, 1] (BIG for a box without
    spheres).  Inverted boxes stay inverted."""
    real = lo[:, :1] <= hi[:, :1]
    scale = torch.where(real, torch.maximum(lo.abs(), hi.abs()), 0.0
                        ).amax(dim=1, keepdim=True)
    m = scale * AAB_SLACK + sphere_pad(scale, r)
    return torch.where(real, lo - m, lo), torch.where(real, hi + m, hi)


def cull_boxes(data: SceneData, meta: SceneMeta) -> torch.Tensor:
    """The "cull" mode's table [n_sub, BOX_COLS]: ``cluster_boxes`` widened
    by their pad (``_widen``; lo xyz, hi xyz), the smallest radius of a
    surface sphere (BIG if none: the kernel's per-ray part of the pad),
    0."""
    box = cluster_boxes(data, meta)
    n_ss = _n_sph_sub(data, meta)
    r = torch.full((box.shape[0], 1), BIG, device=box.device)
    if n_ss:
        r[:n_ss] = _group_radius(data, data.sph_center.shape[0], n_ss * CL,
                                 CL)
    lo, hi = _widen(box[:, 0:3], box[:, 3:6], r)
    r_min = r.amin().expand(box.shape[0], 1)
    return torch.cat([lo, hi, r_min, torch.zeros_like(r_min)], dim=1
                     ).contiguous()


def bvh_tree(data: SceneData, meta: SceneMeta):
    """The "bvh" mode's tree: an implicit heap whose leaves are single rows
    (node 1 the root, children 2k and 2k+1, leaf s at node L + s), the
    sphere rows first (leaf s < n_spheres is sphere row s), then the quad
    rows, each kind in the scene builder's Morton row order.  A leaf's box
    is its row's box of ``cluster_boxes`` (a moving sphere's swept box, a
    quad's corners padded by QUAD_PAD) widened by its pad (``_widen``).

    Returns (nodes [L, NODE_COLS] f32, L).  Row k (1 <= k < L) holds the
    boxes of node k's two children, axis by axis: (lo, hi of child 2k, lo,
    hi of child 2k+1) along x, then y, then z, so that a visit reads both
    in three float4 loads.  Row 0 holds (the smallest radius of a surface
    sphere, BIG if none; 0, ...): the kernel's per-ray part of the pad.
    Skip and padding leaves, and nodes over only such leaves, carry
    inverted boxes and are never entered."""
    dev = data.sph_center.device
    ns, nq = meta.n_spheres, meta.n_quads
    s_lo, s_hi = _sphere_bounds(data)
    q_lo, q_hi = quad_bounds(data)
    lo, hi = _group_boxes(torch.cat([s_lo[:ns], q_lo[:nq]]),
                          torch.cat([s_hi[:ns], q_hi[:nq]]),
                          torch.cat([data.sph_surface[:ns],
                                     data.quad_surface[:nq]]), ns + nq, 1)
    r = torch.cat([_group_radius(data, ns, ns, 1),
                   torch.full((nq, 1), BIG, device=dev)])
    lo, hi = _widen(lo, hi, r)
    L = 2
    while L < ns + nq:
        L *= 2
    pad = torch.full((L - ns - nq, 3), BIG, dtype=lo.dtype, device=dev)
    levels = [(torch.cat([lo, pad]), torch.cat([hi, -pad]))]
    while levels[0][0].shape[0] > 2:
        lo, hi = levels[0]
        levels.insert(0, (torch.minimum(lo[0::2], lo[1::2]),
                          torch.maximum(hi[0::2], hi[1::2])))
    # heap rows 2 .. 2L-1 in order: row 2k + j is child j of node k
    lo = torch.cat([lv[0] for lv in levels]).reshape(L - 1, 2, 3)
    hi = torch.cat([lv[1] for lv in levels]).reshape(L - 1, 2, 3)
    nodes = torch.stack([lo[:, 0], hi[:, 0], lo[:, 1], hi[:, 1]],
                        dim=2).reshape(L - 1, NODE_COLS)
    row0 = torch.zeros((1, NODE_COLS), device=dev)
    row0[0, 0] = torch.cat([r[:ns, 0], r.new_full((1,), BIG)]).amin()
    return torch.cat([row0, nodes]).contiguous(), L


def pack_scene(data: SceneData, meta: SceneMeta, qf: QuadFrames,
               table: torch.Tensor, accel: str = "none",
               off_axis=None) -> PackedScene:
    """Per-primitive records for the closest-hit scan (host-side
    precompute of every ray-independent term), the joined table and the
    accel mode's boxes or tree.  ``off_axis``: "none"'s axis-aligned quad
    rows left to the general test (``aaq_off_axis``); None finds them here,
    by one host read.  With them given, the pack reads nothing on the host
    and copies no host data once the ``device.constant``s of its index
    tensors exist, so a CUDA graph can capture it."""
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
    quad = quad_records(data, qf)
    accel_tab, n_accel = None, 0
    aab_tab = aab_faces = gen_rows = aaq_tab = aaq_groups = None
    # traversal decisions are not differentiable (the JAX package's
    # stop_gradient on its boxes and tree); the backward recomputes a
    # winning axis-aligned quad's t from its record in ``quad``
    with torch.no_grad():
        if accel == "none":
            if off_axis is None:
                off_axis = aaq_off_axis(meta, quad)
            aab_tab, aab_faces, gen_rows = box_tables(data, meta, off_axis)
            aaq_tab, aaq_groups = aaq_tables(meta, quad, off_axis)
        elif accel == "cull":
            accel_tab = cull_boxes(data, meta)
            n_accel = accel_tab.shape[0]
        else:
            accel_tab, n_accel = bvh_tree(data, meta)
    return PackedScene(sph=sph, n_sph=int(meta.n_spheres), quad=quad,
                       n_quad=int(meta.n_quads),
                       joined=table.contiguous(),
                       quad_base=int(data.sph_center.shape[0]),
                       accel=accel, accel_tab=accel_tab,
                       n_sph_sub=_n_sph_sub(data, meta) if accel == "cull"
                       else 0, n_accel=n_accel,
                       aab_tab=aab_tab, aab_faces=aab_faces,
                       gen_rows=gen_rows, aaq_tab=aaq_tab,
                       aaq_groups=aaq_groups)


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


def cull_slices(R, n_sub):
    """The ray ranges [a, b) of the "cull" launches of R rays against n_sub
    sub-clusters: each launch's bins hold at most CULL_MAX_PAIRS slots.
    From R and n_sub alone, so a call needs no host sync."""
    step = max(1, CULL_MAX_PAIRS // max(1, n_sub))
    return [(a, min(a + step, R)) for a in range(0, R, step)]


def _cull_scratch(lib, R, n_sub, dev):
    """The int32 and int64 scratch of a "cull" launch, sized by the
    library's own layout (mort_closest_hit_cull_scratch)."""
    n_int, n_key = ctypes.c_longlong(), ctypes.c_longlong()
    lib.mort_closest_hit_cull_scratch(R, n_sub, ctypes.byref(n_int),
                                      ctypes.byref(n_key))
    return (torch.empty(n_int.value, dtype=torch.int32, device=dev),
            torch.empty(n_key.value, dtype=torch.int64, device=dev))


def _launch(packed: PackedScene, rays: torch.Tensor, t_min: float,
            n_tests: torch.Tensor | None = None):
    """Launch the forward kernel of ``packed.accel``; returns the [32, R]
    output.  ``n_tests``: an optional int64 [N_TESTS] card tensor to which
    the launch adds the sphere tests, general quad tests, box or node slab
    tests and specialised axis-aligned quad tests it performs (rows whose
    surface flag is 0 are not tests) and, in "cull", the pairs (ray,
    entered sub-cluster) of its bins; the results do not depend on it."""
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
        # "cull": n_acc sub-clusters of CL rows, the first n_ss of spheres;
        # "bvh": L a power of two up to 2^30 (the kernel's 32-bit trail),
        # at least one leaf a row; both 16-byte aligned rows
        if ((accel == "bvh" and (n_acc < 2 or n_acc > 2 ** 30
                                 or n_acc & (n_acc - 1)
                                 or n_acc < packed.n_sph + packed.n_quad))
                or (accel == "cull" and (n_ss * CL < packed.n_sph
                                         or (n_acc - n_ss) * CL
                                         < packed.n_quad))
                or tab.shape[0] != n_acc or tab.data_ptr() % 16):
            raise ValueError("closest_hit: inconsistent accel table")
        accel_ptr = tab.data_ptr()
    n_box = n_gen = n_aaq = n_grp = 0
    box_ptrs, aaq_ptrs = (0, 0, 0), (0, 0)
    if accel == "none":
        tab, faces, gen = packed.aab_tab, packed.aab_faces, packed.gen_rows
        _check("aab_tab", tab, torch.float32, dev, 2, BOX_COLS)
        _check("aab_faces", faces, torch.int32, dev, 2, 6)
        _check("gen_rows", gen, torch.int32, dev, 1)
        aaq, grp = packed.aaq_tab, packed.aaq_groups
        _check("aaq_tab", aaq, torch.float32, dev, 2, AAQ_COLS)
        _check("aaq_groups", grp, torch.int32, dev, 2, AAQ_GROUP_COLS)
        n_box, n_gen = tab.shape[0], gen.shape[0]
        n_aaq, n_grp = aaq.shape[0], grp.shape[0]
        if (faces.shape[0] != n_box
                or n_gen + 6 * n_box + n_aaq > packed.n_quad
                or tab.data_ptr() % 16 or aaq.data_ptr() % 16):
            raise ValueError("closest_hit: inconsistent box table")
        box_ptrs = (tab.data_ptr(), faces.data_ptr(), gen.data_ptr())
        aaq_ptrs = (aaq.data_ptr(), grp.data_ptr())
    count_ptr = 0
    if n_tests is not None:
        _check("n_tests", n_tests, torch.int64, dev, 1)
        if n_tests.shape[0] != N_TESTS:
            raise ValueError(f"closest_hit: n_tests must be int64 "
                             f"[{N_TESTS}]")
        count_ptr = n_tests.data_ptr()
    R = rays.shape[1]
    if R >= 2 ** 31 // ROW_K:
        raise ValueError(f"closest_hit: {R} rays exceed the int32 range")
    out = torch.empty((ROW_K, R), dtype=torch.float32, device=dev)
    tables = (packed.sph.data_ptr(), packed.n_sph, packed.quad.data_ptr(),
              packed.n_quad, packed.joined.data_ptr(), k_join,
              packed.quad_base, ctypes.c_float(t_min))
    lib = load_library("closest_hit")

    def check(rc):
        if rc != 0:
            raise RuntimeError(
                f"closest_hit kernel launch failed ({accel}): CUDA error "
                f"{rc} ({lib.mort_cuda_error_string(rc).decode()})")
        launch_count[accel] += 1

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if accel != "cull":
            check(lib.mort_closest_hit(
                rays.data_ptr(), R, *tables, _MODE[accel], accel_ptr,
                packed.n_accel, *box_ptrs, n_box, n_gen, *aaq_ptrs, n_aaq,
                n_grp, out.data_ptr(), count_ptr, stream))
            return out
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        slices = cull_slices(R, packed.n_accel)
        # the first slice is the largest: its scratch serves every launch
        # (one stream, so they run one after another)
        scratch_i, scratch_k = _cull_scratch(
            lib, slices[0][1] - slices[0][0], packed.n_accel, dev)
        for a, b in slices:
            whole = len(slices) == 1
            part = rays if whole else rays[:, a:b].contiguous()
            rows = out if whole else torch.empty(
                (ROW_K, b - a), dtype=torch.float32, device=dev)
            check(lib.mort_closest_hit_cull(
                part.data_ptr(), b - a, *tables, accel_ptr, packed.n_sph_sub,
                packed.n_accel, n_sm, rows.data_ptr(), count_ptr,
                scratch_i.data_ptr(), scratch_i.numel(),
                scratch_k.data_ptr(), scratch_k.numel(), stream))
            if not whole:
                out[:, a:b] = rows
    return out


def _bwd_lane_terms(rays, kind, idx, dt, drow, sph, quad, t_min):
    """The per-lane half of the backward (the kernel's ``lane_terms``):
    d_rays [8, R], and the record partials of the sphere hit lanes (lanes
    [n_s], rows [n_s], terms [n_s, REC_TERMS]) and of the quad hit lanes
    (lanes [n_q], rows [n_q], terms [n_q, 4]), each lane's the kernel's
    rounded ops in its order."""
    hit = kind != K_NONE
    dte = torch.where(hit, dt + drow[ROW_T], 0.0)
    d_rays = torch.zeros_like(rays)

    s = (kind == K_SPHERE).nonzero().squeeze(1)
    js = idx[s].long()
    cx, cy, cz, vx, vy, vz, ctc_r2, ccv2, vv, _ = sph[js].unbind(1)
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
    ts = torch.stack([dcx, dcy, dcz, tm * dcx, tm * dcy, tm * dcz,
                      g_ct, g_ct * tm, g_ct * tm * tm], dim=1)
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
    jq = idx[q].long()
    nx, ny, nz, D = quad[jq, :4].unbind(1)
    ox, oy, oz, dx, dy, dz = (rays[k][q] for k in range(6))
    den = _dot3(nx, ny, nz, dx, dy, dz)
    den_g = torch.where(torch.abs(den) >= 1e-8, den, 1.0)
    t = (D - _dot3(nx, ny, nz, ox, oy, oz)) / den_g
    G = dte[q] / den_g
    tq = torch.stack([-G * (ox + t * dx), -G * (oy + t * dy),
                      -G * (oz + t * dz), G], dim=1)
    d_rays[:6, q] = torch.stack([-G * nx, -G * ny, -G * nz,
                                 -G * t * nx, -G * t * ny, -G * t * nz])
    return d_rays, (s, js, ts), (q, jq, tq)


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
    kernel's) is held."""
    mag = torch.abs if absolute else (lambda x: x)
    dev = rays.device
    d_rays, (s, js, ts), (q, jq, tq) = _bwd_lane_terms(
        rays, kind, idx, dt, drow, sph, quad, t_min)
    d_sph = torch.zeros_like(sph)
    d_quad = torch.zeros_like(quad)
    d_joined = torch.zeros(joined_shape, dtype=torch.float32, device=dev)
    k_join = joined_shape[1]
    lanes = (kind != K_NONE).nonzero().squeeze(1)
    g = torch.where(kind == K_QUAD, idx + quad_base, idx).long()
    d_joined.index_add_(0, g[lanes], mag(drow[:k_join, lanes].T))
    if s.numel():
        d_sph.index_add_(0, js, mag(torch.cat(
            [ts, ts.new_zeros((ts.shape[0], SPH_COLS - REC_TERMS))], 1)))
    if q.numel():
        d_quad.index_add_(0, jq, mag(torch.cat(
            [tq, tq.new_zeros((tq.shape[0], QUAD_COLS - 4))], 1)))
    return d_rays, d_sph, d_quad, d_joined


def pairwise_segments(seg, vals):
    """The pairwise-tree sum of the rows of ``vals`` [n, C] over each run of
    equal ``seg`` [n] (a run's rows contiguous, in their order): at each
    level adjacent pairs add, left + right, and the last row of an odd
    count is carried up unchanged.  Returns (seg of each run [m], its sums
    [m, C]), the runs in their order; float32 adds, one rounding each."""
    n = seg.shape[0]
    if n == 0:
        return seg, vals
    dev = seg.device
    start = torch.ones(n, dtype=torch.bool, device=dev)
    start[1:] = seg[1:] != seg[:-1]
    first = start.nonzero().squeeze(1)
    run = torch.cumsum(start.long(), 0) - 1
    rank = torch.arange(n, device=dev) - first[run]
    length = torch.diff(first, append=first.new_tensor([n]))[run]
    vals = vals.clone()
    step = 1
    while step < int(length.max()):
        at = (((rank % (2 * step)) == 0) & (rank + step < length)
              ).nonzero().squeeze(1)
        vals[at] = vals[at] + vals[at + step]
        step *= 2
    return seg[first], vals[first]


def ordered_sums(lanes, key, vals, n_keys):
    """The backward kernels' order of adds: ``vals`` [n, C] of the hit
    ``lanes`` [n] (ascending) summed per ``key`` [n] < ``n_keys`` by a
    pairwise tree over the lanes of a warp that share the key, in lane
    order, then over the warps of a tile that hold it, in warp order, then
    over the tiles, in tile order (``BWD_LEVELS``).  Returns (keys [m]
    ascending, sums [m, C])."""
    unit = lanes.long()
    key = key.long()
    for per in BWD_LEVELS:
        group = unit // per if per else torch.zeros_like(unit)
        comp = group * n_keys + key
        order = torch.sort(comp, stable=True).indices
        comp, vals = pairwise_segments(comp[order], vals[order])
        unit, key = comp // n_keys, comp % n_keys
    return key, vals


def closest_hit_bwd_ordered(rays, kind, idx, dt, drow, sph, quad,
                            joined_shape, quad_base, t_min=T_MIN):
    """The plain mirror of the backward kernel's order: the per-lane terms
    of ``closest_hit_bwd_reference`` (the same arguments and outputs),
    summed into d_sph, d_quad and d_joined in the kernel's tree
    (``ordered_sums``), so that on the card the kernel's tables equal its
    bit for bit.  For the tests and chip_smoke.py; the CPU route of the
    backward is ``closest_hit_bwd_reference``."""
    d_rays, (s, js, ts), (q, jq, tq) = _bwd_lane_terms(
        rays, kind, idx, dt, drow, sph, quad, t_min)
    R = rays.shape[1]
    n_join, k_join = joined_shape
    terms = rays.new_zeros((R, REC_TERMS))
    terms[s] = ts
    terms[q, :4] = tq
    lanes = ((kind == K_SPHERE) | (kind == K_QUAD)).nonzero().squeeze(1)
    key = torch.where(kind == K_QUAD, idx + quad_base, idx)[lanes]
    vals = torch.cat([terms[lanes], drow[:k_join, lanes].T], dim=1)
    key, sums = ordered_sums(lanes, key, vals, n_join)
    d_sph = torch.zeros_like(sph)
    d_quad = torch.zeros_like(quad)
    d_joined = rays.new_zeros(joined_shape)
    d_joined[key] = sums[:, REC_TERMS:]
    on_s = key < quad_base
    d_sph[key[on_s], :REC_TERMS] = sums[on_s, :REC_TERMS]
    d_quad[key[~on_s] - quad_base, :4] = sums[~on_s, :4]
    return d_rays, d_sph, d_quad, d_joined


def bwd_scratch_sizes(R, n_join, k_join):
    """(int32 count, float32 count) of the backward kernels' scratch (the
    .cu's BwdScratch): a run key and a slot of the key order per tile slot,
    a run count per tile, a count, an offset and a chunk offset per key (the
    offsets one more), a first slot and a key per level-2 chunk of 32 runs
    (at most 8 a tile plus one a key), a prefix and a presence word per key
    and 32-tile word; the REC_TERMS + k_join sums of each tile slot and
    each chunk."""
    n_tiles = -(-R // BWD_TILE)
    words = n_join * -(-n_tiles // 32)
    slots = n_tiles * BWD_TILE
    chunks = n_tiles * (BWD_TILE // WARP) + n_join
    return (2 * slots + n_tiles + 3 * n_join + 2 + 2 * chunks + 2 * words,
            (slots + chunks) * (REC_TERMS + k_join))


def _launch_bwd(rays, kind, idx, dt, drow, sph, quad, joined_shape,
                quad_base, t_min):
    """Launch the backward kernels (plain version
    ``closest_hit_bwd_reference``, plain mirror of their order
    ``closest_hit_bwd_ordered``); the outputs and the scratch
    (``bwd_scratch_sizes``) are allocated here, and the kernels write every
    entry of the outputs."""
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
    # a sphere's key is its row, a quad's quad_base + its row: the two
    # ranges must not meet
    if (k_join > ROW_T or n_join < 1 or sph.shape[0] > quad_base
            or quad_base + quad.shape[0] > n_join):
        raise ValueError("closest_hit_bwd: inconsistent table shapes")
    d_rays = torch.empty_like(rays)
    d_sph = torch.empty_like(sph)
    d_quad = torch.empty_like(quad)
    d_joined = torch.empty(joined_shape, dtype=torch.float32, device=dev)
    n_int, n_float = bwd_scratch_sizes(R, n_join, k_join)
    scratch_i = torch.empty(n_int, dtype=torch.int32, device=dev)
    scratch_f = torch.empty(n_float, dtype=torch.float32, device=dev)
    lib = load_library("closest_hit")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mort_closest_hit_bwd(
            rays.data_ptr(), R, kind.data_ptr(), idx.data_ptr(),
            dt.data_ptr(), drow.data_ptr(), sph.data_ptr(), sph.shape[0],
            quad.data_ptr(), quad.shape[0], n_join, k_join, quad_base,
            ctypes.c_float(t_min), d_rays.data_ptr(), d_sph.data_ptr(),
            d_quad.data_ptr(), d_joined.data_ptr(), scratch_i.data_ptr(),
            n_int, scratch_f.data_ptr(), n_float, stream)
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
