"""Host-side BVH construction.

The port of ``mort_tpu.scene.bvh`` (numpy, the same code).  Reproduces the
reference's build topology (objects.cuh:529-611): iterative worklist
build, per-node AABB union over its span, split axis = largest extent
(aabb.cuh:61-67), stable sort of the span by AABB min along that axis (the
reference's bubble sort, objects.cuh:631-661, is stable), midpoint split at
``start + ceil(span/2)``, leaves hold 1-2 primitives.  Unlike the
reference, which swaps objects in the registries during the sort, the
build sorts an index permutation and keeps primitive rows stable.

ROLE (DEVIATIONS.md section 3): a **reference-topology parity fixture**,
not part of the render path.  The card's "bvh" closest-hit mode builds its
own tree (``render.closest_hit.bvh_tree``); scene compilation consumes only
the *leaf sets* of registered BVHs, never this tree.  The builder keeps the
reference's build semantics executable and cross-checked: numpy against
the C++ builder (``mort_tpu_torch.native``), both bit-equal to the JAX
package's numpy builder (tests/test_torch_bvh_builder.py).
"""

from __future__ import annotations

import numpy as np
import torch

from .types import OBJ_QUAD, OBJ_SPHERE

MAX_BVH_NODES = 4096  # reference caps at 1024 (objects.cuh:521); we allow more


def leaf_aabbs(leaves, centers, radii, cvecs, quad_Q, quad_u, quad_v):
    """[L,3] min / [L,3] max world AABBs for a list of (kind, row) leaves.

    Sphere boxes include both motion endpoints (objects.cuh:46-55); quad
    boxes are the union of the two diagonal boxes (objects.cuh:181-184).
    """
    mins = np.empty((len(leaves), 3), np.float32)
    maxs = np.empty((len(leaves), 3), np.float32)
    for i, (kind, row) in enumerate(leaves):
        if kind == OBJ_SPHERE:
            c0 = centers[row]
            c1 = centers[row] + cvecs[row]
            r = abs(radii[row])
            mins[i] = np.minimum(c0, c1) - r
            maxs[i] = np.maximum(c0, c1) + r
        elif kind == OBJ_QUAD:
            corners = np.stack([
                quad_Q[row],
                quad_Q[row] + quad_u[row],
                quad_Q[row] + quad_v[row],
                quad_Q[row] + quad_u[row] + quad_v[row],
            ])
            mins[i] = corners.min(0)
            maxs[i] = corners.max(0)
        else:
            raise ValueError(
                f"BVH leaves must be spheres/quads, got kind {kind}")
    return mins, maxs


def build_bvh_numpy(leaves, centers, radii, cvecs, quad_Q, quad_u, quad_v):
    """Build flat BVH arrays (numpy) over (kind, row) leaf primitives:
    (node_min, node_max, left, right, left_kind, right_kind, is_leaf)."""
    n = len(leaves)
    if n < 1:
        raise ValueError("a BVH needs at least one leaf")
    lmins, lmaxs = leaf_aabbs(leaves, centers, radii, cvecs, quad_Q, quad_u,
                              quad_v)
    perm = np.arange(n)

    node_min, node_max = [], []
    left, right, lkind, rkind, is_leaf = [], [], [], [], []
    spans = [(0, n)]  # worklist indexed by node id

    node_id = 0
    while node_id < len(spans):
        start, end = spans[node_id]
        seg = perm[start:end]
        bb_min = lmins[seg].min(0)
        bb_max = lmaxs[seg].max(0)
        node_min.append(bb_min)
        node_max.append(bb_max)
        ext = bb_max - bb_min
        # largest_axis with the reference's tie-breaking (aabb.cuh:61-67).
        axis = ((0 if ext[0] > ext[2] else 2) if ext[0] > ext[1]
                else (1 if ext[1] > ext[2] else 2))
        span = end - start

        if span == 1:
            k, r = leaves[seg[0]]
            left.append(r)
            right.append(r)
            lkind.append(k)
            rkind.append(k)
            is_leaf.append(True)
        elif span == 2:
            a, b = seg[0], seg[1]
            # compare_by_axis orders by AABB min (objects.cuh:982-1000).
            if lmins[a][axis] > lmins[b][axis]:
                a, b = b, a
            ka, ra = leaves[a]
            kb, rb = leaves[b]
            left.append(ra)
            right.append(rb)
            lkind.append(ka)
            rkind.append(kb)
            is_leaf.append(True)
        else:
            order = np.argsort(lmins[seg][:, axis], kind="stable")
            perm[start:end] = seg[order]
            mid = start + span // 2 + (span % 2)
            left.append(len(spans))
            lkind.append(0)
            spans.append((start, mid))
            right.append(len(spans))
            rkind.append(0)
            spans.append((mid, end))
            is_leaf.append(False)
        node_id += 1

    return (
        np.stack(node_min).astype(np.float32),
        np.stack(node_max).astype(np.float32),
        np.array(left, np.int32),
        np.array(right, np.int32),
        np.array(lkind, np.int32),
        np.array(rkind, np.int32),
        np.array(is_leaf, np.bool_),
    )


def build_bvh_via_native(leaves, centers, radii, cvecs, quad_Q, quad_u,
                         quad_v):
    """C++ builder (``mort_tpu_torch.native``); returns the same 7-tuple as
    ``build_bvh_numpy``, or None when the library is unavailable
    (``native.build_error()`` says why)."""
    from .. import native

    lmins, lmaxs = leaf_aabbs(leaves, centers, radii, cvecs, quad_Q, quad_u,
                              quad_v)
    out = native.build_bvh_native(lmins, lmaxs)
    if out is None:
        return None
    nmin, nmax, left, right, is_leaf = out
    # native leaves reference input slots; map to (kind, row) payloads
    kinds = np.array([k for k, _ in leaves], np.int32)
    rows = np.array([r for _, r in leaves], np.int32)
    lslot = np.clip(left, 0, len(leaves) - 1)
    rslot = np.clip(right, 0, len(leaves) - 1)
    lk = np.where(is_leaf, kinds[lslot], 0).astype(np.int32)
    rk = np.where(is_leaf, kinds[rslot], 0).astype(np.int32)
    l = np.where(is_leaf, rows[lslot], left).astype(np.int32)
    r = np.where(is_leaf, rows[rslot], right).astype(np.int32)
    return nmin, nmax, l, r, lk, rk, is_leaf


def build_bvh(leaves, centers, radii, cvecs, quad_Q, quad_u, quad_v):
    """Build and wrap as a ``BVHArrays`` of CPU tensors (the native C++
    builder when it is available, else the numpy builder)."""
    from .build import BVHArrays  # local import to avoid cycle

    arrs = build_bvh_via_native(leaves, centers, radii, cvecs, quad_Q,
                                quad_u, quad_v)
    if arrs is None:
        arrs = build_bvh_numpy(leaves, centers, radii, cvecs, quad_Q, quad_u,
                               quad_v)
    return BVHArrays(*(torch.from_numpy(np.ascontiguousarray(a))
                       for a in arrs))
