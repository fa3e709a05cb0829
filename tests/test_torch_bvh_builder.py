"""Port parity: the host BVH builder (``mort_tpu_torch.scene.bvh``) and
its C++ builder (``mort_tpu_torch.native``), the counterparts of
tests/test_native.py and of test_components.py::test_bvh_build_topology.
The port's numpy builder is bit-equal to the JAX package's on all seven
arrays, the port's native builder to the port's numpy builder, and the
library builds (g++ at first use, into build/mort_tpu_torch/)."""

import numpy as np
import pytest
import torch

from mort_tpu_torch import native
from mort_tpu_torch.scene.build import BVHArrays
from mort_tpu_torch.scene.bvh import (
    build_bvh, build_bvh_numpy, build_bvh_via_native, leaf_aabbs,
)
from mort_tpu_torch.scene.types import OBJ_QUAD, OBJ_SPHERE

SIZES = [1, 2, 3, 7, 64, 499]
NAMES = ["nmin", "nmax", "left", "right", "lkind", "rkind", "leaf"]


def _random_leaves(n, seed=0):
    """tests/test_native.py's leaves: n spheres and max(1, n // 3) quads."""
    rng = np.random.RandomState(seed)
    centers = (rng.randn(n, 3) * 10).astype(np.float32)
    radii = rng.uniform(0.1, 2.0, n).astype(np.float32)
    cvecs = np.zeros((n, 3), np.float32)
    nq = max(1, n // 3)
    qq = (rng.randn(nq, 3) * 5).astype(np.float32)
    qu = rng.randn(nq, 3).astype(np.float32)
    qv = rng.randn(nq, 3).astype(np.float32)
    leaves = ([(OBJ_SPHERE, i) for i in range(n)]
              + [(OBJ_QUAD, i) for i in range(nq)])
    return leaves, centers, radii, cvecs, qq, qu, qv


def _assert_bit_equal(got, want):
    assert len(got) == len(want) == len(NAMES)
    for g, w, name in zip(got, want, NAMES):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_native_library_builds():
    assert native.have_native(), native.build_error()
    assert native.build_error() is None


@pytest.mark.parametrize("n", SIZES)
def test_numpy_builder_equals_jax(n):
    from mort_tpu.scene.bvh import build_bvh_numpy as j_build_bvh_numpy

    args = _random_leaves(n, seed=n)
    _assert_bit_equal(build_bvh_numpy(*args), j_build_bvh_numpy(*args))


@pytest.mark.parametrize("n", SIZES)
def test_native_builder_equals_numpy(n):
    args = _random_leaves(n, seed=n)
    got = build_bvh_via_native(*args)
    assert got is not None, native.build_error()
    _assert_bit_equal(got, build_bvh_numpy(*args))


@pytest.mark.parametrize("n", [37, 499])
def test_bvh_build_topology(n):
    """The root box holds every leaf, each child box lies inside its
    parent's, and every primitive is reached exactly once."""
    rng = np.random.RandomState(0)
    centers = rng.randn(n, 3).astype(np.float32) * 10
    radii = np.full(n, 0.5, np.float32)
    cvecs = np.zeros((n, 3), np.float32)
    qq = qu = qv = np.zeros((1, 3), np.float32)
    leaves = [(OBJ_SPHERE, i) for i in range(n)]
    bvh = build_bvh(leaves, centers, radii, cvecs, qq, qu, qv)
    assert isinstance(bvh, BVHArrays)
    assert bvh.node_min.dtype == torch.float32
    assert bvh.is_leaf.dtype == torch.bool
    nmin, nmax, left, right, _lk, _rk, is_leaf = (
        t.numpy() for t in (bvh.node_min, bvh.node_max, bvh.left, bvh.right,
                            bvh.left_kind, bvh.right_kind, bvh.is_leaf))
    lmin, lmax = leaf_aabbs(leaves, centers, radii, cvecs, qq, qu, qv)
    assert (nmin[0] <= lmin.min(0)).all() and (nmax[0] >= lmax.max(0)).all()
    n_nodes = len(left)
    reached = []
    for i in range(n_nodes):
        if is_leaf[i]:
            reached += sorted({int(left[i]), int(right[i])})
        else:
            assert 0 < left[i] < n_nodes and 0 < right[i] < n_nodes
            for c in (left[i], right[i]):
                assert (nmin[c] >= nmin[i]).all()
                assert (nmax[c] <= nmax[i]).all()
    assert sorted(reached) == list(range(n))
