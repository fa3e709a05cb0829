"""Native (C++) host helpers, bound with ctypes.

The port's copy of ``mort_tpu.native``: ``bvh_builder.cpp`` beside this
file compiles at first use with

    g++ -O3 -fPIC -std=c++17 -Wall -shared -o lib<stem>_<key>.so bvh_builder.cpp

into ``build/mort_tpu_torch/`` (``_build.compile_library``: keyed on the
source and the flags, written to a temporary file and renamed into place),
never into the package tree.  As in the reference, ``build_bvh_native``
returns None when the library cannot be built or loaded, and
``scene.bvh.build_bvh`` then takes the numpy builder; ``build_error()``
keeps the reason.
"""

from __future__ import annotations

import ctypes
import os
import shutil
from pathlib import Path

import numpy as np

from .. import _build

SOURCE = Path(__file__).resolve().parent / "bvh_builder.cpp"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")

_fp = ctypes.POINTER(ctypes.c_float)
_ip = ctypes.POINTER(ctypes.c_int32)
_up = ctypes.POINTER(ctypes.c_uint8)
_loaded: dict = {}


def _load():
    """The built library, or None (and the reason in ``build_error``)."""
    if "lib" not in _loaded:
        try:
            cxx = os.environ.get("CXX") or shutil.which("g++")
            if cxx is None:
                raise RuntimeError("no C++ compiler: set CXX or put g++ on "
                                   "PATH")
            lib = ctypes.CDLL(str(_build.compile_library(
                "mort_native", SOURCE, cxx, CXX_FLAGS)))
            lib.mort_build_bvh.restype = ctypes.c_int
            lib.mort_build_bvh.argtypes = [
                _fp, _fp, ctypes.c_int, ctypes.c_int, _fp, _fp, _ip, _ip,
                _up]
            _loaded.update(lib=lib, error=None)
        except (RuntimeError, OSError) as e:
            _loaded.update(lib=None, error=f"{type(e).__name__}: {e}")
    return _loaded["lib"]


def have_native() -> bool:
    return _load() is not None


def build_error() -> str | None:
    """Why the native library is unavailable (the compiler's output or the
    loader's error), or None when it loaded."""
    _load()
    return _loaded["error"]


def build_bvh_native(leaf_min: np.ndarray, leaf_max: np.ndarray):
    """Run the C++ BVH builder; returns (node_min, node_max, left, right,
    is_leaf) or None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = leaf_min.shape[0]
    cap = max(2 * n, 1)
    lmin = np.ascontiguousarray(leaf_min, np.float32)
    lmax = np.ascontiguousarray(leaf_max, np.float32)
    if lmin.shape != (n, 3) or lmax.shape != (n, 3):
        raise ValueError(f"leaf boxes must be [n, 3], got {lmin.shape} and "
                         f"{lmax.shape}")
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    left = np.empty(cap, np.int32)
    right = np.empty(cap, np.int32)
    is_leaf = np.empty(cap, np.uint8)
    count = lib.mort_build_bvh(
        lmin.ctypes.data_as(_fp), lmax.ctypes.data_as(_fp), n, cap,
        node_min.ctypes.data_as(_fp), node_max.ctypes.data_as(_fp),
        left.ctypes.data_as(_ip), right.ctypes.data_as(_ip),
        is_leaf.ctypes.data_as(_up))
    if count < 0:
        return None
    return (node_min[:count], node_max[:count], left[:count], right[:count],
            is_leaf[:count].astype(bool))
