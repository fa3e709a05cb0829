"""Tag constants and handle types for the scene registry.

The same values as ``mort_tpu.scene.types`` (which cannot be imported here:
that package imports jax).  The reference renderer emulates device-side
polymorphism with (type, idx) tagged registries and switch dispatchers
(reference: objects.cuh:13-19, materials.cuh:14-18, textures.cuh:10-13);
the port keeps flat struct-of-array tables whose *kind* tags are static
Python metadata, so dispatch is a masked select, never a per-ray branch.
"""

from __future__ import annotations

from dataclasses import dataclass

# Material kinds (parity with materials.cuh:14-18).
MAT_LAMBERTIAN = 1
MAT_METAL = 2
MAT_DIELECTRIC = 3
MAT_DIFFUSE_LIGHT = 4
MAT_ISOTROPIC = 5

# Texture kinds (parity with textures.cuh:10-13).
TEX_SOLID = 1
TEX_CHECKER = 2
TEX_IMAGE = 3
TEX_NOISE = 4

# Object kinds (parity with objects.cuh:13-19).
OBJ_SPHERE = 1
OBJ_QUAD = 2
OBJ_TRANSLATE = 3
OBJ_ROTATE_Y = 4
OBJ_CONSTANT_MEDIUM = 5
OBJ_HITTABLE_LIST = 6
OBJ_BVH = 7


@dataclass(frozen=True)
class TexH:
    """Handle to a row of the global texture table."""
    kind: int
    row: int


@dataclass(frozen=True)
class MatH:
    """Handle to a row of the global material table."""
    kind: int
    row: int


@dataclass(frozen=True)
class ObjH:
    """Handle to an object in a per-kind host registry."""
    kind: int
    idx: int
