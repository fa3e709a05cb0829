"""Pre-joined per-primitive shading table.

The port of ``mort_tpu.render.primtable``.  The reference dereferences
registries at every bounce: hit -> material -> texture -> color, through
switch dispatchers (objects.cuh:858-887, materials.cuh:272-349,
textures.cuh:327-349).  Joining them once per render into one flat
[n_prims, K] table makes the hit -> shading-attribute chain a single row
load per ray — the closest-hit kernel's epilogue does exactly that load.

Checker textures with solid-color children are folded into two color
columns + an inverse scale (inv_scale = 0 makes every point "even").
Image/noise textures set a fallback flag column.

Column layout (K = 27):
  0:3   A        base color (lambertian/isotropic solid or checker-even,
                 metal albedo, dielectric white)
  3:6   B        checker-odd color (== A for non-checker)
  6     INVSC    checker inverse scale (0 = no checker)
  7     FUZZ     metal fuzz
  8     IOR      dielectric index
  9     KIND     material kind tag (float)
  10    TID      texture row (for fallback eval)
  11    FALLBACK 1.0 when texture needs full texture_value eval
  12:15 E        emission color (diffuse_light, solid only)
  15    (pad)
  16:19 G0       sphere center        | quad unit normal
  19:22 G1       sphere center_vec    | quad v x w
  22:25 G2       0                    | quad w x u
  25    S0       sphere radius        | quad Q.(v x w)
  26    S1       0                    | quad Q.(w x u)
"""

from __future__ import annotations

import torch

from ..device import constant
from ..scene.build import SceneData, SceneMeta
from ..scene.types import (
    MAT_DIELECTRIC, MAT_DIFFUSE_LIGHT, MAT_METAL, TEX_CHECKER, TEX_SOLID,
)
from .intersect import QuadFrames

K = 27
COL_A = 0
COL_B = 3
COL_INVSC = 6
COL_FUZZ = 7
COL_IOR = 8
COL_KIND = 9
COL_TID = 10
COL_FALLBACK = 11
COL_E = 12
COL_G0 = 16
COL_G1 = 19
COL_G2 = 22
COL_S0 = 25
COL_S1 = 26


def material_columns(data: SceneData, meta: SceneMeta) -> torch.Tensor:
    """[M, 16] material/texture columns of the join."""
    dev = data.mat_tex.device
    M = len(meta.mat_kind)
    kind = constant(tuple(meta.mat_kind), torch.int32, dev)
    tex_kind = constant(tuple(meta.tex_kind), torch.int32, dev)

    tid = data.mat_tex[:M].long()
    even = data.tex_child_even[tid].long()
    odd = data.tex_child_odd[tid].long()
    tkind = tex_kind[tid]
    solid = data.tex_color[tid]
    child_kinds_solid = ((tex_kind[even] == TEX_SOLID)
                         & (tex_kind[odd] == TEX_SOLID))

    is_checker = (tkind == TEX_CHECKER) & child_kinds_solid
    fallback = ((tkind != TEX_SOLID) & ~is_checker).to(torch.float32)
    # metal/dielectric ignore textures entirely
    uses_tex = (kind != MAT_METAL) & (kind != MAT_DIELECTRIC)
    fallback = torch.where(uses_tex, fallback, 0.0)

    A = torch.where(is_checker[:, None], data.tex_color[even], solid)
    A = torch.where((kind == MAT_METAL)[:, None], data.mat_albedo[:M], A)
    A = torch.where((kind == MAT_DIELECTRIC)[:, None], 1.0, A)
    B = torch.where(is_checker[:, None], data.tex_color[odd], A)
    invsc = torch.where(is_checker & uses_tex, data.tex_inv_scale[tid], 0.0)
    E = torch.where((kind == MAT_DIFFUSE_LIGHT)[:, None], solid, 0.0)

    cols = torch.zeros((M, 16), dtype=torch.float32, device=dev)
    cols[:, COL_A:COL_A + 3] = A
    cols[:, COL_B:COL_B + 3] = B
    cols[:, COL_INVSC] = invsc
    cols[:, COL_FUZZ] = data.mat_fuzz[:M]
    cols[:, COL_IOR] = data.mat_ior[:M]
    cols[:, COL_KIND] = kind.to(torch.float32)
    cols[:, COL_TID] = tid.to(torch.float32)
    cols[:, COL_FALLBACK] = fallback
    cols[:, COL_E:COL_E + 3] = E
    return cols


def build_prim_table(data: SceneData, meta: SceneMeta, qf: QuadFrames):
    """Join materials+textures+geometry into one [Ns_rows+Nq_rows, K] table.

    Global prim index g = sphere_row, or Ns_rows + quad_row.
    Returns (table, mat_cols) — mat_cols is reused for media overrides.
    """
    mat_cols = material_columns(data, meta)
    Ns = data.sph_center.shape[0]
    Nq = data.quad_Q.shape[0]
    dev = mat_cols.device

    sph = torch.zeros((Ns, K), dtype=torch.float32, device=dev)
    sph[:, :16] = mat_cols[data.sph_mat.long()]
    sph[:, COL_G0:COL_G0 + 3] = data.sph_center
    sph[:, COL_G1:COL_G1 + 3] = data.sph_cvec
    sph[:, COL_S0] = data.sph_radius

    qd = torch.zeros((Nq, K), dtype=torch.float32, device=dev)
    qd[:, :16] = mat_cols[data.quad_mat.long()]
    qd[:, COL_G0:COL_G0 + 3] = qf.normal
    qd[:, COL_G1:COL_G1 + 3] = qf.vxw
    qd[:, COL_G2:COL_G2 + 3] = qf.wxu
    qd[:, COL_S0] = qf.qa
    qd[:, COL_S1] = qf.qb

    return torch.cat([sph, qd], dim=0), mat_cols
