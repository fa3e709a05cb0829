"""Fused hit-finalize + shading over the joined primitive table.

The port of ``mort_tpu.render.hitshade.finalize_and_shade``: one row of
the joined table per ray (the closest-hit kernel emits it ray-minor as
``row_t [32, R]``) followed by pure elementwise work, with the semantics of
the reference dispatch chain (emitDispatch / scatterDispatch /
scatterPdfDispatch, camera.cuh:96-159, materials.cuh:272-349).

All vector state is structure-of-arrays (render/vec.py).  Fallback
(image/noise) textures are evaluated inline for every lane; the JAX
package's deferred-texture mode (``defer_tex``) served the TPU, whose texel
gather is serialised, and is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..scene.build import SceneData, SceneMeta
from ..scene.types import (
    MAT_DIELECTRIC, MAT_DIFFUSE_LIGHT, MAT_ISOTROPIC, MAT_LAMBERTIAN,
    MAT_METAL,
)
from .. import rng as rngm
from . import primtable as pt
from . import vec as v3
from .vec import V3
from .intersect import (
    K_MEDIUM0, K_NONE, K_QUAD, K_SPHERE, UV_CLAMP, QuadFrames,
)
from .shade import INV_4PI, lights_pdf_value, lights_sample
from .textures import texture_value

PI = v3.PI


@dataclass
class BounceOut:
    hit: torch.Tensor         # [R] bool
    p: V3
    emission: V3
    weight: V3
    new_dir: V3
    scatter_ok: torch.Tensor  # [R] bool
    skip_pdf: torch.Tensor    # [R] bool


def finalize_and_shade(data: SceneData, meta: SceneMeta, qf: QuadFrames,
                       table, mat_cols, ro: V3, rd: V3, time, best_t,
                       best_kind, best_idx, seed, pixel, sample, bounce,
                       row_t=None) -> BounceOut:
    """``row_t``: optional precomputed [32, R] ray-minor joined rows (the
    closest-hit kernel's output); when None, gathered here from ``table``.
    ``bounce`` is an int or an [R] tensor of per-lane bounce counts."""
    R = best_t.shape[0]
    Ns = data.sph_center.shape[0]
    hit = best_kind != K_NONE

    if row_t is None:
        # one row of the joined table per ray (misses read row 0)
        g = torch.where(best_kind == K_QUAD, best_idx + Ns, best_idx)
        g = torch.clamp(g.long(), 0, table.shape[0] - 1)
        row_t = table[g].T

    def col(i):
        return row_t[i]

    # media override rows (few, static): a medium lane reads the material
    # and texture columns (0..15) of its phase material
    if meta.media:
        med_sel = [(best_kind == K_MEDIUM0 + m, mat_cols[med.mat_row])
                   for m, med in enumerate(meta.media)]
        base_col = col

        def col(i):
            out = base_col(i)
            if i < 16:
                for sel, mrow in med_sel:
                    out = torch.where(sel, mrow[i], out)
            return out

    def colv(i):
        return V3(col(i), col(i + 1), col(i + 2))

    t = torch.where(hit, best_t, 1.0)
    p = ro + rd * t

    is_sphere = best_kind == K_SPHERE

    g0 = colv(pt.COL_G0)
    g1 = colv(pt.COL_G1)
    g2 = colv(pt.COL_G2)
    s0 = col(pt.COL_S0)
    s1 = col(pt.COL_S1)

    # ---- geometry / normals (objects.cuh:79-86, 206-213, 428-429) ----
    c_t = g0 + g1 * time if meta.any_moving else g0
    r_safe = torch.where(is_sphere & (s0 != 0.0), s0, 1.0)
    outward = (p - c_t) / r_safe         # sphere outward normal
    n_raw = v3.where(is_sphere, outward, g0)  # quad unit normal in G0
    front = v3.dot(rd, n_raw) < 0.0
    normal = v3.where(front, n_raw, -n_raw)
    # media: an arbitrary fixed normal and front face (objects.cuh:428-429)
    if meta.media:
        is_medium = best_kind >= K_MEDIUM0
        normal = v3.where(is_medium, V3.full_like(normal.x, 1.0, 0.0, 0.0),
                          normal)
        front = torch.where(is_medium, True, front)

    # ---- uv (image textures only; quads get alpha/beta for free) ----
    zeros = torch.zeros(R, dtype=torch.float32, device=best_t.device)
    if meta.n_images > 0:
        is_quad = best_kind == K_QUAD
        theta = torch.acos(torch.clamp(-outward.y, -UV_CLAMP, UV_CLAMP))
        phi = torch.atan2(-outward.z, outward.x) + PI
        su = phi / (2.0 * PI)
        sv = theta / PI
        alpha_q = v3.dot(p, g1) - s0
        beta_q = v3.dot(p, g2) - s1
        uu = torch.where(is_quad, alpha_q, torch.where(is_sphere, su, 0.0))
        vv = torch.where(is_quad, beta_q, torch.where(is_sphere, sv, 0.0))
    else:
        uu = vv = zeros

    kind = col(pt.COL_KIND).to(torch.int32)
    kinds_present = set(meta.mat_kind)

    # ---- RNG draws: a slot no material of the scene consumes is not
    # computed (counter-based slots cannot perturb each other) ----
    diffuse_present = kinds_present & {MAT_LAMBERTIAN, MAT_ISOTROPIC}
    if meta.lights or MAT_DIELECTRIC in kinds_present:
        mix_u, pick_u, diel_u, _ = rngm.uniform4(seed, pixel, sample,
                                                 1 + bounce, rngm.SLOT_MIX)
    if diffuse_present:
        m1, m2, _, _ = rngm.uniform4(seed, pixel, sample, 1 + bounce,
                                     rngm.SLOT_MAT_DIR)
    if meta.lights:
        l1, l2, _, _ = rngm.uniform4(seed, pixel, sample, 1 + bounce,
                                     rngm.SLOT_LIGHT_DIR)
    if MAT_METAL in kinds_present:
        f1, f2, _, _ = rngm.uniform4(seed, pixel, sample, 1 + bounce,
                                     rngm.SLOT_FUZZ)

    # ---- attenuation: baked solid/checker (textures.cuh:24-60) ----
    # floor, then an exact float->int conversion, then a floored modulo:
    # the ground checker sees negative cells, where fmod (or truncation
    # before the floor) would flip the parity
    invsc = col(pt.COL_INVSC)
    gx = torch.floor(invsc * p.x).to(torch.int32)
    gy = torch.floor(invsc * p.y).to(torch.int32)
    gz = torch.floor(invsc * p.z).to(torch.int32)
    is_even = torch.remainder(gx + gy + gz, 2) == 0
    attenuation = v3.where(is_even, colv(pt.COL_A), colv(pt.COL_B))
    emission_color = colv(pt.COL_E)

    # ---- fallback textures (image/noise/non-bakeable), inline ----
    if meta.n_images > 0 or meta.n_noise > 0:
        flag = col(pt.COL_FALLBACK) > 0.0
        tid = col(pt.COL_TID).to(torch.int32)
        fb_val = V3.from_rows(texture_value(data, meta, tid, uu, vv,
                                            p.to_rows()))
        attenuation = v3.where(flag, fb_val, attenuation)
        if MAT_DIFFUSE_LIGHT in kinds_present:
            emission_color = v3.where(flag & (kind == MAT_DIFFUSE_LIGHT),
                                      fb_val, emission_color)

    # emission: front faces only (materials.cuh:157-162)
    emission = v3.where(front, emission_color, 0.0)

    skip_pdf = (kind == MAT_METAL) | (kind == MAT_DIELECTRIC)
    scatter_ok = kind != MAT_DIFFUSE_LIGHT

    # ---- specular branch (materials.cuh:73-130) ----
    skip_dir = V3.full_like(t, 1.0, 0.0, 0.0)
    if MAT_METAL in kinds_present:
        refl = v3.reflect(rd, normal)
        fuzz = col(pt.COL_FUZZ)
        metal_dir = v3.unit(refl) + v3.unit_sphere_dir(f1, f2) * fuzz
        skip_dir = v3.where(kind == MAT_METAL, metal_dir, skip_dir)
    if MAT_DIELECTRIC in kinds_present:
        is_diel = kind == MAT_DIELECTRIC
        # sanitize the branch's inputs on non-dielectric and miss lanes
        # (ior is 0 on non-dielectric rows; a miss reads row 0)
        ior = torch.where(is_diel, col(pt.COL_IOR), 1.0)
        d_norm = v3.where(is_diel, normal, V3.full_like(t, 1.0, 0.0, 0.0))
        ratio = torch.where(front, 1.0 / ior, ior)
        ud = v3.unit(v3.where(is_diel, rd, V3.full_like(t, -1.0, 0.0, 0.0)))
        cos_theta = torch.clamp(v3.dot(-ud, d_norm), max=1.0)
        sin_theta = v3.safe_sqrt(1.0 - cos_theta * cos_theta)
        cannot = ratio * sin_theta > 1.0
        reflect_choice = cannot | (v3.schlick(cos_theta, ratio) > diel_u)
        d_dir = v3.where(reflect_choice,
                         v3.reflect(ud, d_norm),
                         v3.refract(ud, d_norm, ratio))
        skip_dir = v3.where(is_diel, d_dir, skip_dir)

    # ---- diffuse branch: cosine/sphere pdf + optional light MIS ----
    if diffuse_present:
        bu, bv, bw = v3.onb_from_w(normal)
        mat_dir = v3.onb_local(bu, bv, bw, v3.cosine_dir(m1, m2))
        if MAT_ISOTROPIC in kinds_present:
            iso_dir = v3.unit_sphere_dir(m1, m2)
            mat_dir = v3.where(kind == MAT_ISOTROPIC, iso_dir, mat_dir)

        if meta.lights:
            light_dir = lights_sample(data, meta, p, pick_u, l1, l2)
            gen_dir = v3.where(mix_u < 0.5, light_dir, mat_dir)
            light_pdf = lights_pdf_value(data, meta, qf, p, gen_dir)
        else:
            gen_dir = mat_dir

        # one shared cosine feeds BOTH the sampling pdf (pdf.cuh:46-49) and
        # the scatter pdf (materials.cuh:52-55), so their ratio is exactly
        # 1 where it should be
        cos_c = v3.dot(v3.unit(gen_dir), bw) / PI
        mat_pdf = torch.clamp(cos_c, min=0.0)
        if MAT_ISOTROPIC in kinds_present:
            mat_pdf = torch.where(kind == MAT_ISOTROPIC, INV_4PI, mat_pdf)
        # the 50/50 light/material mixture (pdf.cuh:85-107)
        pdf = 0.5 * light_pdf + 0.5 * mat_pdf if meta.lights else mat_pdf

        spdf = torch.where(cos_c < 0.0, 0.0, cos_c)
        if MAT_ISOTROPIC in kinds_present:
            spdf = torch.where(kind == MAT_ISOTROPIC, INV_4PI, spdf)

        ratio_w = torch.where(pdf > 0.0,
                              spdf / torch.where(pdf > 0, pdf, 1.0), 0.0)
        diffuse_weight = attenuation * ratio_w
    else:
        gen_dir = skip_dir
        diffuse_weight = V3(zeros, zeros, zeros)

    weight = v3.where(skip_pdf, attenuation, diffuse_weight)
    new_dir = v3.where(skip_pdf, skip_dir, gen_dir)
    return BounceOut(hit=hit, p=p, emission=emission, weight=weight,
                     new_dir=new_dir, scatter_ok=scatter_ok,
                     skip_pdf=skip_pdf)
