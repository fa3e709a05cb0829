"""Batched ray-scene intersection: the port's reference intersector.

The port of ``mort_tpu.render.intersect`` (``quad_frames``, ``sphere_pass``,
``quad_pass``, ``media_pass``, ``intersect_best``, ``finalize_hit``,
``intersect_world``).  The reference's
sequential closest-hit loop over tagged registries (world.cuh:105-171)
becomes a chunked min-reduction over [R, C] tensors.  The ray-primitive
inner products are written as elementwise products, never
``torch.matmul``, so no TF32 question can arise.

Constant media (objects.cuh:396-434) are resolved after all surfaces in
registry order with a running closest-t (``media_pass``), as in the JAX
package: the free-flight acceptance test is monotone in t_max, so a sample
that the tighter clamp rejects would have lost the closest-hit comparison
anyway.

Closest-hit ties resolve to the earlier registry (sphere < quad < media),
matching the reference's strict ``t < closest_so_far`` update rule.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import rng as rngm
from ..scene.build import SceneData, SceneMeta
from . import vec as v3
from .vec import safe_sqrt

INF = float("inf")
T_MIN = 1e-3          # world-level epsilon (camera.cuh:97)
MEDIUM_EPS = 1e-4     # boundary re-hit epsilon (objects.cuh:404)
UV_CLAMP = 1.0 - 2.0 ** -20   # arccos domain clamp (gradient safety)

# best-hit kind codes
K_NONE = 0
K_SPHERE = 1
K_QUAD = 2
K_MEDIUM0 = 3


@dataclass(frozen=True)
class QuadFrames:
    """Per-quad derived quantities (objects.cuh:170-185)."""
    normal: torch.Tensor   # [Nq,3] unit
    D: torch.Tensor        # [Nq]
    vxw: torch.Tensor      # [Nq,3] cross(v, w)
    wxu: torch.Tensor      # [Nq,3] cross(w, u)
    qa: torch.Tensor       # [Nq] Q . vxw
    qb: torch.Tensor       # [Nq] Q . wxu
    area: torch.Tensor     # [Nq] |cross(u,v)|


@dataclass(frozen=True)
class Hit:
    """One closest hit a ray, with the winner's shading attributes."""
    hit: torch.Tensor         # [R] bool
    t: torch.Tensor           # [R] (1.0 on a miss)
    p: torch.Tensor           # [R,3]
    normal: torch.Tensor      # [R,3] front-face adjusted (hit_record.cuh:20-23)
    front_face: torch.Tensor  # [R] bool
    u: torch.Tensor           # [R]
    v: torch.Tensor           # [R]
    mat: torch.Tensor         # [R] int32 global material row


def _dot3(a, b):
    return torch.sum(a * b, dim=-1)


def quad_frames(data: SceneData) -> QuadFrames:
    n = torch.linalg.cross(data.quad_u, data.quad_v)
    nn = _dot3(n, n)[..., None]
    normal = n / torch.sqrt(nn)
    w = n / nn
    vxw = torch.linalg.cross(data.quad_v, w)
    wxu = torch.linalg.cross(w, data.quad_u)
    return QuadFrames(
        normal=normal,
        D=_dot3(normal, data.quad_Q),
        vxw=vxw,
        wxu=wxu,
        qa=_dot3(data.quad_Q, vxw),
        qb=_dot3(data.quad_Q, wxu),
        area=torch.sqrt(_dot3(n, n)),
    )


def _chunk_bounds(n_rows, n_valid, chunk):
    """Chunking plan: (start, size) pairs covering n_rows, all-padding
    chunks skipped."""
    return [(s, min(chunk, n_rows - s)) for s in range(0, n_rows, chunk)
            if s < n_valid]


def _rc(a, b):
    """[R,3] x [C,3] -> [R,C] inner products, elementwise."""
    return (a[:, 0:1] * b[:, 0] + a[:, 1:2] * b[:, 1]) + a[:, 2:3] * b[:, 2]


def first_min(cand):
    """(min, index of the FIRST minimum) over dim 1 of [R, C]."""
    ct = cand.amin(dim=1)
    cols = torch.arange(cand.shape[1], device=cand.device)
    ci = torch.where(cand == ct[:, None], cols, cand.shape[1]).amin(dim=1)
    return ct, ci


def _merge(best_t, best_idx, ct, ci):
    better = ct < best_t
    return torch.where(better, ct, best_t), torch.where(better, ci, best_idx)


def sphere_pass(data: SceneData, meta: SceneMeta, ro, rd, time, t_min,
                best_t, best_idx, chunk=512):
    """Closest sphere hit (objects.cuh:61-88 batched). Returns (t, idx)."""
    n_rows = data.sph_center.shape[0]
    if meta.n_spheres == 0:
        return best_t, best_idx

    a = _dot3(rd, rd)                          # [R]
    ro_rd = _dot3(ro, rd)
    ro_sq = _dot3(ro, ro)

    for start, size in _chunk_bounds(n_rows, meta.n_spheres, chunk):
        c = data.sph_center[start:start + size]
        surf = data.sph_surface[start:start + size]
        r = data.sph_radius[start:start + size]
        rdc = _rc(rd, c)                       # [R,C]
        roc = _rc(ro, c)
        ctc = _dot3(c, c)                      # [C]
        if meta.any_moving:
            cv = data.sph_cvec[start:start + size]
            rdv = _rc(rd, cv)
            rov = _rc(ro, cv)
            ccv = _dot3(c, cv)
            vv = _dot3(cv, cv)
            tcol = time[:, None]
            half_b = ro_rd[:, None] - rdc - tcol * rdv
            c_term = (ro_sq[:, None] - 2.0 * roc - 2.0 * tcol * rov
                      + ctc[None, :] + 2.0 * tcol * ccv[None, :]
                      + tcol * tcol * vv[None, :] - (r * r)[None, :])
        else:
            half_b = ro_rd[:, None] - rdc
            c_term = ro_sq[:, None] - 2.0 * roc + (ctc - r * r)[None, :]

        disc = half_b * half_b - a[:, None] * c_term
        sq = safe_sqrt(disc)
        inv_a = 1.0 / a[:, None]
        root1 = (-half_b - sq) * inv_a
        root2 = (-half_b + sq) * inv_a
        # nearest root in range (objects.cuh:72-77) with t_max = +inf
        root = torch.where(root1 > t_min, root1, root2)
        valid = (disc >= 0.0) & (root > t_min) & surf[None, :]
        ct, ci = first_min(torch.where(valid, root, INF))
        best_t, best_idx = _merge(best_t, best_idx, ct, ci + start)
    return best_t, best_idx


def quad_pass(data: SceneData, meta: SceneMeta, qf: QuadFrames, ro, rd, t_min,
              best_t, best_idx, chunk=512):
    """Closest quad hit (objects.cuh:190-215 batched). Returns (t, idx)."""
    n_rows = data.quad_Q.shape[0]
    if meta.n_quads == 0:
        return best_t, best_idx

    for start, size in _chunk_bounds(n_rows, meta.n_quads, chunk):
        sl = slice(start, start + size)
        nrm = qf.normal[sl]
        surf = data.quad_surface[sl]
        denom = _rc(rd, nrm)                                 # [R,C]
        ok_denom = torch.abs(denom) >= 1e-8
        denom_safe = torch.where(ok_denom, denom, 1.0)
        t = torch.where(ok_denom,
                        (qf.D[None, sl] - _rc(ro, nrm)) / denom_safe, -1.0)
        alpha = _rc(ro, qf.vxw[sl]) + t * _rc(rd, qf.vxw[sl]) - qf.qa[None, sl]
        beta = _rc(ro, qf.wxu[sl]) + t * _rc(rd, qf.wxu[sl]) - qf.qb[None, sl]
        valid = (ok_denom & (t > t_min)
                 & (alpha >= 0.0) & (alpha <= 1.0)
                 & (beta >= 0.0) & (beta <= 1.0)
                 & surf[None, :])
        ct, ci = first_min(torch.where(valid, t, INF))
        best_t, best_idx = _merge(best_t, best_idx, ct, ci + start)
    return best_t, best_idx


def _sphere_roots_single(data: SceneData, row: int, ro, rd):
    """Both quadratic roots of one sphere over (-inf, inf), for media
    boundaries (objects.cuh:400-404).  Static spheres only: the reference's
    media wrap non-moving boundaries.  ro/rd are SoA V3."""
    c = data.sph_center[row]
    r = data.sph_radius[row]
    oc = ro - v3.V3(c[0], c[1], c[2])
    a = v3.length_sq(rd)
    half_b = v3.dot(oc, rd)
    c_term = v3.length_sq(oc) - r * r
    disc = half_b * half_b - a * c_term
    sq = safe_sqrt(disc)
    ok = disc >= 0.0
    root1 = (-half_b - sq) / a
    root2 = (-half_b + sq) / a
    return [(root1, ok), (root2, ok)]


def _quad_t_single(data: SceneData, qf: QuadFrames, row: int, ro, rd):
    """One quad's plane hit over (-inf, inf), for media boundaries."""
    nrm = v3.V3(*qf.normal[row])
    vxw = v3.V3(*qf.vxw[row])
    wxu = v3.V3(*qf.wxu[row])
    denom = v3.dot(rd, nrm)
    ok_denom = torch.abs(denom) >= 1e-8
    t = torch.where(ok_denom,
                    (qf.D[row] - v3.dot(ro, nrm))
                    / torch.where(ok_denom, denom, 1.0),
                    -1.0)
    alpha = v3.dot(ro, vxw) + t * v3.dot(rd, vxw) - qf.qa[row]
    beta = v3.dot(ro, wxu) + t * v3.dot(rd, wxu) - qf.qb[row]
    ok = (ok_denom & (alpha >= 0) & (alpha <= 1) & (beta >= 0)
          & (beta <= 1))
    return [(t, ok)]


def media_pass(data: SceneData, meta: SceneMeta, qf: QuadFrames, ro, rd,
               seed, pixel, sample, bounce, t_min, best_t, best_kind,
               best_idx):
    """Constant-media free-flight sampling (objects.cuh:396-434) after all
    surfaces, with a running closest-t.  ro/rd are SoA V3.  Returns
    (best_t, best_kind, best_idx) with medium m as kind ``K_MEDIUM0 + m``,
    idx m."""
    if not meta.media:
        return best_t, best_kind, best_idx
    # ONE philox block serves up to 4 media: medium m reads word m
    u_media = rngm.uniform4(seed, pixel, sample, 1 + bounce,
                            rngm.SLOT_MEDIUM0)
    for m, med in enumerate(meta.media):
        cands = []
        for row in med.sphere_rows:
            cands += _sphere_roots_single(data, row, ro, rd)
        for row in med.quad_rows:
            cands += _quad_t_single(data, qf, row, ro, rd)
        # few candidates (media wrap 1-6 faces): pairwise minima
        t1 = None
        for t, ok in cands:
            c = torch.where(ok, t, INF)
            t1 = c if t1 is None else torch.minimum(t1, c)
        found1 = torch.isfinite(t1)
        t2 = None
        for t, ok in cands:
            c = torch.where(ok & (t > t1 + MEDIUM_EPS), t, INF)
            t2 = c if t2 is None else torch.minimum(t2, c)
        found2 = torch.isfinite(t2)

        rec1 = torch.clamp(t1, min=t_min)
        rec2 = torch.minimum(t2, best_t)
        ok = found1 & found2 & (rec1 < rec2)
        rec1 = torch.clamp(rec1, min=0.0)

        ray_len = v3.length(rd)
        dist_inside = (rec2 - rec1) * ray_len
        # u = 0 maps to log -> -inf in the reference (a rejected sample);
        # the floor keeps gradients through rejected lanes finite
        hit_dist = data.med_neg_inv_density[m] * torch.log(
            torch.clamp(u_media[m], min=1e-37))
        accept = ok & (hit_dist <= dist_inside)
        t_med = rec1 + hit_dist / ray_len

        best_t = torch.where(accept, t_med, best_t)
        best_kind = torch.where(accept, K_MEDIUM0 + m, best_kind)
        best_idx = torch.where(accept, m, best_idx)
    return best_t, best_kind, best_idx


def intersect_best(data: SceneData, meta: SceneMeta, qf: QuadFrames,
                   ro, rd, time, seed, pixel, sample, bounce, chunk=512):
    """world::hit closest-hit search over [R,3] rays, media included:
    returns (best_t with +inf on a miss, best_kind int32, best_idx
    int32)."""
    R = ro.shape[0]
    inf = torch.full((R,), INF, dtype=torch.float32, device=ro.device)
    zero = torch.zeros(R, dtype=torch.int64, device=ro.device)

    sph_t, sph_i = sphere_pass(data, meta, ro, rd, time, T_MIN, inf, zero,
                               chunk)
    qt, qi = quad_pass(data, meta, qf, ro, rd, T_MIN, inf, zero, chunk)

    # merge (spheres win ties: world.cuh loop order)
    q_better = qt < sph_t
    best_t = torch.where(q_better, qt, sph_t)
    best_kind = torch.where(q_better, K_QUAD,
                            torch.where(torch.isfinite(sph_t), K_SPHERE,
                                        K_NONE)).to(torch.int32)
    best_idx = torch.where(q_better, qi, sph_i).to(torch.int32)
    return media_pass(data, meta, qf, v3.V3.from_rows(ro),
                      v3.V3.from_rows(rd), seed, pixel, sample, bounce,
                      T_MIN, best_t, best_kind, best_idx)


def finalize_hit(data: SceneData, meta: SceneMeta, qf: QuadFrames, ro, rd,
                 time, best_t, best_kind, best_idx) -> Hit:
    """Gather the winning primitive's shading attributes, one a ray, from
    [R,3] rays and a closest hit (best_t, best_kind, best_idx)."""
    hit = best_kind != K_NONE
    t = torch.where(hit, best_t, 1.0)
    p = ro + t[:, None] * rd

    R = ro.shape[0]
    normal = torch.zeros_like(ro)
    normal[:, 0] = 1.0
    front = torch.ones(R, dtype=torch.bool, device=ro.device)
    uu = torch.zeros(R, dtype=torch.float32, device=ro.device)
    vv = torch.zeros_like(uu)
    mat = torch.zeros(R, dtype=torch.int32, device=ro.device)

    if meta.n_spheres > 0:
        i = torch.clamp(best_idx.long(), 0, data.sph_center.shape[0] - 1)
        c = data.sph_center[i] + time[:, None] * data.sph_cvec[i]
        r = data.sph_radius[i]
        r_safe = torch.where(r != 0.0, r, 1.0)
        outward = (p - c) / r_safe[:, None]
        s_front = _dot3(rd, outward) < 0.0
        s_normal = torch.where(s_front[:, None], outward, -outward)
        # compute_uv (objects.cuh:101-108); the arccos argument is clamped
        # one ulp inside (-1, 1) so that pole gradients stay finite
        theta = torch.arccos(torch.clamp(-outward[:, 1], -UV_CLAMP,
                                         UV_CLAMP))
        phi = torch.atan2(-outward[:, 2], outward[:, 0]) + v3.PI
        sel = best_kind == K_SPHERE
        normal = torch.where(sel[:, None], s_normal, normal)
        front = torch.where(sel, s_front, front)
        uu = torch.where(sel, phi / (2.0 * v3.PI), uu)
        vv = torch.where(sel, theta / v3.PI, vv)
        mat = torch.where(sel, data.sph_mat[i].to(torch.int32), mat)

    if meta.n_quads > 0:
        i = torch.clamp(best_idx.long(), 0, data.quad_Q.shape[0] - 1)
        nrm = qf.normal[i]
        rel = p - data.quad_Q[i]
        alpha = _dot3(rel, qf.vxw[i])
        beta = _dot3(rel, qf.wxu[i])
        q_front = _dot3(rd, nrm) < 0.0
        q_normal = torch.where(q_front[:, None], nrm, -nrm)
        sel = best_kind == K_QUAD
        normal = torch.where(sel[:, None], q_normal, normal)
        front = torch.where(sel, q_front, front)
        uu = torch.where(sel, alpha, uu)
        vv = torch.where(sel, beta, vv)
        mat = torch.where(sel, data.quad_mat[i].to(torch.int32), mat)

    x_axis = torch.tensor([1.0, 0.0, 0.0], device=ro.device)
    for m, med in enumerate(meta.media):
        # an arbitrary normal and front face (objects.cuh:428-429)
        sel = best_kind == K_MEDIUM0 + m
        normal = torch.where(sel[:, None], x_axis, normal)
        front = torch.where(sel, True, front)
        uu = torch.where(sel, 0.0, uu)
        vv = torch.where(sel, 0.0, vv)
        mat = torch.where(sel, med.mat_row, mat)

    return Hit(hit=hit, t=t, p=p, normal=normal, front_face=front, u=uu,
               v=vv, mat=mat)


def intersect_world(data: SceneData, meta: SceneMeta, qf: QuadFrames,
                    ro, rd, time, seed, pixel, sample, bounce,
                    chunk=512) -> Hit:
    """The whole world::hit (world.cuh:105-171) over [R,3] rays, unfused:
    the closest hit (``closest_hit.closest_hit``: the CUDA kernel of the
    auto accel on a card, its plain version on the CPU), the media draw
    (``media_pass``) and the ``finalize_hit`` gather.  Earlier rows win
    ties and a sphere beats a quad on an exact tie.  ``chunk`` is the JAX
    signature's primitive chunk; the kernel has none, and it is unused."""
    from . import closest_hit as ch
    from .primtable import build_prim_table

    table, _ = build_prim_table(data, meta, qf)
    packed = ch.pack_scene(data, meta, qf, table,
                           ch.auto_accel(meta.n_spheres + meta.n_quads))
    ro_v, rd_v = v3.V3.from_rows(ro), v3.V3.from_rows(rd)
    best_t, best_kind, best_idx, _ = ch.closest_hit(packed, ro_v, rd_v,
                                                    time)
    best_t, best_kind, best_idx = media_pass(
        data, meta, qf, ro_v, rd_v, seed, pixel, sample, bounce, T_MIN,
        best_t, best_kind, best_idx)
    return finalize_hit(data, meta, qf, ro, rd, time, best_t, best_kind,
                        best_idx)
