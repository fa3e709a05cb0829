"""Light-source sampling: the hittable_pdf / mixture-PDF machinery.

The port of ``mort_tpu.render.shade``.  The reference's heap-allocated pdf
objects (pdf.cuh:12-107, built per bounce, camera.cuh:142-144) become
elementwise functions over the static light list.  Material shading lives
in hitshade.py.

Batched vectors are structure-of-arrays V3 (render/vec.py); per-light
constants are 0-dim tensors that broadcast against the [R] lanes.
"""

from __future__ import annotations

import torch

from ..scene.build import SceneData, SceneMeta
from ..scene.types import OBJ_SPHERE
from . import vec as v3
from .vec import V3
from .intersect import QuadFrames, T_MIN

PI = v3.PI
INV_4PI = 1.0 / (4.0 * PI)


def _const3(a):
    """[3] tensor -> V3 of 0-dim tensors (broadcasts against [R] lanes)."""
    return V3(a[0], a[1], a[2])


def _sphere_light_pdf(data: SceneData, row: int, p: V3, direction: V3):
    """sphere::pdf_value (objects.cuh:110-122): solid-angle pdf, 0 on miss.

    The returned value is computed from ``hits``-sanitised inputs, so the
    masked-out branch stays finite (a gradient through it must not meet
    0 * inf).  For p inside the light sphere the reference takes the sqrt
    of a negative (NaN); it is clamped to 0 here, as in the JAX package."""
    c = _const3(data.sph_center[row])
    r = data.sph_radius[row]
    oc = p - c
    a = torch.clamp(v3.length_sq(direction), min=1e-20)
    half_b = v3.dot(oc, direction)
    c_term = v3.length_sq(oc) - r * r
    disc = half_b * half_b - a * c_term
    sq = v3.safe_sqrt(disc)
    root1 = (-half_b - sq) / a
    root2 = (-half_b + sq) / a
    root = torch.where(root1 > T_MIN, root1, root2)
    hits = (disc >= 0.0) & (root > T_MIN)
    cos_theta_max = v3.safe_sqrt(1.0 - r * r / v3.length_sq(c - p))
    solid_angle = torch.clamp(2.0 * PI * (1.0 - cos_theta_max), min=1e-12)
    return torch.where(hits, 1.0 / solid_angle, 0.0)


def _sphere_light_sample(data: SceneData, row: int, p: V3, u1, u2) -> V3:
    """sphere::random via random_to_sphere (objects.cuh:124-145)."""
    c = _const3(data.sph_center[row])
    direction = c - p
    dist_sq = v3.length_sq(direction)
    r = data.sph_radius[row]
    z = 1.0 + u2 * (v3.safe_sqrt(1.0 - r * r / dist_sq) - 1.0)
    phi = 2.0 * PI * u1
    s = v3.safe_sqrt(1.0 - z * z)
    local = V3(torch.cos(phi) * s, torch.sin(phi) * s, z)
    bu, bv, bw = v3.onb_from_w(direction)
    return v3.onb_local(bu, bv, bw, local)


def _quad_light_pdf(data: SceneData, qf: QuadFrames, row: int, p: V3,
                    direction: V3):
    """quad::pdf_value (objects.cuh:217-229): area-measure pdf, 0 on miss.
    Computed from ``hits``-sanitised values: a grazing masked-out lane
    reaches t ~ num / 1e-8."""
    nrm = _const3(qf.normal[row])
    vxw = _const3(qf.vxw[row])
    wxu = _const3(qf.wxu[row])
    denom = v3.dot(direction, nrm)
    ok_denom = torch.abs(denom) >= 1e-8
    t = torch.where(ok_denom,
                    (qf.D[row] - v3.dot(p, nrm))
                    / torch.where(ok_denom, denom, 1.0),
                    -1.0)
    alpha = v3.dot(p, vxw) + t * v3.dot(direction, vxw) - qf.qa[row]
    beta = v3.dot(p, wxu) + t * v3.dot(direction, wxu) - qf.qb[row]
    hits = (ok_denom & (t > T_MIN)
            & (alpha >= 0) & (alpha <= 1) & (beta >= 0) & (beta <= 1))
    t_s = torch.where(hits, t, 1.0)
    denom_s = torch.where(hits, denom, 1.0)
    dist_sq = t_s * t_s * v3.length_sq(direction)
    cosine = torch.abs(denom_s) / torch.clamp(v3.length(direction),
                                              min=1e-10)
    return torch.where(hits, dist_sq / (cosine * qf.area[row]), 0.0)


def _quad_light_sample(data: SceneData, row: int, p: V3, u1, u2) -> V3:
    """quad::random (objects.cuh:231-235): uniform point minus origin."""
    Q = _const3(data.quad_Q[row])
    u = _const3(data.quad_u[row])
    v = _const3(data.quad_v[row])
    return V3(Q.x + u1 * u.x + u2 * v.x - p.x,
              Q.y + u1 * u.y + u2 * v.y - p.y,
              Q.z + u1 * u.z + u2 * v.z - p.z)


def lights_pdf_value(data: SceneData, meta: SceneMeta, qf: QuadFrames,
                     p: V3, direction: V3):
    """hittable_list::pdf_value: the mean over the light members
    (objects.cuh:489-498)."""
    vals = []
    for light in meta.lights:
        if light.kind == OBJ_SPHERE:
            vals.append(_sphere_light_pdf(data, light.row, p, direction))
        else:
            vals.append(_quad_light_pdf(data, qf, light.row, p, direction))
    return sum(vals) / len(vals)


def lights_sample(data: SceneData, meta: SceneMeta, p: V3, pick_u, u1,
                  u2) -> V3:
    """hittable_list::random: a uniform member pick (objects.cuh:500-504),
    member ``min(int(pick_u * n), n - 1)``."""
    n = len(meta.lights)
    if n == 1:
        light = meta.lights[0]
        if light.kind == OBJ_SPHERE:
            return _sphere_light_sample(data, light.row, p, u1, u2)
        return _quad_light_sample(data, light.row, p, u1, u2)
    pick = torch.clamp((pick_u * n).to(torch.int32), max=n - 1)
    out = None
    for i, light in enumerate(meta.lights):
        if light.kind == OBJ_SPHERE:
            d = _sphere_light_sample(data, light.row, p, u1, u2)
        else:
            d = _quad_light_sample(data, light.row, p, u1, u2)
        out = d if out is None else v3.where(pick == i, d, out)
    return out
