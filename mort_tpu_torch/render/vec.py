"""Structure-of-arrays 3-vectors: three flat [R] tensors per vector.

The port of ``mort_tpu.render.vec`` (semantics of the reference's vec3,
vec3.cuh:13-227).  A dot product is two multiply-adds over [R] tensors,
with no reduction, and every shading op is elementwise.  The JAX package's
``math3`` helpers that the intersector needs (``safe_sqrt``, ``PI``) live
here too, with ``rotate_around``, which acts on [..., 3] tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

PI = 3.14159265358979323846


class V3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    # -- algebra ----------------------------------------------------------
    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    def __radd__(self, o):
        return self.__add__(o)

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return V3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    def __rmul__(self, o):
        return self.__mul__(o)

    def __truediv__(self, o):
        if isinstance(o, V3):
            return V3(self.x / o.x, self.y / o.y, self.z / o.z)
        return V3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    # -- conversions ------------------------------------------------------
    @staticmethod
    def from_rows(a):
        """[..., 3] tensor -> V3 of [...] components."""
        return V3(a[..., 0], a[..., 1], a[..., 2])

    @staticmethod
    def full_like(t, cx, cy, cz):
        return V3(torch.full_like(t, cx), torch.full_like(t, cy),
                  torch.full_like(t, cz))

    @staticmethod
    def zeros(n, device):
        z = torch.zeros(n, dtype=torch.float32, device=device)
        return V3(z, z, z)

    @staticmethod
    def ones(n, device):
        o = torch.ones(n, dtype=torch.float32, device=device)
        return V3(o, o, o)

    def to_rows(self):
        """V3 of [...] -> [..., 3]."""
        return torch.stack([self.x, self.y, self.z], dim=-1)


def _sel(mask, a, b):
    """torch.where with python-scalar operands allowed on either side."""
    if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
        a = torch.full_like(mask, a, dtype=torch.float32)
    return torch.where(mask, a, b)


def where(mask, a, b):
    """Lane-masked select; mask is [R] (broadcast over components)."""
    ax, ay, az = a if isinstance(a, V3) else (a, a, a)
    bx, by, bz = b if isinstance(b, V3) else (b, b, b)
    return V3(_sel(mask, ax, bx), _sel(mask, ay, by), _sel(mask, az, bz))


def dot(a: V3, b: V3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: V3, b: V3) -> V3:
    return V3(a.y * b.z - a.z * b.y,
              a.z * b.x - a.x * b.z,
              a.x * b.y - a.y * b.x)


def length_sq(a: V3):
    return dot(a, a)


def length(a: V3):
    return torch.sqrt(dot(a, a))


def safe_sqrt(x):
    """sqrt that is 0 for x <= 0 (and never evaluates sqrt of a negative)."""
    pos = x > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def unit(a: V3) -> V3:
    inv = 1.0 / length(a)
    return V3(a.x * inv, a.y * inv, a.z * inv)


def reflect(v: V3, n: V3) -> V3:
    d = 2.0 * dot(v, n)
    return V3(v.x - d * n.x, v.y - d * n.y, v.z - d * n.z)


def refract(uv: V3, n: V3, etai_over_etat) -> V3:
    """Snell refraction of unit vector uv (vec3.cuh:198-204); the sqrt
    argument is floored at 1e-20 as in the JAX package (forward values
    change by < 1e-10)."""
    cos_theta = torch.clamp(dot(-uv, n), max=1.0)
    perp = (uv + n * cos_theta) * etai_over_etat
    par = -torch.sqrt(torch.clamp(torch.abs(1.0 - length_sq(perp)),
                                  min=1e-20))
    return perp + n * par


def schlick(cosine, ref_idx):
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    c = 1.0 - cosine
    # x**5 as four multiplies, the order jax's integer_pow lowers to
    c2 = c * c
    return r0 + (1.0 - r0) * (c2 * c2 * c)


def unit_sphere_dir(u1, u2) -> V3:
    """Uniform direction on the unit sphere from two uniforms."""
    z = 1.0 - 2.0 * u1
    r = safe_sqrt(1.0 - z * z)
    phi = (2.0 * PI) * u2
    return V3(r * torch.cos(phi), r * torch.sin(phi), z)


def cosine_dir(u1, u2) -> V3:
    """Cosine-weighted hemisphere direction in the local ONB frame."""
    phi = (2.0 * PI) * u1
    sq = safe_sqrt(u2)
    return V3(torch.cos(phi) * sq, torch.sin(phi) * sq, safe_sqrt(1.0 - u2))


def onb_from_w(w: V3):
    """Orthonormal basis (u, v, unit_w) from a direction (onb.cuh:41-50)."""
    uw = unit(w)
    big_x = torch.abs(uw.x) > 0.9
    zero = torch.zeros_like(uw.x)
    a = V3(torch.where(big_x, 0.0, 1.0) + zero,
           torch.where(big_x, 1.0, 0.0) + zero, zero)
    v = unit(cross(uw, a))
    u = cross(uw, v)
    return u, v, uw


def onb_local(u: V3, v: V3, w: V3, a: V3) -> V3:
    """a.x*u + a.y*v + a.z*w (onb.cuh:36-39)."""
    return V3(a.x * u.x + a.y * v.x + a.z * w.x,
              a.x * u.y + a.y * v.y + a.z * w.y,
              a.x * u.z + a.y * v.z + a.z * w.z)



def rotate_around(vec, axis, theta):
    """Rotate ``vec`` around ``axis`` by ``theta`` radians (rotate_around,
    vec3.cuh:214-227; the viewer's mouse orbit).  [..., 3] tensors, in
    their own dtype."""
    def dot3(a, b):
        return torch.sum(a * b, dim=-1)

    theta = torch.as_tensor(theta, dtype=vec.dtype, device=vec.device)
    a_par = (dot3(vec, axis) / dot3(axis, axis))[..., None] * axis
    a_ort = vec - a_par
    w = torch.linalg.cross(axis, a_ort)
    len_ort = torch.sqrt(dot3(a_ort, a_ort))
    x1 = torch.cos(theta) / len_ort
    x2 = torch.sin(theta) / torch.sqrt(dot3(w, w))
    a_rot = len_ort[..., None] * (x1[..., None] * a_ort + x2[..., None] * w)
    return a_rot + a_par
