"""The plain reference: a straightforward path tracer in PyTorch.

It takes the scene as ``harness.world`` flattens the configuration's
description (numpy ``leaves`` and ``meta``, rows in registry order) and
the camera's fields, and works out everything else itself: quad frames, materials and
textures a hit, camera rays, every random draw, the closest hit over every
primitive, constant media, light sampling and the radiance fold.  It
imports nothing of the program.  Its semantics are the port's documented
ones (the reference renderer's, mort.cu and its headers):

* a draw is Philox4x32-10 of the counter (pixel, sample, bounce + 1,
  slot) under the key (seed, 0xC0FFEE42), so any path can be traced alone;
* the closest hit is a scan of every surface sphere and quad, the nearest
  t above 1e-3, earlier rows first and a sphere before a quad on a tie;
  constant media sample a free flight after the surfaces;
* a path adds beta x emission at each hit (not on metal and glass), beta
  x background on a miss, stops on a light and after ``bounce_limit``
  bounces, and a pixel is the mean of its samples (a NaN sample zeroes
  it, as the image's scrub does).

``dtype`` sets the precision of every float: float32 is the reference,
bfloat16 the control that a sound comparison has to reject.  With
``differentiable=True`` the winner's t is recomputed from its primitive
under autograd, so gradients reach the scene's leaves as they do through
the closest hit's own derivative.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

PI = 3.14159265358979323846
INV_4PI = 1.0 / (4.0 * PI)
T_MIN = 1e-3
MEDIUM_EPS = 1e-4
UV_CLAMP = 1.0 - 2.0 ** -20

MAT_LAMBERTIAN, MAT_METAL, MAT_DIELECTRIC, MAT_DIFFUSE_LIGHT, \
    MAT_ISOTROPIC = 1, 2, 3, 4, 5
TEX_SOLID, TEX_CHECKER, TEX_IMAGE, TEX_NOISE = 1, 2, 3, 4
OBJ_SPHERE = 1

K_NONE, K_SPHERE, K_QUAD, K_MEDIUM0 = 0, 1, 2, 3

# the differentiable leaves, by their SceneData names
DIFF_LEAVES = ("sph_center", "sph_cvec", "sph_radius", "quad_Q", "quad_u",
               "quad_v", "mat_albedo", "mat_fuzz", "mat_ior", "tex_color")

# ---------------------------------------------------------------------------
# Philox4x32-10 on u32 words held in int64
# ---------------------------------------------------------------------------

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_KEY1 = 0xC0FFEE42
_M32 = 0xFFFFFFFF
SLOT_CAM_PIXEL, SLOT_CAM_LENS = 0, 1
SLOT_MIX, SLOT_MAT_DIR, SLOT_LIGHT_DIR, SLOT_FUZZ, SLOT_MEDIUM0 = 0, 1, 2, 3, 4


def _mulhilo(a, m):
    p = a * (m & 0xFFFF)
    q = a * (m >> 16) + (p >> 16)
    return q >> 16, ((q & 0xFFFF) << 16) | (p & 0xFFFF)


def philox(c0, c1, c2, c3, seed):
    """Four u32 words (int64 tensors) of one Philox4x32-10 block."""
    k0, k1 = int(seed) & _M32, _KEY1
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & _M32
        k1 = (k1 + _W1) & _M32
    return c0, c1, c2, c3


def uniforms(seed, pixel, sample, bounce_plus1, slot, dtype):
    """Four uniforms in [0, 1): the top 24 bits of each word over 2^24."""
    z = torch.zeros_like(pixel)
    words = philox(pixel & _M32, sample & _M32, (z + bounce_plus1) & _M32,
                   z + slot, seed)
    return [((w >> 8).to(torch.float32) * (1.0 / (1 << 24))).to(dtype)
            for w in words]


# ---------------------------------------------------------------------------
# 3-vectors as [N, 3] tensors
# ---------------------------------------------------------------------------

def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def safe_sqrt(x):
    pos = x > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def unit(a):
    return a * (1.0 / torch.sqrt(dot(a, a)))[..., None]


def sel(mask, a, b):
    """torch.where over [N] masks and [N, 3] or [N] operands."""
    if isinstance(a, torch.Tensor) and a.dim() == 2 or \
            isinstance(b, torch.Tensor) and b.dim() == 2:
        mask = mask[..., None]
    return torch.where(mask, a, b)


def reflect(v, n):
    return v - n * (2.0 * dot(v, n))[..., None]


def refract(uv, n, eta):
    cos_theta = torch.clamp(dot(-uv, n), max=1.0)
    perp = (uv + n * cos_theta[..., None]) * eta[..., None]
    par = -torch.sqrt(torch.clamp(torch.abs(1.0 - dot(perp, perp)),
                                  min=1e-20))
    return perp + n * par[..., None]


def schlick(cosine, ref_idx):
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    c = 1.0 - cosine
    c2 = c * c
    return r0 + (1.0 - r0) * (c2 * c2 * c)


def sphere_dir(u1, u2):
    z = 1.0 - 2.0 * u1
    r = safe_sqrt(1.0 - z * z)
    phi = (2.0 * PI) * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)


def cosine_dir(u1, u2):
    phi = (2.0 * PI) * u1
    sq = safe_sqrt(u2)
    return torch.stack([torch.cos(phi) * sq, torch.sin(phi) * sq,
                        safe_sqrt(1.0 - u2)], -1)


def onb(w):
    """(u, v, unit w) of a direction."""
    uw = unit(w)
    big_x = torch.abs(uw[..., 0]) > 0.9
    one, zero = torch.ones_like(uw[..., 0]), torch.zeros_like(uw[..., 0])
    a = torch.stack([torch.where(big_x, zero, one),
                     torch.where(big_x, one, zero), zero], -1)
    v = unit(cross(uw, a))
    return cross(uw, v), v, uw


def local(u, v, w, a):
    return (u * a[..., 0:1] + v * a[..., 1:2]) + w * a[..., 2:3]


# ---------------------------------------------------------------------------
# Noise texture: hash-lattice Perlin noise with marble turbulence
# ---------------------------------------------------------------------------

_HX, _HY, _HZ, _HM = 0x8DA6B343, 0xD8163841, 0xCB1AB31F, 0x9E3779B1


def _mullo(a, m):
    return (a * (m & 0xFFFF) + (((a * (m >> 16)) & 0xFFFF) << 16)) & _M32


def _avalanche(h, salt):
    h = (h + (int(salt) & _M32)) & _M32
    h = h ^ (h >> 13)
    h = _mullo(h, _HM)
    return h ^ (h >> 16)


def _grad_dot(h, wx, wy, wz):
    hh = h & 15
    u = torch.where(hh < 8, wx, wy)
    v = torch.where(hh < 4, wy, torch.where((hh == 12) | (hh == 14), wx, wz))
    u = torch.where((h & 1) != 0, -u, u)
    v = torch.where((h & 2) != 0, -v, v)
    return (u + v) * 0.7071067811865476


def _perlin(p, salt):
    pf = torch.floor(p)
    f = p - pf
    f1 = f * f * (3.0 - 2.0 * f)
    cell = pf.to(torch.int64) & _M32
    uu = f1 * f1 * (3.0 - 2.0 * f1)
    hx0 = _mullo(cell[..., 0], _HX)
    hy0 = _mullo(cell[..., 1], _HY)
    hz0 = _mullo(cell[..., 2], _HZ)
    hx = (hx0, (hx0 + _HX) & _M32)
    hy = (hy0, (hy0 + _HY) & _M32)
    hz = (hz0, (hz0 + _HZ) & _M32)
    acc = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    for di in (0, 1):
        for dj in (0, 1):
            for dk in (0, 1):
                h = _avalanche(hx[di] ^ hy[dj] ^ hz[dk], salt)
                w = ((di * uu[..., 0] + (1 - di) * (1.0 - uu[..., 0]))
                     * (dj * uu[..., 1] + (1 - dj) * (1.0 - uu[..., 1]))
                     * (dk * uu[..., 2] + (1 - dk) * (1.0 - uu[..., 2])))
                acc = acc + w * _grad_dot(h, f1[..., 0] - di,
                                          f1[..., 1] - dj, f1[..., 2] - dk)
    return acc


def marble(p, nid):
    """0.5 (1 + sin(z + 10 turb(p))), turb the sum of 7 |octaves|."""
    salt = ((int(nid) + 1) * 0x51ED270B) & _M32
    acc = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    q, weight = p, 1.0
    for _ in range(7):
        acc = acc + weight * _perlin(q, salt)
        weight *= 0.5
        q = q * 2.0
    return 0.5 * (1.0 + torch.sin(p[..., 2] + 10.0 * torch.abs(acc)))


# ---------------------------------------------------------------------------
# Scene and camera
# ---------------------------------------------------------------------------

@dataclass
class Scene:
    """The scene's leaves as tensors of ``dtype`` (index and flag leaves
    as int64 and bool), with its static description."""
    t: dict
    meta: dict
    dtype: torch.dtype

    @property
    def device(self):
        return self.t["sph_center"].device


def make_scene(leaves: dict, meta: dict, device, dtype=torch.float32,
               requires_grad=False) -> Scene:
    t = {}
    for k, v in leaves.items():
        if k in ("images", "images_packed"):
            continue
        a = np.asarray(v)
        if a.dtype == np.bool_:
            t[k] = torch.from_numpy(a.copy()).to(device)
        elif np.issubdtype(a.dtype, np.integer):
            t[k] = torch.from_numpy(a.astype(np.int64)).to(device)
        else:
            x = torch.from_numpy(a.astype(np.float32)).to(device, dtype)
            if requires_grad and k in DIFF_LEAVES:
                x.requires_grad_()
            t[k] = x
    t["images"] = [torch.from_numpy(np.asarray(im, np.float32)).to(device,
                                                                   dtype)
                   for im in leaves["images"]]
    return Scene(t, meta, dtype)


def quad_frames(s: Scene):
    n = cross(s.t["quad_u"], s.t["quad_v"])
    nn = dot(n, n)
    normal = n / torch.sqrt(nn)[..., None]
    w = n / nn[..., None]
    vxw = cross(s.t["quad_v"], w)
    wxu = cross(w, s.t["quad_u"])
    return dict(normal=normal, D=dot(normal, s.t["quad_Q"]), vxw=vxw, wxu=wxu,
                qa=dot(s.t["quad_Q"], vxw), qb=dot(s.t["quad_Q"], wxu),
                area=torch.sqrt(dot(n, n)))


@dataclass
class Cam:
    center: torch.Tensor
    p00: torch.Tensor
    du: torch.Tensor
    dv: torch.Tensor
    disk_u: torch.Tensor
    disk_v: torch.Tensor
    defocus: bool
    W: int
    H: int
    sqrt_spp: int
    depth: int
    background: torch.Tensor


def _unit1(v):
    return v / torch.sqrt(torch.sum(v * v))


def make_cam(fields: dict, device, dtype=torch.float32) -> Cam:
    """The camera's frame (camera.cuh:47-84) from its fields, in float32
    on ``device``, then cast to ``dtype``."""
    f = {k: torch.tensor(np.asarray(fields[k], np.float32), device=device)
         for k in ("lookfrom", "lookat", "vup", "vfov", "defocus_angle",
                   "focus_dist", "background")}
    W, H = int(fields["image_width"]), int(fields["image_height"])
    h = torch.tan(torch.deg2rad(f["vfov"]) / 2.0)
    vh = 2.0 * h * f["focus_dist"]
    vw = vh * (W / H)
    w = _unit1(f["lookfrom"] - f["lookat"])
    u = _unit1(torch.linalg.cross(f["vup"], w))
    v = torch.linalg.cross(w, u)
    vu, vv = vw * u, vh * -v
    du, dv = vu / W, -vv / H
    upper_left = f["lookfrom"] - f["focus_dist"] * w - vu / 2 + vv / 2
    p00 = upper_left + 0.5 * (du + dv)
    radius = f["focus_dist"] * torch.tan(torch.deg2rad(
        f["defocus_angle"] / 2.0))
    cast = (lambda x: x.to(dtype))
    return Cam(cast(f["lookfrom"]), cast(p00), cast(du), cast(dv),
               cast(u * radius), cast(v * radius),
               bool(float(f["defocus_angle"]) > 0.0), W, H,
               int(fields["sqrt_spp"]), int(fields["bounce_limit"]),
               cast(f["background"]))


def camera_rays(cam: Cam, seed, pixel, sample, dtype):
    """(origin, direction, time) of stratified camera samples."""
    W, n = cam.W, cam.sqrt_spp
    x = (pixel % W).to(dtype)
    y = torch.div(pixel, W, rounding_mode="floor").to(dtype)
    si = (sample % n).to(dtype)
    sj = torch.div(sample, n, rounding_mode="floor").to(dtype)
    recip = float(np.float32(1.0 / n))
    u1, u2, u_time, _ = uniforms(seed, pixel, sample, 0, SLOT_CAM_PIXEL,
                                 dtype)
    sx = x + (si + u1) * recip - 0.5
    sy = y + (sj + u2) * recip - 0.5
    target = (cam.p00 + sx[:, None] * cam.du) + sy[:, None] * cam.dv
    origin = cam.center.expand_as(target)
    if cam.defocus:
        d1, d2, _, _ = uniforms(seed, pixel, sample, 0, SLOT_CAM_LENS, dtype)
        r = torch.sqrt(d1)
        phi = (2.0 * math.pi) * d2
        origin = (cam.center + (r * torch.cos(phi))[:, None] * cam.disk_u
                  + (r * torch.sin(phi))[:, None] * cam.disk_v)
    return origin, target - origin, u_time


# ---------------------------------------------------------------------------
# Closest hit: a scan of every primitive
# ---------------------------------------------------------------------------

def _first_min(cand):
    ct = cand.amin(dim=1)
    cols = torch.arange(cand.shape[1], device=cand.device)
    ci = torch.where(cand == ct[:, None], cols, cand.shape[1]).amin(dim=1)
    return ct, ci


def _sphere_t(o, d, tm, c, cv, r, pairwise):
    """(hit, t) of |o + t d - (c + tm cv)|^2 = r^2, the nearest root above
    T_MIN, expanded about the origin and compared in units of |d|^2 (the
    form the closest-hit scan uses; its records hold c.c - r^2, 2 c.cv and
    cv.cv): every ray against every sphere ([N, C]) when ``pairwise``,
    else ray n against sphere n ([N])."""
    if pairwise:
        def rc(a, b):
            return (a[:, 0:1] * b[:, 0] + a[:, 1:2] * b[:, 1]) \
                + a[:, 2:3] * b[:, 2]

        def col(x):
            return x[:, None]
    else:
        rc = dot

        def col(x):
            return x
    a = col(dot(d, d))
    ro_rd, ro_sq, t1 = col(dot(o, d)), col(dot(o, o)), col(tm)
    td, to = d * tm[:, None], o * tm[:, None]
    ctc_r2 = dot(c, c) - r * r
    ccv2 = 2.0 * dot(c, cv)
    vv = dot(cv, cv)
    half_b = (ro_rd - rc(d, c)) - rc(td, cv)
    c_term = ((((ro_sq - 2.0 * rc(o, c)) - 2.0 * rc(to, cv)) + ctc_r2)
              + t1 * ccv2) + (t1 * t1) * vv
    disc = half_b * half_b - a * c_term
    ok = disc >= 0.0
    sq = safe_sqrt(disc)
    root1 = -half_b - sq
    tmin_a = a * T_MIN
    root = torch.where(root1 > tmin_a, root1, root1 + 2.0 * sq)
    return ok & (root > tmin_a), root * (1.0 / a)


def _scan(s: Scene, qf: dict, ro, rd, tm, block=1 << 15):
    """(t with +inf on a miss, kind, row) of the closest surface hit."""
    N = ro.shape[0]
    dev = ro.device
    inf = torch.full((N,), float("inf"), dtype=s.dtype, device=dev)
    sph_t, sph_i = inf.clone(), torch.zeros(N, dtype=torch.int64, device=dev)
    q_t, q_i = inf.clone(), torch.zeros(N, dtype=torch.int64, device=dev)
    ns, nq = s.meta["n_spheres"], s.meta["n_quads"]
    ssurf = s.t["sph_surface"][:ns]
    qsurf = s.t["quad_surface"][:nq]
    for b0 in range(0, N, block):
        sl = slice(b0, min(b0 + block, N))
        o, d, t = ro[sl], rd[sl], tm[sl]
        if ns:
            ok, root = _sphere_t(o, d, t, s.t["sph_center"][:ns],
                                 s.t["sph_cvec"][:ns], s.t["sph_radius"][:ns],
                                 True)
            sph_t[sl], sph_i[sl] = _first_min(
                torch.where(ok & ssurf, root, float("inf")))
        if nq:
            n = qf["normal"][:nq]
            denom = (d[:, 0:1] * n[:, 0] + d[:, 1:2] * n[:, 1]
                     + d[:, 2:3] * n[:, 2])
            ok_d = torch.abs(denom) >= 1e-8
            on = o[:, 0:1] * n[:, 0] + o[:, 1:2] * n[:, 1] + o[:, 2:3] * n[:, 2]
            tq = torch.where(ok_d, (qf["D"][:nq] - on)
                             / torch.where(ok_d, denom, 1.0), -1.0)

            def plane(vec, off):
                vec = vec[:nq]
                return (((o[:, 0:1] * vec[:, 0] + o[:, 1:2] * vec[:, 1]
                          + o[:, 2:3] * vec[:, 2]) - off[:nq])
                        + tq * (d[:, 0:1] * vec[:, 0] + d[:, 1:2] * vec[:, 1]
                                + d[:, 2:3] * vec[:, 2]))
            al = plane(qf["vxw"], qf["qa"])
            be = plane(qf["wxu"], qf["qb"])
            ok = (ok_d & (tq > T_MIN) & (al >= 0.0) & (al <= 1.0)
                  & (be >= 0.0) & (be <= 1.0) & qsurf)
            q_t[sl], q_i[sl] = _first_min(torch.where(ok, tq, float("inf")))
    q_better = q_t < sph_t
    best_t = torch.where(q_better, q_t, sph_t)
    kind = torch.where(q_better, K_QUAD,
                       torch.where(torch.isfinite(sph_t), K_SPHERE, K_NONE))
    return best_t, kind, torch.where(q_better, q_i, sph_i)


def _winner_t(s: Scene, qf: dict, ro, rd, tm, kind, idx):
    """The winner's t recomputed from its primitive under autograd."""
    i = idx.clamp(0, s.t["sph_center"].shape[0] - 1)
    _, t_s = _sphere_t(ro, rd, tm, s.t["sph_center"][i], s.t["sph_cvec"][i],
                       s.t["sph_radius"][i], False)
    if s.meta["n_quads"]:
        j = idx.clamp(0, s.t["quad_Q"].shape[0] - 1)
        n = qf["normal"][j]
        denom = dot(rd, n)
        ok = torch.abs(denom) >= 1e-8
        t_q = (qf["D"][j] - dot(ro, n)) / torch.where(ok, denom, 1.0)
        t_s = torch.where(kind == K_QUAD, t_q, t_s)
    return torch.where(kind == K_NONE, float("inf"), t_s)


def _media(s: Scene, qf: dict, ro, rd, seed, pixel, sample, bounce, best_t,
           kind, idx):
    """Constant media after the surfaces, in registry order, with a
    running closest t (objects.cuh:396-434)."""
    if not s.meta["media"]:
        return best_t, kind, idx
    um = uniforms(seed, pixel, sample, 1 + bounce, SLOT_MEDIUM0, s.dtype)
    inf = float("inf")
    for m, med in enumerate(s.meta["media"]):
        cands = []
        for row in med["sphere_rows"]:
            c, r = s.t["sph_center"][row], s.t["sph_radius"][row]
            oc = ro - c
            a = dot(rd, rd)
            hb = dot(oc, rd)
            disc = hb * hb - a * (dot(oc, oc) - r * r)
            sq = safe_sqrt(disc)
            ok = disc >= 0.0
            cands += [((-hb - sq) / a, ok), ((-hb + sq) / a, ok)]
        for row in med["quad_rows"]:
            n = qf["normal"][row]
            denom = dot(rd, n)
            okd = torch.abs(denom) >= 1e-8
            t = torch.where(okd, (qf["D"][row] - dot(ro, n))
                            / torch.where(okd, denom, 1.0), -1.0)
            al = dot(ro, qf["vxw"][row]) + t * dot(rd, qf["vxw"][row]) \
                - qf["qa"][row]
            be = dot(ro, qf["wxu"][row]) + t * dot(rd, qf["wxu"][row]) \
                - qf["qb"][row]
            cands.append((t, okd & (al >= 0) & (al <= 1) & (be >= 0)
                          & (be <= 1)))
        t1 = None
        for t, ok in cands:
            c = torch.where(ok, t, inf)
            t1 = c if t1 is None else torch.minimum(t1, c)
        t2 = None
        for t, ok in cands:
            c = torch.where(ok & (t > t1 + MEDIUM_EPS), t, inf)
            t2 = c if t2 is None else torch.minimum(t2, c)
        rec1 = torch.clamp(t1, min=T_MIN)
        rec2 = torch.minimum(t2, best_t)
        ok = torch.isfinite(t1) & torch.isfinite(t2) & (rec1 < rec2)
        rec1 = torch.clamp(rec1, min=0.0)
        length = torch.sqrt(dot(rd, rd))
        inside = (rec2 - rec1) * length
        hit_dist = s.t["med_neg_inv_density"][m] * torch.log(
            torch.clamp(um[m], min=1e-37))
        accept = ok & (hit_dist <= inside)
        best_t = torch.where(accept, rec1 + hit_dist / length, best_t)
        kind = torch.where(accept, K_MEDIUM0 + m, kind)
        idx = torch.where(accept, m, idx)
    return best_t, kind, idx


# ---------------------------------------------------------------------------
# Textures, lights and shading
# ---------------------------------------------------------------------------

def _base_texture(s: Scene, tid, u, v, p):
    kinds = torch.tensor(s.meta["tex_kind"], device=p.device)[tid]
    out = s.t["tex_color"][tid]
    for img_id, im in enumerate(s.t["images"]):
        H, W = im.shape[0], im.shape[1]
        i = torch.clamp((torch.clamp(u, 0.0, 1.0) * W).to(torch.int64),
                        0, W - 1)
        j = torch.clamp(((1.0 - torch.clamp(v, 0.0, 1.0)) * H)
                        .to(torch.int64), 0, H - 1)
        pick = (kinds == TEX_IMAGE) & (s.t["tex_image_id"][tid] == img_id)
        out = sel(pick, im[j, i], out)
    for nid in range(int(s.meta["n_noise"])):
        scale = s.t["tex_noise_scale"][tid]
        val = marble(scale[:, None] * p, nid)
        pick = (kinds == TEX_NOISE) & (s.t["tex_image_id"][tid] == nid)
        out = sel(pick, val[:, None].expand_as(out), out)
    return out


def texture(s: Scene, tid, u, v, p):
    """A texture's value at p with one checker level (textures.cuh)."""
    kinds = torch.tensor(s.meta["tex_kind"], device=p.device)[tid]
    if TEX_CHECKER in s.meta["tex_kind"]:
        g = torch.floor(s.t["tex_inv_scale"][tid][:, None] * p).to(torch.int64)
        even = torch.remainder(g[:, 0] + g[:, 1] + g[:, 2], 2) == 0
        child = torch.where(even, s.t["tex_child_even"][tid],
                            s.t["tex_child_odd"][tid])
        tid = torch.where(kinds == TEX_CHECKER, child, tid)
    return _base_texture(s, tid, u, v, p)


def _light_sample(s, qf, light, p, u1, u2):
    row = light["row"]
    if light["kind"] == OBJ_SPHERE:
        c, r = s.t["sph_center"][row], s.t["sph_radius"][row]
        d = c - p
        z = 1.0 + u2 * (safe_sqrt(1.0 - r * r / dot(d, d)) - 1.0)
        phi = 2.0 * PI * u1
        st = safe_sqrt(1.0 - z * z)
        bu, bv, bw = onb(d)
        return local(bu, bv, bw, torch.stack(
            [torch.cos(phi) * st, torch.sin(phi) * st, z], -1))
    Q, qu, qv = (s.t[k][row] for k in ("quad_Q", "quad_u", "quad_v"))
    return (Q + u1[:, None] * qu + u2[:, None] * qv) - p


def _light_pdf(s, qf, light, p, d):
    row = light["row"]
    if light["kind"] == OBJ_SPHERE:
        c, r = s.t["sph_center"][row], s.t["sph_radius"][row]
        oc = p - c
        a = torch.clamp(dot(d, d), min=1e-20)
        hb = dot(oc, d)
        disc = hb * hb - a * (dot(oc, oc) - r * r)
        sq = safe_sqrt(disc)
        r1, r2 = (-hb - sq) / a, (-hb + sq) / a
        root = torch.where(r1 > T_MIN, r1, r2)
        hits = (disc >= 0.0) & (root > T_MIN)
        cmax = safe_sqrt(1.0 - r * r / dot(c - p, c - p))
        solid = torch.clamp(2.0 * PI * (1.0 - cmax), min=1e-12)
        return torch.where(hits, 1.0 / solid, 0.0)
    n, vxw, wxu = qf["normal"][row], qf["vxw"][row], qf["wxu"][row]
    denom = dot(d, n)
    okd = torch.abs(denom) >= 1e-8
    t = torch.where(okd, (qf["D"][row] - dot(p, n))
                    / torch.where(okd, denom, 1.0), -1.0)
    al = dot(p, vxw) + t * dot(d, vxw) - qf["qa"][row]
    be = dot(p, wxu) + t * dot(d, wxu) - qf["qb"][row]
    hits = okd & (t > T_MIN) & (al >= 0) & (al <= 1) & (be >= 0) & (be <= 1)
    ts = torch.where(hits, t, 1.0)
    ds = torch.where(hits, denom, 1.0)
    dist_sq = ts * ts * dot(d, d)
    cosine = torch.abs(ds) / torch.clamp(torch.sqrt(dot(d, d)), min=1e-10)
    return torch.where(hits, dist_sq / (cosine * qf["area"][row]), 0.0)


def _shade(s: Scene, qf: dict, ro, rd, tm, best_t, kind, idx, seed, pixel,
           sample, bounce):
    """(hit, p, emission, weight, new direction, scatter, skip pdf) of one
    bounce (materials.cuh, pdf.cuh, camera.cuh:96-159)."""
    meta = s.meta
    dev, dt = ro.device, s.dtype
    hit = kind != K_NONE
    is_sph, is_quad = kind == K_SPHERE, kind == K_QUAD
    is_med = kind >= K_MEDIUM0
    t = torch.where(hit, best_t, 1.0)
    p = ro + rd * t[:, None]

    si = idx.clamp(0, s.t["sph_center"].shape[0] - 1)
    qi = idx.clamp(0, s.t["quad_Q"].shape[0] - 1)
    c = s.t["sph_center"][si]
    if meta["any_moving"]:
        c = c + s.t["sph_cvec"][si] * tm[:, None]
    r = s.t["sph_radius"][si]
    outward = (p - c) / torch.where(is_sph & (r != 0.0), r, 1.0)[:, None]
    n_raw = sel(is_sph, outward, qf["normal"][qi])
    front = dot(rd, n_raw) < 0.0
    normal = sel(front, n_raw, -n_raw)
    x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=dt, device=dev)
    normal = sel(is_med, x_axis.expand_as(normal), normal)
    front = front | is_med

    med_mat = torch.tensor([m["mat_row"] for m in meta["media"]] or [0],
                           device=dev)
    mat = torch.where(is_quad, s.t["quad_mat"][qi], s.t["sph_mat"][si])
    mat = torch.where(is_med, med_mat[(kind - K_MEDIUM0).clamp(
        0, len(med_mat) - 1)], mat)
    mkind = torch.tensor(meta["mat_kind"], device=dev)[mat]

    zero = torch.zeros_like(t)
    uu = vv = zero
    if meta["n_images"]:
        theta = torch.acos(torch.clamp(-outward[:, 1], -UV_CLAMP, UV_CLAMP))
        phi = torch.atan2(-outward[:, 2], outward[:, 0]) + PI
        al = dot(p, qf["vxw"][qi]) - qf["qa"][qi]
        be = dot(p, qf["wxu"][qi]) - qf["qb"][qi]
        uu = torch.where(is_quad, al, torch.where(is_sph, phi / (2.0 * PI),
                                                  zero))
        vv = torch.where(is_quad, be, torch.where(is_sph, theta / PI, zero))

    mix_u, pick_u, diel_u, _ = uniforms(seed, pixel, sample, 1 + bounce,
                                        SLOT_MIX, dt)
    m1, m2, _, _ = uniforms(seed, pixel, sample, 1 + bounce, SLOT_MAT_DIR, dt)
    f1, f2, _, _ = uniforms(seed, pixel, sample, 1 + bounce, SLOT_FUZZ, dt)

    is_metal, is_diel = mkind == MAT_METAL, mkind == MAT_DIELECTRIC
    is_iso, is_light = mkind == MAT_ISOTROPIC, mkind == MAT_DIFFUSE_LIGHT
    tex = texture(s, s.t["mat_tex"][mat], uu, vv, p)
    atten = sel(is_metal, s.t["mat_albedo"][mat], tex)
    atten = sel(is_diel, torch.ones_like(atten), atten)
    emission = sel(is_light & front, tex, torch.zeros_like(tex))

    skip_pdf = is_metal | is_diel
    scatter = ~is_light

    # metal
    fuzz = s.t["mat_fuzz"][mat]
    metal_dir = unit(reflect(rd, normal)) + sphere_dir(f1, f2) * fuzz[:, None]
    # glass
    ior = torch.where(is_diel, s.t["mat_ior"][mat], 1.0)
    gx = torch.tensor([1.0, 0.0, 0.0], dtype=dt, device=dev).expand_as(rd)
    dn = sel(is_diel, normal, gx)
    ratio = torch.where(front, 1.0 / ior, ior)
    ud = unit(sel(is_diel, rd, -gx))
    cos_t = torch.clamp(dot(-ud, dn), max=1.0)
    sin_t = safe_sqrt(1.0 - cos_t * cos_t)
    refl = (ratio * sin_t > 1.0) | (schlick(cos_t, ratio) > diel_u)
    glass_dir = sel(refl, reflect(ud, dn), refract(ud, dn, ratio))
    skip_dir = sel(is_metal, metal_dir, sel(is_diel, glass_dir, gx))

    # diffuse: cosine or sphere direction, mixed 50/50 with the lights
    bu, bv, bw = onb(normal)
    mat_dir = sel(is_iso, sphere_dir(m1, m2),
                  local(bu, bv, bw, cosine_dir(m1, m2)))
    lights = meta["lights"]
    if lights:
        l1, l2, _, _ = uniforms(seed, pixel, sample, 1 + bounce,
                                SLOT_LIGHT_DIR, dt)
        n_l = len(lights)
        pick = torch.clamp((pick_u * n_l).to(torch.int64), max=n_l - 1)
        light_dir = None
        for k, light in enumerate(lights):
            d = _light_sample(s, qf, light, p, l1, l2)
            light_dir = d if light_dir is None else sel(pick == k, d,
                                                        light_dir)
        gen_dir = sel(mix_u < 0.5, light_dir, mat_dir)
        light_pdf = sum(_light_pdf(s, qf, light, p, gen_dir)
                        for light in lights) / n_l
    else:
        gen_dir = mat_dir
    cos_c = dot(unit(gen_dir), bw) / PI
    mat_pdf = torch.where(is_iso, INV_4PI, torch.clamp(cos_c, min=0.0))
    pdf = 0.5 * light_pdf + 0.5 * mat_pdf if lights else mat_pdf
    spdf = torch.where(is_iso, INV_4PI, torch.where(cos_c < 0.0, 0.0, cos_c))
    ratio_w = torch.where(pdf > 0.0, spdf / torch.where(pdf > 0, pdf, 1.0),
                          0.0)
    weight = sel(skip_pdf, atten, atten * ratio_w[:, None])
    new_dir = sel(skip_pdf, skip_dir, gen_dir)
    return hit, p, emission, weight, new_dir, scatter, skip_pdf


# ---------------------------------------------------------------------------
# Paths
# ---------------------------------------------------------------------------

def trace(s: Scene, cam: Cam, seed, pixel, sample, differentiable=False,
          hit_counts=None, full_depth=False):
    """Radiance [N, 3] of the camera paths (pixel, sample) (int64 [N]).

    ``hit_counts``: a list that gets, for every bounce, the number of
    rays whose closest surface hit was a sphere and a quad, dead paths'
    rays included, as the program's lockstep route scans every lane.
    ``full_depth`` (and ``differentiable``) run all ``bounce_limit``
    bounces, as that route does, rather than stop when no path is
    alive."""
    qf = quad_frames(s)
    ro, rd, tm = camera_rays(cam, seed, pixel, sample, s.dtype)
    N = pixel.shape[0]
    dev = pixel.device
    L = torch.zeros((N, 3), dtype=s.dtype, device=dev)
    beta = torch.ones((N, 3), dtype=s.dtype, device=dev)
    alive = torch.ones(N, dtype=torch.bool, device=dev)
    bg = cam.background
    for bounce in range(cam.depth):
        if not (differentiable or full_depth) and not bool(alive.any()):
            break
        with torch.no_grad():
            best_t, kind, idx = _scan(s, qf, ro.detach(), rd.detach(),
                                      tm.detach())
        if hit_counts is not None:
            hit_counts.append((int((kind == K_SPHERE).sum()),
                               int((kind == K_QUAD).sum())))
        if differentiable:
            best_t = _winner_t(s, qf, ro, rd, tm, kind, idx)
        best_t, kind, idx = _media(s, qf, ro, rd, seed, pixel, sample, bounce,
                                   best_t, kind, idx)
        hit, p, em, w, nd, scatter, skip = _shade(
            s, qf, ro, rd, tm, best_t, kind, idx, seed, pixel, sample, bounce)
        miss = alive & ~hit
        stop = alive & hit & ~scatter
        cont = alive & hit & scatter
        L = L + sel(miss, beta * bg, 0.0)
        L = L + sel(stop, beta * em, 0.0)
        L = L + sel(cont & ~skip, beta * em, 0.0)
        beta = sel(cont, beta * w, beta)
        ro = sel(cont, p, ro)
        rd = sel(cont, nd, rd)
        alive = cont
    return L


def pixels(s: Scene, cam: Cam, seed, pixel_ids, samples, block=1 << 18):
    """Mean radiance of ``samples`` (a range of sample ids) at each of
    ``pixel_ids`` [K], as float32 [K, 3] on the host; a pixel with a NaN
    sample reads 0.  Paths are traced in blocks of at most ``block``."""
    pixel_ids = torch.as_tensor(pixel_ids, dtype=torch.int64,
                                device=s.device)
    K = pixel_ids.shape[0]
    samples = list(samples)
    n = len(samples)
    spp = cam.sqrt_spp * cam.sqrt_spp
    pix = pixel_ids.repeat_interleave(n)
    smp = torch.tensor(samples, dtype=torch.int64,
                       device=s.device).repeat(K)
    out = torch.zeros((K * n, 3), dtype=torch.float32, device=s.device)
    with torch.no_grad():
        for b0 in range(0, K * n, block):
            sl = slice(b0, min(b0 + block, K * n))
            out[sl] = trace(s, cam, seed, pix[sl], smp[sl]).float()
    acc = (out * (1.0 / spp)).reshape(K, n, 3).sum(dim=1)
    acc = torch.where(torch.isnan(acc), 0.0, acc)
    return acc.cpu().numpy()
