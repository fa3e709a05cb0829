"""Host-side scene construction and compilation to flat tensors.

The port of ``mort_tpu.scene.build``: the builder logic is the same numpy
code (the JAX package cannot be imported where the port runs — it imports
jax), and only the output changes: ``SceneData`` is a dataclass of torch
tensors with a ``.to(device)`` method.  ``scene_from_numpy`` carries the
JAX package's compiled leaves and meta across, so both packages can render
the very same scene.

Mirrors the behaviour of the reference's ``world`` registry
(world.cuh:16-179):

* Objects/materials/textures are appended to host registries through a
  builder API, then :meth:`World.compile` lowers everything to a
  ``SceneData`` of flat struct-of-arrays (the analogue of the
  ``__constant__`` device registries, objects.cuh:746-765) plus a static,
  hashable ``SceneMeta``.

* ``translate`` / ``rotate_y`` instancing wrappers (objects.cuh:252-376) are
  **baked into the leaf primitives at compile time**: a rigid motion of a
  sphere is a sphere and of a quad is a quad, so the device never performs
  per-ray transform dispatch.  This matches the reference semantics exactly
  (hit points/normals transform the same way) while keeping the hot loop a
  pure batched primitive test.

* ``skip`` flags and ``hittable_list`` reachability (world.cuh:105-171: the
  world hit loop tests non-skip objects of each registry plus the members of
  non-skip lists) are resolved at compile time into a single active leaf set.

Differentiable leaves of ``SceneData``: sphere centers/radii, quad Q/u/v,
material albedo/fuzz/ior, texture colors — the BASELINE north-star gradient
targets.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from .. import rng as rngm

from .types import (
    MAT_DIELECTRIC, MAT_DIFFUSE_LIGHT, MAT_ISOTROPIC, MAT_LAMBERTIAN,
    MAT_METAL, OBJ_BVH, OBJ_CONSTANT_MEDIUM, OBJ_HITTABLE_LIST, OBJ_QUAD,
    OBJ_ROTATE_Y, OBJ_SPHERE, OBJ_TRANSLATE, TEX_CHECKER, TEX_IMAGE,
    TEX_NOISE, TEX_SOLID, MatH, ObjH, TexH,
)


# ---------------------------------------------------------------------------
# Compiled scene tensors
# ---------------------------------------------------------------------------

@dataclass
class SceneData:
    """Flat scene tensors (the analogue of the reference's __constant__
    scene upload, objects.cuh:848-856).  Integer rows are int32, flags
    bool, everything else float32 — the JAX package's leaf dtypes, except
    ``images_packed``, which is int32 here (torch has few uint32 kernels;
    the packed values are below 2^24, so they are the same numbers)."""
    # Spheres (world-space, transforms baked).
    sph_center: torch.Tensor      # [Ns,3] f32
    sph_cvec: torch.Tensor        # [Ns,3] f32 motion-blur displacement
    sph_radius: torch.Tensor      # [Ns]   f32
    sph_mat: torch.Tensor         # [Ns]   i32 global material row
    sph_surface: torch.Tensor     # [Ns]   bool: in the world hit loop
    # Quads.
    quad_Q: torch.Tensor          # [Nq,3]
    quad_u: torch.Tensor          # [Nq,3]
    quad_v: torch.Tensor          # [Nq,3]
    quad_mat: torch.Tensor        # [Nq]   i32
    quad_surface: torch.Tensor    # [Nq]   bool
    # Materials (global table; kind tags live in SceneMeta).
    mat_tex: torch.Tensor         # [M] i32 texture row
    mat_albedo: torch.Tensor      # [M,3] metal / dielectric albedo
    mat_fuzz: torch.Tensor        # [M]
    mat_ior: torch.Tensor         # [M]
    # Textures.
    tex_color: torch.Tensor       # [T,3] solid color
    tex_inv_scale: torch.Tensor   # [T]   checker inverse scale
    tex_child_even: torch.Tensor  # [T] i32
    tex_child_odd: torch.Tensor   # [T] i32
    tex_noise_scale: torch.Tensor  # [T]
    tex_image_id: torch.Tensor    # [T] i32
    # Image data: tuple of [H,W,3] f32 in [0,1].
    images: tuple
    # Same texels packed (r<<16 | g<<8 | b) as [H,W] int32.
    images_packed: tuple
    # Constant media.
    med_neg_inv_density: torch.Tensor  # [Nm]

    def replace(self, **kw) -> "SceneData":
        """A copy with the given fields replaced."""
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "SceneData":
        """A copy with every tensor on ``device``."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            out[f.name] = (tuple(x.to(device) for x in v)
                           if isinstance(v, tuple) else v.to(device))
        return SceneData(**out)


@dataclass(frozen=True)
class MediumMeta:
    """Static description of one constant_medium (objects.cuh:378-449):
    boundary leaf rows (world-space baked) + phase-function material row."""
    sphere_rows: tuple
    quad_rows: tuple
    mat_row: int


@dataclass(frozen=True)
class LightMeta:
    """One importance-sampled light: a sphere or quad row (pdf.cuh:60-80)."""
    kind: int   # OBJ_SPHERE or OBJ_QUAD
    row: int


@dataclass(frozen=True)
class SceneMeta:
    """Static (hashable) scene structure: what the renderer branches on
    in Python, as opposed to the tensors of ``SceneData``."""
    n_spheres: int
    n_quads: int
    any_moving: bool
    mat_kind: tuple          # len M, values MAT_*
    tex_kind: tuple          # len T, values TEX_*
    n_images: int
    n_noise: int
    media: tuple             # tuple[MediumMeta]
    lights: tuple            # tuple[LightMeta]; empty = no light sampling
    use_bvh: bool            # reference bvh_mode (world.cuh:118-120)
    n_bvh_leaf_spheres: int  # spheres covered by BVHs (skipped in brute loop)
    # Per-quad axis-orientation class (len n_quads): u_axis*3 + v_axis for
    # surface quads whose u and v each lie exactly along one (distinct)
    # coordinate axis — the box/wall quads every reference scene is mostly
    # built from — else 9 (general orientation / non-surface).  The JAX
    # package's kernel routes axis-aligned quads through a fast path on it;
    # the port carries it unchanged for parity (and for that later path).
    # Class -2 marks quads covered by a closed axis-aligned box (``aab``),
    # tested as one slab test instead of six window tests.
    aaq_class: tuple = ()
    # Closed axis-aligned boxes detected at compile (the box() builder's six
    # quads, utils.h:51-67): per box, the quad-table rows of its six faces in
    # (lo_x, hi_x, lo_y, hi_y, lo_z, hi_z) order.  A slab test over
    # [lo, hi] is exactly the per-face quad test union for a closed box
    # (the winning face is the entry — or, for origins inside, exit — slab).
    aab: tuple = ()
    # Per-image flag: True when 8-bit packing round-trips the texels
    # bit-exactly (u8-sourced images — the reference's stb pipeline).  Float
    # or HDR images supplied through World.images get False and are sampled
    # from the f32 arrays instead of being silently quantized.
    images_u8_exact: tuple = ()


# ---------------------------------------------------------------------------
# Host registries
# ---------------------------------------------------------------------------

@dataclass
class _Sphere:
    center1: np.ndarray
    center_vec: np.ndarray
    radius: float
    mat: int
    moves: bool
    skip: bool


@dataclass
class _Quad:
    Q: np.ndarray
    u: np.ndarray
    v: np.ndarray
    mat: int
    skip: bool


@dataclass
class _Translate:
    child: ObjH
    offset: np.ndarray
    skip: bool


@dataclass
class _RotateY:
    child: ObjH
    theta_deg: float
    skip: bool


@dataclass
class _Medium:
    child: ObjH
    density: float
    mat: int
    skip: bool


@dataclass
class _List:
    members: list
    skip: bool


@dataclass
class _BVH:
    source: ObjH   # hittable_list handle
    skip: bool


def _v3(x):
    a = np.asarray(x, np.float32)
    assert a.shape == (3,)
    return a


class World:
    """Host-side scene registry; the analogue of world.cuh:16-102."""

    def __init__(self):
        self.spheres: list[_Sphere] = []
        self.quads: list[_Quad] = []
        self.translates: list[_Translate] = []
        self.rotates: list[_RotateY] = []
        self.media: list[_Medium] = []
        self.lists: list[_List] = []
        self.bvhs: list[_BVH] = []
        # Global material/texture tables.
        self.mat_kind: list[int] = []
        self.mat_tex: list[int] = []
        self.mat_albedo: list[np.ndarray] = []
        self.mat_fuzz: list[float] = []
        self.mat_ior: list[float] = []
        self.tex_kind: list[int] = []
        self.tex_color: list[np.ndarray] = []
        self.tex_inv_scale: list[float] = []
        self.tex_child_even: list[int] = []
        self.tex_child_odd: list[int] = []
        self.tex_noise_scale: list[float] = []
        self.tex_image_id: list[int] = []
        self.images: list[np.ndarray] = []
        self.n_noise_tex = 0
        self.light: Optional[ObjH] = None

    # -- textures (textures.cuh) ------------------------------------------
    def _new_tex(self, kind) -> TexH:
        row = len(self.tex_kind)
        self.tex_kind.append(kind)
        self.tex_color.append(np.zeros(3, np.float32))
        self.tex_inv_scale.append(0.0)
        self.tex_child_even.append(0)
        self.tex_child_odd.append(0)
        self.tex_noise_scale.append(0.0)
        self.tex_image_id.append(0)
        return TexH(kind, row)

    def solid_color(self, c) -> TexH:
        h = self._new_tex(TEX_SOLID)
        self.tex_color[h.row] = _v3(c)
        return h

    def checker(self, scale: float, even: TexH, odd: TexH) -> TexH:
        # Reference checker dispatches to arbitrary child textures
        # (textures.cuh:52-60); nesting checker-in-checker is unsupported here
        # (unused by every scene) and rejected at build time.
        assert self.tex_kind[even.row] != TEX_CHECKER
        assert self.tex_kind[odd.row] != TEX_CHECKER
        h = self._new_tex(TEX_CHECKER)
        self.tex_inv_scale[h.row] = 1.0 / scale
        self.tex_child_even[h.row] = even.row
        self.tex_child_odd[h.row] = odd.row
        return h

    def image_texture(self, image: np.ndarray) -> TexH:
        """image: [H,W,3] uint8 or float in [0,1] (img_loader.h semantics)."""
        img = np.asarray(image)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        h = self._new_tex(TEX_IMAGE)
        self.tex_image_id[h.row] = len(self.images)
        self.images.append(img.astype(np.float32))
        return h

    def noise_texture(self, scale: float, rng: Optional[np.random.RandomState] = None) -> TexH:
        """Perlin noise texture (textures.cuh:158-266 semantics).  Lattice
        randomness is a computed hash (render/textures.py) instead of the
        reference's gathered permutation tables — table gathers have no
        fast path on TPU; ``rng`` is accepted for API compatibility and
        unused."""
        h = self._new_tex(TEX_NOISE)
        self.tex_noise_scale[h.row] = scale
        self.tex_image_id[h.row] = self.n_noise_tex
        self.n_noise_tex += 1
        return h

    # -- materials (materials.cuh) ----------------------------------------
    def _new_mat(self, kind) -> MatH:
        row = len(self.mat_kind)
        self.mat_kind.append(kind)
        self.mat_tex.append(0)
        self.mat_albedo.append(np.ones(3, np.float32))
        self.mat_fuzz.append(0.0)
        self.mat_ior.append(1.0)
        return MatH(kind, row)

    def lambertian(self, tex: TexH) -> MatH:
        h = self._new_mat(MAT_LAMBERTIAN)
        self.mat_tex[h.row] = tex.row
        return h

    def metal(self, albedo, fuzz: float) -> MatH:
        h = self._new_mat(MAT_METAL)
        self.mat_albedo[h.row] = _v3(albedo)
        self.mat_fuzz[h.row] = float(fuzz)
        return h

    def dielectric(self, ior: float, albedo=(1.0, 1.0, 1.0)) -> MatH:
        # Reference stores an albedo but scatter hard-codes white
        # (materials.cuh:98,109); we keep the stored value for parity but the
        # shader uses white, matching behaviour.
        h = self._new_mat(MAT_DIELECTRIC)
        self.mat_ior[h.row] = float(ior)
        self.mat_albedo[h.row] = _v3(albedo)
        return h

    def diffuse_light(self, tex: TexH) -> MatH:
        h = self._new_mat(MAT_DIFFUSE_LIGHT)
        self.mat_tex[h.row] = tex.row
        return h

    def isotropic(self, tex: TexH) -> MatH:
        h = self._new_mat(MAT_ISOTROPIC)
        self.mat_tex[h.row] = tex.row
        return h

    # -- objects (objects.cuh) --------------------------------------------
    def sphere(self, center, radius: float, mat: MatH, center2=None, skip=False) -> ObjH:
        c1 = _v3(center)
        moves = center2 is not None
        cvec = _v3(center2) - c1 if moves else np.zeros(3, np.float32)
        self.spheres.append(_Sphere(c1, cvec, float(radius), mat.row, moves, skip))
        return ObjH(OBJ_SPHERE, len(self.spheres) - 1)

    def quad(self, Q, u, v, mat: MatH, skip=False) -> ObjH:
        self.quads.append(_Quad(_v3(Q), _v3(u), _v3(v), mat.row, skip))
        return ObjH(OBJ_QUAD, len(self.quads) - 1)

    def translate(self, child: ObjH, offset, skip=False) -> ObjH:
        self.translates.append(_Translate(child, _v3(offset), skip))
        return ObjH(OBJ_TRANSLATE, len(self.translates) - 1)

    def rotate_y(self, child: ObjH, theta_deg: float, skip=False) -> ObjH:
        self.rotates.append(_RotateY(child, float(theta_deg), skip))
        return ObjH(OBJ_ROTATE_Y, len(self.rotates) - 1)

    def constant_medium(self, child: ObjH, density: float, mat: MatH, skip=False) -> ObjH:
        self.media.append(_Medium(child, float(density), mat.row, skip))
        return ObjH(OBJ_CONSTANT_MEDIUM, len(self.media) - 1)

    def hittable_list(self, members: Sequence[ObjH] = (), skip=False) -> ObjH:
        self.lists.append(_List(list(members), skip))
        return ObjH(OBJ_HITTABLE_LIST, len(self.lists) - 1)

    def list_add(self, lst: ObjH, member: ObjH):
        self.lists[lst.idx].members.append(member)

    def bvh(self, source_list: ObjH, skip=False) -> ObjH:
        assert source_list.kind == OBJ_HITTABLE_LIST
        self.bvhs.append(_BVH(source_list, skip))
        return ObjH(OBJ_BVH, len(self.bvhs) - 1)

    # -- convenience builders (utils.h:51-126) ----------------------------
    def box(self, a, b, mat: MatH, skip=False):
        """Six quads forming an axis-aligned box (utils.h:51-67)."""
        a, b = _v3(a), _v3(b)
        mn, mx = np.minimum(a, b), np.maximum(a, b)
        dx = np.array([mx[0] - mn[0], 0, 0], np.float32)
        dy = np.array([0, mx[1] - mn[1], 0], np.float32)
        dz = np.array([0, 0, mx[2] - mn[2]], np.float32)
        return [
            self.quad([mn[0], mn[1], mx[2]], dx, dy, mat, skip),    # front
            self.quad([mx[0], mn[1], mx[2]], -dz, dy, mat, skip),   # right
            self.quad([mx[0], mn[1], mn[2]], -dx, dy, mat, skip),   # back
            self.quad([mn[0], mn[1], mn[2]], dz, dy, mat, skip),    # left
            self.quad([mn[0], mx[1], mx[2]], dx, -dz, mat, skip),   # top
            self.quad([mn[0], mn[1], mn[2]], dx, dz, mat, skip),    # bottom
        ]

    def rotated_box(self, size, translation, theta_deg, mat: MatH) -> ObjH:
        """rotate_y + translate of a box at the origin (utils.h:69-96)."""
        sides = self.box([0, 0, 0], size, mat, skip=True)
        lst = self.hittable_list(sides, skip=True)
        rot = self.rotate_y(lst, theta_deg, skip=True)
        return self.translate(rot, translation)

    def rotated_smoke_box(self, size, translation, theta_deg, density, mat: MatH) -> ObjH:
        """rotated box wrapped in a constant_medium (utils.h:98-126)."""
        sides = self.box([0, 0, 0], size, mat, skip=True)
        lst = self.hittable_list(sides, skip=True)
        rot = self.rotate_y(lst, theta_deg, skip=True)
        tr = self.translate(rot, translation, skip=True)
        return self.constant_medium(tr, density, mat)

    # ------------------------------------------------------------------
    # Compilation
    # ------------------------------------------------------------------
    def compile(self) -> tuple[SceneData, SceneMeta]:
        return _compile_world(self)


# ---------------------------------------------------------------------------
# Flattening
# ---------------------------------------------------------------------------

_IDENT = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))


def _roty(theta_deg: float) -> np.ndarray:
    r = np.deg2rad(np.float64(theta_deg))
    c, s = np.cos(r), np.sin(r)
    # world_from_object rotation used by rotate_y.hit when mapping the hit
    # point back to world space (objects.cuh:352-360).
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


class _Flattener:
    def __init__(self, world: World):
        self.w = world
        self.out_spheres: list = []   # rows of (center, cvec, radius, mat, moves)
        self.out_quads: list = []
        self.sph_surface: list = []   # per-row: hittable in the world loop?
        self.quad_surface: list = []
        # identity-transform dedupe: host (kind, idx) -> output row
        self.ident_rows: dict = {}
        self.media_meta: list = []
        self.bvh_leaf_sets: list = []   # list of [(kind,row)] per bvh

    def add_sphere(self, s: _Sphere, R, t, ident: bool, surface: bool):
        key = (OBJ_SPHERE, id(s))
        if ident and key in self.ident_rows:
            row = self.ident_rows[key]
            self.sph_surface[row] = self.sph_surface[row] or surface
            return row
        row = len(self.out_spheres)
        self.out_spheres.append((R @ s.center1 + t, R @ s.center_vec, s.radius, s.mat, s.moves))
        self.sph_surface.append(surface)
        if ident:
            self.ident_rows[key] = row
        return row

    def add_quad(self, q: _Quad, R, t, ident: bool, surface: bool):
        key = (OBJ_QUAD, id(q))
        if ident and key in self.ident_rows:
            row = self.ident_rows[key]
            self.quad_surface[row] = self.quad_surface[row] or surface
            return row
        row = len(self.out_quads)
        self.out_quads.append((R @ q.Q + t, R @ q.u, R @ q.v, q.mat))
        self.quad_surface.append(surface)
        if ident:
            self.ident_rows[key] = row
        return row

    def resolve(self, h: ObjH, R, t, ident: bool, out_leaves: Optional[list] = None,
                surface: bool = True):
        """Resolve an object handle into world-space leaf primitives."""
        w = self.w
        if h.kind == OBJ_SPHERE:
            row = self.add_sphere(w.spheres[h.idx], R, t, ident, surface)
            if out_leaves is not None:
                out_leaves.append((OBJ_SPHERE, row))
        elif h.kind == OBJ_QUAD:
            row = self.add_quad(w.quads[h.idx], R, t, ident, surface)
            if out_leaves is not None:
                out_leaves.append((OBJ_QUAD, row))
        elif h.kind == OBJ_TRANSLATE:
            tr = w.translates[h.idx]
            self.resolve(tr.child, R, t + R @ tr.offset, False, out_leaves, surface)
        elif h.kind == OBJ_ROTATE_Y:
            ro = w.rotates[h.idx]
            self.resolve(ro.child, R @ _roty(ro.theta_deg), t, False, out_leaves, surface)
        elif h.kind == OBJ_HITTABLE_LIST:
            for m in w.lists[h.idx].members:
                self.resolve(m, R, t, ident, out_leaves, surface)
        elif h.kind == OBJ_CONSTANT_MEDIUM:
            med = w.media[h.idx]
            # Boundary prims are *not* themselves hittable through the medium
            # (reference: skip-flagged boundary objects are only reached via
            # hitDispatch inside constant_medium::hit, objects.cuh:400-404).
            leaves: list = []
            self.resolve(med.child, R, t, ident, leaves, surface=False)
            self.media_meta.append((
                tuple(r for k, r in leaves if k == OBJ_SPHERE),
                tuple(r for k, r in leaves if k == OBJ_QUAD),
                med.mat,
                med.density,
            ))
        elif h.kind == OBJ_BVH:
            src = w.bvhs[h.idx].source
            leaves = []
            self.resolve(src, R, t, ident, leaves, surface)
            self.bvh_leaf_sets.append(leaves)
            if out_leaves is not None:
                out_leaves.extend(leaves)
        else:
            raise ValueError(f"unknown object kind {h.kind}")


def _detect_aab(out_quads, aaq_class):
    """Detect closed axis-aligned boxes among the axis-aligned surface quads.

    A box is six faces whose planes/windows tile [lo, hi] — the structure
    the box() builder emits (utils.h:51-67).  Plane coordinates (Q[k]) are
    construction-exact, but window ends are float roundtrips (Q[a] + u[a]),
    so each window end is snapped to the nearest perpendicular plane
    coordinate before exact-equality grouping.  Covered rows are marked
    aaq_class -2 in place; returns a tuple of per-box 6-tuples of quad rows
    in (lo_x, hi_x, lo_y, hi_y, lo_z, hi_z) face order.
    """
    faces = []    # (row, k, d, ext) with ext the per-axis window intervals
    plane_coords = [[], [], []]
    for row, c in enumerate(aaq_class):
        if not (0 <= c <= 8):
            continue
        u_ax, v_ax = c // 3, c % 3
        k = 3 - u_ax - v_ax
        Q, u, v = out_quads[row][0], out_quads[row][1], out_quads[row][2]
        ext = [None, None, None]
        mag = [0.0, 0.0, 0.0]
        ext[k] = float(Q[k])
        for a, vec in ((u_ax, u), (v_ax, v)):
            ext[a] = tuple(sorted((float(Q[a]), float(Q[a] + vec[a]))))
            # The window-end sum Q[a] + vec[a] carries roundoff at the scale
            # of its OPERANDS (lo + (hi - lo) near zero cancels ~|lo|-sized
            # terms), so the snap tolerance must scale with them.
            mag[a] = max(abs(float(Q[a])), abs(float(vec[a])),
                         abs(float(Q[a] + vec[a])))
        faces.append((row, k, float(Q[k]), ext, mag))
        plane_coords[k].append(float(Q[k]))

    coords = [np.unique(np.asarray(c, np.float64)) for c in plane_coords]

    def snap(axis, w, mag):
        # Snapping exists only to absorb the f32 roundtrip error of the
        # window-end sum Q[a] + u[a] — a few ulps at the magnitude of the
        # sum's operands (``mag``), so the tolerance scales with them: a
        # deliberate sub-1e-3 gap between small near-box faces must NOT be
        # snapped closed, and sub-millimeter boxes must not be distorted.
        c = coords[axis]
        if c.size == 0:
            return w
        i = np.searchsorted(c, w)
        best = w
        tol = 8.0 * 2.0 ** -23 * max(mag, abs(w), 1e-30)
        for j in (i - 1, i):
            if 0 <= j < c.size and abs(c[j] - w) <= tol:
                best = float(c[j])
        return best

    # face_lookup[(k, w_a, w_b, d)] -> row, where a < b are the non-plane
    # axes and w_* their snapped window intervals
    face_lookup = {}
    x_pairs = {}     # (w_y, w_z) -> list of (d, row) for plane-axis-0 faces
    for row, k, d, ext, mag in faces:
        ext = [ext[a] if a == k
               else (snap(a, ext[a][0], mag[a]), snap(a, ext[a][1], mag[a]))
               for a in range(3)]
        a, b = [ax for ax in range(3) if ax != k]
        face_lookup.setdefault((k, ext[a], ext[b], d), row)
        if k == 0:
            x_pairs.setdefault((ext[1], ext[2]), []).append((d, row))

    used = set()
    boxes = []
    for (wy, wz), ds in sorted(x_pairs.items()):
        if wy[0] >= wy[1] or wz[0] >= wz[1]:
            continue
        ds = sorted(set(ds))
        for (a0, r_lo), (a1, r_hi) in zip(ds[0::2], ds[1::2]):
            if a0 >= a1 or r_lo in used or r_hi in used:
                continue
            wx = (a0, a1)
            rows = [r_lo, r_hi,
                    face_lookup.get((1, wx, wz, wy[0])),
                    face_lookup.get((1, wx, wz, wy[1])),
                    face_lookup.get((2, wx, wy, wz[0])),
                    face_lookup.get((2, wx, wy, wz[1]))]
            if any(r is None or r in used for r in rows[2:]):
                continue
            if len(set(rows)) != 6:
                continue
            used.update(rows)
            boxes.append(tuple(rows))
    for box in boxes:
        for r in box:
            aaq_class[r] = -2
    return tuple(boxes)


def _pad_rows(rows, width, pad_row, mult=8):
    n = len(rows)
    n_pad = max(mult, -(-max(n, 1) // mult) * mult)
    out = np.stack([np.asarray(r, np.float32) for r in rows] + [pad_row] * (n_pad - n)) \
        if rows else np.stack([pad_row] * n_pad)
    return out.astype(np.float32)


def _compile_world(w: World) -> tuple[SceneData, SceneMeta]:
    fl = _Flattener(w)

    # Active roots reproduce the reachability of world::hit
    # (world.cuh:105-171): when any non-skip BVH exists (bvh_mode,
    # world.cuh:118-120) ONLY the BVHs are consulted; otherwise every
    # non-skip object of each registry is hit directly, and members of
    # non-skip lists / transforms are hit through dispatch regardless of
    # their own skip flag.
    bvh_mode = any(not b.skip for b in w.bvhs)
    n_bvh_leaf_spheres = 0
    for b_i, b in enumerate(w.bvhs):
        if not b.skip:
            fl.resolve(ObjH(OBJ_BVH, b_i), *_IDENT, ident=True)
    if not bvh_mode:
        for s_i, s in enumerate(w.spheres):
            if not s.skip:
                fl.resolve(ObjH(OBJ_SPHERE, s_i), *_IDENT, ident=True)
        for q_i, q in enumerate(w.quads):
            if not q.skip:
                fl.resolve(ObjH(OBJ_QUAD, q_i), *_IDENT, ident=True)
        for t_i, t in enumerate(w.translates):
            if not t.skip:
                fl.resolve(ObjH(OBJ_TRANSLATE, t_i), *_IDENT, ident=True)
        for r_i, r in enumerate(w.rotates):
            if not r.skip:
                fl.resolve(ObjH(OBJ_ROTATE_Y, r_i), *_IDENT, ident=True)
        for l_i, l in enumerate(w.lists):
            if not l.skip:
                fl.resolve(ObjH(OBJ_HITTABLE_LIST, l_i), *_IDENT, ident=True)
        # Media resolved last so their RNG slot order matches registry order.
        for m_i, m in enumerate(w.media):
            if not m.skip:
                fl.resolve(ObjH(OBJ_CONSTANT_MEDIUM, m_i), *_IDENT, ident=True)

    # Lights: resolve the camera's light object reference to leaf rows.
    lights: list[LightMeta] = []
    if w.light is not None:
        leaves: list = []
        fl.resolve(w.light, *_IDENT, ident=True, out_leaves=leaves, surface=False)
        lights = [LightMeta(k, r) for k, r in leaves]

    # --- Morton-order the primitive rows -----------------------------------
    # The Pallas kernel culls work per contiguous 128-row sub-cluster behind
    # an AABB pre-test (pallas_intersect.cluster_boxes); sorting rows along a
    # 3D Morton curve makes those clusters spatially compact, so far more of
    # them cull.  Row order is an internal layout choice (the reference's
    # registry order only matters for closest-hit tie-breaks, which are
    # measure-zero); all row references (materials ride along; lights, media
    # boundaries, BVH leaves are remapped below).
    def _morton_perm(points):
        pts = np.asarray(points, np.float64)
        lo = pts.min(axis=0)
        ext = np.maximum(pts.max(axis=0) - lo, 1e-12)
        q = np.clip(((pts - lo) / ext) * 1023.0, 0, 1023).astype(np.uint64)

        def spread(x):
            x = (x | (x << 16)) & np.uint64(0x030000FF)
            x = (x | (x << 8)) & np.uint64(0x0300F00F)
            x = (x | (x << 4)) & np.uint64(0x030C30C3)
            x = (x | (x << 2)) & np.uint64(0x09249249)
            return x

        code = (spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1))
                | (spread(q[:, 2]) << np.uint64(2)))
        return np.argsort(code, kind="stable")

    if len(fl.out_spheres) > 1:
        perm = _morton_perm([r[0] for r in fl.out_spheres])
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm))
        fl.out_spheres = [fl.out_spheres[i] for i in perm]
        fl.sph_surface = [fl.sph_surface[i] for i in perm]
        lights = [LightMeta(l.kind, int(inv[l.row])) if l.kind == OBJ_SPHERE
                  else l for l in lights]
        fl.media_meta = [(tuple(int(inv[r]) for r in srows), qrows, m, d)
                         for srows, qrows, m, d in fl.media_meta]
        fl.bvh_leaf_sets = [[(k, int(inv[r]) if k == OBJ_SPHERE else r)
                             for k, r in leaves] for leaves in fl.bvh_leaf_sets]
    if len(fl.out_quads) > 1:
        perm = _morton_perm([r[0] + 0.5 * (r[1] + r[2]) for r in fl.out_quads])
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm))
        fl.out_quads = [fl.out_quads[i] for i in perm]
        fl.quad_surface = [fl.quad_surface[i] for i in perm]
        lights = [LightMeta(l.kind, int(inv[l.row])) if l.kind == OBJ_QUAD
                  else l for l in lights]
        fl.media_meta = [(srows, tuple(int(inv[r]) for r in qrows), m, d)
                         for srows, qrows, m, d in fl.media_meta]
        fl.bvh_leaf_sets = [[(k, int(inv[r]) if k == OBJ_QUAD else r)
                             for k, r in leaves] for leaves in fl.bvh_leaf_sets]

    ns, nq = len(fl.out_spheres), len(fl.out_quads)
    # Padding rows use benign values (masked out via sph_surface/quad_surface)
    # so no inf/NaN intermediate ever appears.
    centers = _pad_rows([r[0] for r in fl.out_spheres], 3, np.zeros(3, np.float32))
    cvecs = _pad_rows([r[1] for r in fl.out_spheres], 3, np.zeros(3, np.float32))
    radii = _pad_rows([[r[2]] for r in fl.out_spheres], 1, np.zeros(1, np.float32))[:, 0]
    sph_mat = np.array([r[3] for r in fl.out_spheres] + [0] * (len(radii) - ns), np.int32)
    sph_surface = np.array(fl.sph_surface + [False] * (len(radii) - ns), np.bool_)

    quad_Q = _pad_rows([r[0] for r in fl.out_quads], 3, np.zeros(3, np.float32))
    quad_u = _pad_rows([r[1] for r in fl.out_quads], 3, np.array([1, 0, 0], np.float32))
    quad_v = _pad_rows([r[2] for r in fl.out_quads], 3, np.array([0, 1, 0], np.float32))
    quad_mat = np.array([r[3] for r in fl.out_quads] + [0] * (len(quad_Q) - nq), np.int32)
    quad_surface = np.array(fl.quad_surface + [False] * (len(quad_Q) - nq), np.bool_)

    any_moving = any(r[4] for r in fl.out_spheres)

    # Materials / textures (pad to >=1 row).
    M = max(1, len(w.mat_kind))
    T = max(1, len(w.tex_kind))
    mat_tex = np.array((w.mat_tex + [0])[:M] if w.mat_tex else [0], np.int32)
    mat_albedo = np.stack(w.mat_albedo or [np.ones(3, np.float32)]).astype(np.float32)
    mat_fuzz = np.array(w.mat_fuzz or [0.0], np.float32)
    mat_ior = np.array(w.mat_ior or [1.0], np.float32)
    tex_color = np.stack(w.tex_color or [np.zeros(3, np.float32)]).astype(np.float32)
    tex_inv_scale = np.array(w.tex_inv_scale or [0.0], np.float32)
    tex_child_even = np.array(w.tex_child_even or [0], np.int32)
    tex_child_odd = np.array(w.tex_child_odd or [0], np.int32)
    tex_noise_scale = np.array(w.tex_noise_scale or [0.0], np.float32)
    tex_image_id = np.array(w.tex_image_id or [0], np.int32)

    # Axis-orientation class per quad (SceneMeta.aaq_class): exact-zero
    # component tests — baked rotations produce generic vectors and stay on
    # the general path; box/wall builders produce exact axis vectors.
    def _axis_of(vec):
        nz = [a for a in range(3) if float(vec[a]) != 0.0]
        return nz[0] if len(nz) == 1 else None

    aaq_class = []
    for q_i in range(nq):
        u_ax = _axis_of(fl.out_quads[q_i][1])
        v_ax = _axis_of(fl.out_quads[q_i][2])
        if (fl.quad_surface[q_i] and u_ax is not None and v_ax is not None
                and u_ax != v_ax):
            aaq_class.append(u_ax * 3 + v_ax)
        else:
            aaq_class.append(9)

    # --- closed axis-aligned boxes (SceneMeta.aab) --------------------------
    # Purely geometric detection over the axis-aligned surface quads: six
    # faces whose planes and windows tile a closed box [lo, hi] (the exact
    # structure the box() builder emits, utils.h:51-67; coordinates are
    # construction-exact floats, so equality grouping is safe).  Covered
    # rows get aaq_class -2 and are excluded from the per-face fast-path
    # tables; the kernel tests the box with one slab test instead.
    aab = _detect_aab(fl.out_quads, aaq_class)

    media_meta = tuple(MediumMeta(srows, qrows, mrow)
                       for srows, qrows, mrow, _d in fl.media_meta)
    if len(media_meta) > rngm.MAX_MEDIA:
        raise ValueError(
            f"scene has {len(media_meta)} constant media; the packed RNG "
            f"slot layout serves at most {rngm.MAX_MEDIA} (rng.SLOT_MEDIUM0: "
            f"medium m reads word m of one philox block)")
    med_nid = np.array([-1.0 / m[3] for m in fl.media_meta] or [0.0], np.float32)

    # 8-bit packing is only used when it is lossless (u8-sourced texels);
    # float/HDR images keep the f32 gather path (see SceneMeta.images_u8_exact).
    def _pack_u8(im):
        return ((np.round(np.clip(im, 0.0, 1.0) * 255.0)
                 .astype(np.uint32) << np.uint32([16, 8, 0]))
                .sum(axis=-1, dtype=np.uint32))

    def _u8_exact(im):
        q = _pack_u8(im)
        rt = np.stack([(q >> 16) & 0xFF, (q >> 8) & 0xFF, q & 0xFF],
                      axis=-1).astype(np.float32) / np.float32(255.0)
        return bool(np.array_equal(rt, np.asarray(im, np.float32)))

    # BVH reachability metadata (the build itself stays host-side; the device
    # accel is cluster culling — see the SceneData docstring note).
    if bvh_mode:
        covered = set()
        for leaves in fl.bvh_leaf_sets:
            covered |= {r for k, r in leaves if k == OBJ_SPHERE}
        n_bvh_leaf_spheres = len(covered)

    data = _scene_data({
        "sph_center": centers, "sph_cvec": cvecs, "sph_radius": radii,
        "sph_mat": sph_mat, "sph_surface": sph_surface,
        "quad_Q": quad_Q, "quad_u": quad_u, "quad_v": quad_v,
        "quad_mat": quad_mat, "quad_surface": quad_surface,
        "mat_tex": mat_tex, "mat_albedo": mat_albedo, "mat_fuzz": mat_fuzz,
        "mat_ior": mat_ior, "tex_color": tex_color,
        "tex_inv_scale": tex_inv_scale, "tex_child_even": tex_child_even,
        "tex_child_odd": tex_child_odd, "tex_noise_scale": tex_noise_scale,
        "tex_image_id": tex_image_id,
        "images": [im.astype(np.float32) for im in w.images],
        "images_packed": [_pack_u8(im) for im in w.images],
        "med_neg_inv_density": med_nid,
    })
    images_u8_exact = tuple(_u8_exact(im) for im in w.images)
    meta = SceneMeta(
        n_spheres=ns, n_quads=nq, any_moving=any_moving,
        mat_kind=tuple(w.mat_kind) or (MAT_LAMBERTIAN,),
        tex_kind=tuple(w.tex_kind) or (TEX_SOLID,),
        n_images=len(w.images), n_noise=w.n_noise_tex,
        media=media_meta, lights=tuple(lights),
        use_bvh=bvh_mode, n_bvh_leaf_spheres=n_bvh_leaf_spheres,
        aaq_class=tuple(aaq_class),
        aab=aab,
        images_u8_exact=images_u8_exact,
    )
    return data, meta


# ---------------------------------------------------------------------------
# numpy -> tensors, and carrying the JAX package's scenes across
# ---------------------------------------------------------------------------

_TUPLE_LEAVES = ("images", "images_packed")


def _leaf_tensor(name: str, a) -> torch.Tensor:
    a = np.asarray(a)
    if name == "images_packed":
        a = a.astype(np.int32)          # values < 2^24: the same numbers
    elif a.dtype == np.bool_:
        pass
    elif np.issubdtype(a.dtype, np.integer):
        a = a.astype(np.int32)
    else:
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a))     # a writable, contiguous copy


def _scene_data(leaves: dict) -> SceneData:
    out = {}
    for f in dataclasses.fields(SceneData):
        v = leaves[f.name]
        if f.name in _TUPLE_LEAVES:
            out[f.name] = tuple(_leaf_tensor(f.name, x) for x in v)
        else:
            out[f.name] = _leaf_tensor(f.name, v)
    return SceneData(**out)


def _from_fields(cls, obj):
    """``cls`` built from a dict or from any object with ``cls``'s fields
    (e.g. the JAX package's frozen dataclass of the same name)."""
    names = [f.name for f in dataclasses.fields(cls)]
    get = obj.get if isinstance(obj, dict) else (lambda n: getattr(obj, n))
    return cls(**{n: get(n) for n in names})


def scene_from_numpy(leaves: dict, meta_fields: dict):
    """(SceneData, SceneMeta) from numpy leaves and meta fields.

    ``leaves`` maps every ``SceneData`` field name to a numpy array (a
    sequence of arrays for ``images``/``images_packed``) — e.g.
    ``np.asarray`` of the JAX package's compiled ``SceneData`` leaves.
    ``meta_fields`` maps every ``SceneMeta`` field name to its value; its
    ``media``/``lights`` entries may be dicts or objects with the fields of
    ``MediumMeta``/``LightMeta``.
    """
    data = _scene_data(leaves)
    fields = dict(meta_fields)
    fields["media"] = tuple(_from_fields(MediumMeta, m)
                            for m in fields["media"])
    fields["lights"] = tuple(_from_fields(LightMeta, l)
                             for l in fields["lights"])
    return data, _from_fields(SceneMeta, fields)
