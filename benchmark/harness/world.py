"""The reference's scene registry and its plain flattening.

The scene builders (``benchmark/scenes``) describe a scene by calls on a
``World``: the program's own (``mort_tpu_torch.World``), whose compile
packs the scene as the program lays it out, or this one, a copy of the
port's registry whose ``compile()`` flattens the same description plainly
for the reference: every primitive row in the order the registry resolves
it, with no acceleration tables, reordering or padding.  It returns
``(leaves, meta)``: the ``SceneData`` fields the reference reads as numpy
arrays and the ``SceneMeta`` fields it reads as plain values.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

# Tags (the values of mort_tpu_torch.scene.types).
MAT_LAMBERTIAN, MAT_METAL, MAT_DIELECTRIC, MAT_DIFFUSE_LIGHT, \
    MAT_ISOTROPIC = 1, 2, 3, 4, 5
TEX_SOLID, TEX_CHECKER, TEX_IMAGE, TEX_NOISE = 1, 2, 3, 4
OBJ_SPHERE, OBJ_QUAD, OBJ_TRANSLATE, OBJ_ROTATE_Y, OBJ_CONSTANT_MEDIUM, \
    OBJ_HITTABLE_LIST, OBJ_BVH = 1, 2, 3, 4, 5, 6, 7
# constant media one Philox block serves (word m for medium m)
MAX_MEDIA = 4


@dataclass(frozen=True)
class TexH:
    kind: int
    row: int


@dataclass(frozen=True)
class MatH:
    kind: int
    row: int


@dataclass(frozen=True)
class ObjH:
    kind: int
    idx: int


@dataclass(frozen=True)
class MediumMeta:
    sphere_rows: tuple
    quad_rows: tuple
    mat_row: int


@dataclass(frozen=True)
class LightMeta:
    kind: int
    row: int


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
    def compile(self) -> tuple[dict, dict]:
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
            if out_leaves is not None:
                out_leaves.extend(leaves)
        else:
            raise ValueError(f"unknown object kind {h.kind}")


def _rows(rows, pad_row) -> np.ndarray:
    """[n, k] float32 of ``rows``; one benign row (masked out by the
    surface flag) when there are none."""
    return np.stack([np.asarray(r, np.float32) for r in rows]
                    or [pad_row]).astype(np.float32)


def _compile_world(w: World) -> tuple[dict, dict]:
    """The plain flattening: every primitive row in the order the
    registry resolves it, no acceleration tables, no padding."""
    fl = _Flattener(w)

    # Active roots reproduce the reachability of world::hit
    # (world.cuh:105-171): when any non-skip BVH exists ONLY the BVHs are
    # consulted; otherwise every non-skip object of each registry is hit
    # directly, and members of non-skip lists / transforms are hit through
    # dispatch regardless of their own skip flag.
    bvh_mode = any(not b.skip for b in w.bvhs)
    for b_i, b in enumerate(w.bvhs):
        if not b.skip:
            fl.resolve(ObjH(OBJ_BVH, b_i), *_IDENT, ident=True)
    if not bvh_mode:
        for kind, reg in ((OBJ_SPHERE, w.spheres), (OBJ_QUAD, w.quads),
                          (OBJ_TRANSLATE, w.translates),
                          (OBJ_ROTATE_Y, w.rotates),
                          (OBJ_HITTABLE_LIST, w.lists),
                          # media last: their RNG slots follow registry order
                          (OBJ_CONSTANT_MEDIUM, w.media)):
            for i, o in enumerate(reg):
                if not o.skip:
                    fl.resolve(ObjH(kind, i), *_IDENT, ident=True)

    # Lights: the camera's light object reference as leaf rows.
    lights: list[LightMeta] = []
    if w.light is not None:
        found: list = []
        fl.resolve(w.light, *_IDENT, ident=True, out_leaves=found,
                   surface=False)
        lights = [LightMeta(k, r) for k, r in found]

    ns, nq = len(fl.out_spheres), len(fl.out_quads)
    z3 = np.zeros(3, np.float32)
    sph = fl.out_spheres
    quads = fl.out_quads
    media_meta = tuple(MediumMeta(srows, qrows, mrow)
                       for srows, qrows, mrow, _d in fl.media_meta)
    if len(media_meta) > MAX_MEDIA:
        raise ValueError(f"scene has {len(media_meta)} constant media; one "
                         f"Philox block serves at most {MAX_MEDIA}")

    leaves = {
        "sph_center": _rows([r[0] for r in sph], z3),
        "sph_cvec": _rows([r[1] for r in sph], z3),
        "sph_radius": _rows([[r[2]] for r in sph], np.zeros(1))[:, 0],
        "sph_mat": np.array([r[3] for r in sph] or [0], np.int32),
        "sph_surface": np.array(fl.sph_surface or [False], np.bool_),
        "quad_Q": _rows([r[0] for r in quads], z3),
        "quad_u": _rows([r[1] for r in quads], np.array([1, 0, 0])),
        "quad_v": _rows([r[2] for r in quads], np.array([0, 1, 0])),
        "quad_mat": np.array([r[3] for r in quads] or [0], np.int32),
        "quad_surface": np.array(fl.quad_surface or [False], np.bool_),
        "mat_tex": np.array(w.mat_tex or [0], np.int32),
        "mat_albedo": _rows(w.mat_albedo, np.ones(3)),
        "mat_fuzz": np.array(w.mat_fuzz or [0.0], np.float32),
        "mat_ior": np.array(w.mat_ior or [1.0], np.float32),
        "tex_color": _rows(w.tex_color, z3),
        "tex_inv_scale": np.array(w.tex_inv_scale or [0.0], np.float32),
        "tex_child_even": np.array(w.tex_child_even or [0], np.int32),
        "tex_child_odd": np.array(w.tex_child_odd or [0], np.int32),
        "tex_noise_scale": np.array(w.tex_noise_scale or [0.0], np.float32),
        "tex_image_id": np.array(w.tex_image_id or [0], np.int32),
        "images": [im.astype(np.float32) for im in w.images],
        "med_neg_inv_density": np.array(
            [-1.0 / m[3] for m in fl.media_meta] or [0.0], np.float32),
    }
    meta = dict(
        n_spheres=ns, n_quads=nq, any_moving=any(r[4] for r in sph),
        mat_kind=tuple(w.mat_kind) or (MAT_LAMBERTIAN,),
        tex_kind=tuple(w.tex_kind) or (TEX_SOLID,),
        n_images=len(w.images), n_noise=w.n_noise_tex,
        media=tuple(dataclasses.asdict(m) for m in media_meta),
        lights=tuple(dataclasses.asdict(l) for l in lights),
    )
    return leaves, meta
