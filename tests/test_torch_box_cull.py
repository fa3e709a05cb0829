"""Port parity: the closed-box tables and the box cull of the "none" kernel.

``closest_hit.box_tables`` is the port of the JAX package's ``pack_aab``
(and of ``pack_quads_general``'s row list): its face rows must equal JAX's,
and its padded boxes must contain JAX's within 2e-4.

The CUDA "none" kernel scans the spheres, then the general quads
(``gen_rows``) and the axis-aligned ones (``aaq_tab``, whose specialised
test gives the general test's bits: test_torch_aaq.py), then each closed
box behind a widened slab test, testing a box's six faces only where the
ray enters it under its running bound.
``_box_cull_mirror`` below is that schedule in plain torch: it must equal
``closest_hit_reference`` (every primitive tested) bit for bit, and every
winning face's box must have been entered.  The rays graze box edges and
corners, start on faces and inside boxes, or have a direction component
under 1e-8.  The kernel itself is held against the plain version on the
card (test_torch_cuda.py, chip_smoke.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import ORIGINS, box_bounds, box_edge_rays
from mort_tpu.render import pallas_intersect as pal
from mort_tpu.scene import scenes as jsc
from mort_tpu_torch.camera import derive_basis, get_rays_soa
from mort_tpu_torch.render import closest_hit as ch
from mort_tpu_torch.render.intersect import INF, K_QUAD, T_MIN, quad_frames
from mort_tpu_torch.render.primtable import build_prim_table
from mort_tpu_torch.scene import scenes as sc
from mort_tpu_torch.scene.build import scene_from_numpy

_dot3 = ch._dot3


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def test_box_tables_equal_jax_pack_aab():
    jdata, jmeta = jsc.final_scene(quick=True)[0].compile()
    want = np.asarray(pal.pack_aab(jdata, jmeta))[:len(jmeta.aab)]
    data, meta = scene_from_numpy(_fields(jdata), _fields(jmeta))
    tab, faces, gen = ch.box_tables(data, meta)
    tab = tab.numpy()
    assert tab.shape == (36, ch.BOX_COLS)
    np.testing.assert_array_equal(faces.numpy(), want[:, 6:12])
    lo, hi, j_lo, j_hi = tab[:, :3], tab[:, 3:6], want[:, :3], want[:, 3:6]
    assert (lo <= j_lo).all() and (hi >= j_hi).all()
    assert (j_lo - lo <= 2e-4).all() and (hi - j_hi <= 2e-4).all()
    np.testing.assert_array_equal(
        tab[:, 6], np.maximum(np.abs(lo), np.abs(hi)).max(axis=1))
    # the quads outside every box: the lamp, axis-aligned, so no general
    # quad is left
    rows = [r for r, c in enumerate(jmeta.aaq_class) if c != -2]
    assert rows == [r for rs in ch.aaq_groups_of(meta).values() for r in rs]
    assert gen.numel() == 0
    assert len(rows) + 6 * 36 == meta.n_quads


def test_box_tables_without_boxes_list_every_quad():
    world, _ = sc.cornell_box()
    data, meta = world.compile()
    tab, faces, gen = ch.box_tables(data, meta)
    assert meta.aab == () and tab.shape == (0, ch.BOX_COLS)
    assert faces.shape == (0, 6)
    # the general quads and the axis-aligned ones list every quad
    aaq = [r for rs in ch.aaq_groups_of(meta).values() for r in rs]
    assert len(aaq) == 6
    np.testing.assert_array_equal(np.sort(np.concatenate([gen.numpy(),
                                                          aaq])),
                                  np.arange(meta.n_quads))


def _quad_t(packed, rays, rows):
    """closest_hit_reference's quad test of every ray against the quads
    ``rows`` ([R, k] or [k] int64): t, +inf where it misses."""
    ox, oy, oz, dx, dy, dz = (rays[k][:, None] for k in range(6))
    (nx, ny, nz, D, ax_, ay_, az_, qa, bx_, by_, bz_, qb,
     surf) = packed.quad[rows].unbind(-1)
    den = _dot3(nx, ny, nz, dx, dy, dz)
    ok = torch.abs(den) >= 1e-8
    num = D - _dot3(nx, ny, nz, ox, oy, oz)
    t = torch.where(ok, num / torch.where(ok, den, 1.0), -1.0)
    alpha = ((_dot3(ax_, ay_, az_, ox, oy, oz) - qa)
             + t * _dot3(ax_, ay_, az_, dx, dy, dz))
    beta = ((_dot3(bx_, by_, bz_, ox, oy, oz) - qb)
            + t * _dot3(bx_, by_, bz_, dx, dy, dz))
    valid = (ok & (t > T_MIN) & (alpha >= 0.0) & (alpha <= 1.0)
             & (beta >= 0.0) & (beta <= 1.0) & (surf != 0.0))
    return torch.where(valid, t, INF)


def _lex_min(t, i, t2, i2):
    """The lexicographic minimum of (t, i) and each column of (t2, i2)."""
    for k in range(t2.shape[1]):
        better = (t2[:, k] < t) | ((t2[:, k] == t) & (i2[:, k] < i))
        t = torch.where(better, t2[:, k], t)
        i = torch.where(better, i2[:, k], i)
    return t, i


def _box_admits(rays, box, bound):
    """The kernel's box_admits: the slab test of the box widened by
    AAB_SLACK (max |o| + max |corner|), entered in (t_min, bound]."""
    o, d = rays[0:3].T, rays[3:6].T
    m = (o.abs().amax(dim=1) + box[6]) * ch.AAB_SLACK
    lo, hi = box[None, 0:3] - m[:, None], box[None, 3:6] + m[:, None]
    tiny = torch.where(d >= 0.0, 1e-30, -1e-30)
    inv = 1.0 / torch.where(d.abs() < 1e-30, tiny, d)
    t0, t1 = (lo - o) * inv, (hi - o) * inv
    near = torch.minimum(t0, t1).amax(dim=1)
    far = torch.maximum(t0, t1).amin(dim=1)
    return (near <= far) & (far > T_MIN) & (near <= bound)


def _box_cull_mirror(packed, rays):
    """The "none" kernel's schedule: returns (t, kind, idx, entered [R,
    n_box] bool)."""
    R = rays.shape[1]
    # the spheres: closest_hit_reference without its quads
    row = ch.closest_hit_reference(dataclasses.replace(packed, n_quad=0),
                                   rays)
    st, s_idx = row[ch.ROW_T], row[ch.ROW_IDX].long()
    gen = torch.cat([packed.gen_rows.long(), packed.aaq_tab[:, 6].long()])
    qt = torch.full((R,), INF)
    qi = torch.zeros(R, dtype=torch.long)
    if gen.numel():
        qt, qi = _lex_min(qt, qi, _quad_t(packed, rays, gen),
                          gen[None].expand(R, -1))
    n_box = packed.aab_tab.shape[0]
    entered = torch.zeros((R, n_box), dtype=torch.bool)
    for b in range(n_box):
        entered[:, b] = _box_admits(rays, packed.aab_tab[b],
                                    torch.minimum(st, qt))
        faces = packed.aab_faces[b].long()
        t_f = torch.where(entered[:, b, None],
                          _quad_t(packed, rays, faces), INF)
        qt, qi = _lex_min(qt, qi, t_f, faces[None].expand(R, -1))
    q_better = qt < st
    t = torch.where(q_better, qt, st)
    kind = torch.where(t < INF, torch.where(q_better, K_QUAD, 1), 0)
    return t, kind, torch.where(q_better, qi, s_idx), entered


@pytest.fixture(scope="module")
def boxes():
    """final_scene(quick=True) (36 boxes, 107 spheres, the lamp): its packed
    tables, its true (unpadded) boxes and its camera."""
    world, cam = sc.final_scene(400, 16, 4, quick=True)
    data, meta = world.compile()
    qf = quad_frames(data)
    table, _ = build_prim_table(data, meta, qf)
    packed = ch.pack_scene(data, meta, qf, table)
    return packed, *box_bounds(data, meta), cam


def _camera_bounce(packed, cam, n, g):
    pix = torch.from_numpy(g.randint(0, 400 * 400, n).astype(np.int64))
    smp = torch.from_numpy(g.randint(0, 16, n).astype(np.int64))
    ro, rd, tme = get_rays_soa(cam, derive_basis(cam), 69420, pix, smp,
                               no_defocus=True)
    rays = ch.stack_rays(ro, rd, tme)
    t = ch.closest_hit_reference(packed, rays)[ch.ROW_T]
    hit = torch.isfinite(t)
    bounce = torch.zeros(8, int(hit.sum()))
    bounce[0:3] = (rays[0:3] + rays[3:6] * t)[:, hit]
    bounce[3:6] = torch.from_numpy(g.randn(3, bounce.shape[1]).astype(
        np.float32))
    bounce[6] = rays[6, hit]
    return torch.cat([rays, bounce], dim=1)


# each case's rays: chip_smoke.box_edge_rays's origins and share of
# direction components under 1e-8
EDGE_CASES = {
    "edges_from_camera": (("camera",), 0.0),
    "edges_from_far": (("far",), 0.0),
    "origins_on_faces": (("face",), 0.0),
    "origins_inside_boxes": (("inside",), 0.0),
    "tiny_components": (ORIGINS, 1.0),
}


def _case_rays(case, packed, lo, hi, cam, seed, n=4096):
    if case == "camera_bounce":
        return _camera_bounce(packed, cam, n, np.random.RandomState(seed))
    origins, tiny = EDGE_CASES[case]
    return box_edge_rays(lo, hi, cam.lookfrom, n, seed, origins, tiny)


CASES = ("camera_bounce",) + tuple(EDGE_CASES)


@pytest.mark.parametrize("case", CASES)
def test_box_cull_schedule_equals_plain(boxes, case):
    packed, lo, hi, cam = boxes
    rays = _case_rays(case, packed, lo, hi, cam, CASES.index(case))
    want = ch.closest_hit_reference(packed, rays)
    t, kind, idx, entered = _box_cull_mirror(packed, rays)
    assert torch.equal(t, want[ch.ROW_T])
    assert torch.equal(kind.float(), want[ch.ROW_KIND])
    assert torch.equal(idx.float(), want[ch.ROW_IDX])
    # every winning face lies in a box the ray entered
    face_box = torch.full((packed.n_quad,), -1, dtype=torch.long)
    faces = packed.aab_faces.long()
    face_box[faces.reshape(-1)] = torch.arange(
        faces.shape[0]).repeat_interleave(6)
    won = (kind == K_QUAD) & (face_box[idx.clamp(max=packed.n_quad - 1)]
                              >= 0)
    assert int(won.sum()) > 0, "no face won: the rays miss the boxes"
    lanes = won.nonzero().squeeze(1)
    assert bool(entered[lanes, face_box[idx[lanes]]].all())
    # and the cull prunes: a ray enters few of the 36 boxes
    assert float(entered.float().sum(1).mean()) < 12.0
