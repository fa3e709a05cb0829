"""Port parity: the axis-aligned quads of the "none" kernel.

``closest_hit.aaq_tables`` is the port of the JAX package's ``pack_aaq`` and
``aaq_groups_of``: its orientation groups and registry rows must equal
JAX's.  The CUDA "none" kernel tests those quads group by group with a test
specialised to the group's axes (``aaq_test`` in csrc/closest_hit.cu), the
general quad test with the frame's exact zeros left out; a ray with a
non-finite component takes the general test, and a row whose frame left
the axes is listed with the general quads.  ``_aaq_mirror`` below is that schedule in plain torch, with the
kernel's arithmetic: it must equal ``closest_hit_reference`` (the general
test on every quad) bit for bit on camera and bounce rays of scenes 5, 6
and 7, on rays at the quads' window edges, on rays with a component under
1e-8 and on rays with an infinite component.  Against the JAX package's
Pallas kernel (interpret mode), whose ``_aaq_group_best`` takes t as
``(Q_k - ro_k) * (1 / rd_k)``, kind and idx hold exactly and t within the
bound of test_torch_closest_hit.py.  The kernel itself is held against the
plain version on the card (test_torch_cuda.py, chip_smoke.py).
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from chip_smoke import window_edge_rays
from mort_tpu.render import pallas_intersect as pal
from mort_tpu.render.intersect import quad_frames as j_quad_frames
from mort_tpu.render.primtable import build_prim_table as j_prim_table
from mort_tpu.scene import scenes as jsc
from mort_tpu_torch.camera import camera_from_numpy, derive_basis, get_rays_soa
from mort_tpu_torch.render import closest_hit as ch
from mort_tpu_torch.render.intersect import INF, K_QUAD, T_MIN, quad_frames
from mort_tpu_torch.render.primtable import build_prim_table
from mort_tpu_torch.scene.build import scene_from_numpy

_dot3 = ch._dot3


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _jax_scene(idx):
    if idx == 9:
        return jsc.final_scene(400, 250, 4)
    return jsc.build_scene(idx)


def _port(jdata, jmeta, jcam=None):
    data, meta = scene_from_numpy(_fields(jdata), _fields(jmeta))
    qf = quad_frames(data)
    table, _ = build_prim_table(data, meta, qf)
    packed = ch.pack_scene(data, meta, qf, table)
    cam = None if jcam is None else camera_from_numpy(_fields(jcam))
    return data, meta, packed, cam


@pytest.mark.parametrize("idx", [5, 6, 7, 9])
def test_aaq_tables_equal_jax(idx):
    world, _ = _jax_scene(idx)
    jdata, jmeta = world.compile()
    jtab, jdescs = pal.pack_aaq(jdata, jmeta)
    jtab = np.asarray(jtab)
    data, meta, packed, _ = _port(jdata, jmeta)
    assert meta.aaq_class == jmeta.aaq_class
    groups = ch.aaq_groups_of(meta)
    assert groups == pal.aaq_groups_of(jmeta)
    tab, desc = packed.aaq_tab.numpy(), packed.aaq_groups.numpy()
    assert len(desc) == len(jdescs)
    for (start, n, k, i, j), (j_start, j_n, jk, ji, jj) in zip(desc,
                                                               jdescs):
        assert (k, i, j) == (jk, ji, jj)
        live = jtab[j_start:j_start + j_n, pal._AQ_LIVE] > 0
        j_rows = jtab[j_start:j_start + j_n, pal._AQ_ROW][live]
        np.testing.assert_array_equal(tab[start:start + n, 6], j_rows)
        # the specialised test's operands are the quad record's
        rec = packed.quad[tab[start:start + n, 6].astype(np.int64)].numpy()
        np.testing.assert_array_equal(tab[start:start + n, 0], rec[:, k])
        np.testing.assert_array_equal(tab[start:start + n, 1], rec[:, 3])
        np.testing.assert_array_equal(tab[start:start + n, 2], rec[:, 4 + i])
        np.testing.assert_array_equal(tab[start:start + n, 4], rec[:, 8 + j])
    # every row is a live surface quad with an exactly axis-aligned frame
    assert (tab[:, 7] == 1.0).all()
    # gen_rows keeps only the general quads (class 9)
    np.testing.assert_array_equal(
        packed.gen_rows.numpy(),
        [r for r, c in enumerate(jmeta.aaq_class) if c == 9])
    n_box_faces = sum(c == -2 for c in jmeta.aaq_class)
    assert len(tab) + len(packed.gen_rows) + n_box_faces == meta.n_quads


def _quad_t(packed, rays, rows):
    """closest_hit_reference's general quad test of every ray against the
    quads ``rows`` [k]: t [R, k], +inf where it misses."""
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


def _aaq_t(rows_tab, rays, k, i, j):
    """The kernel's aaq_test of every ray against the table rows
    ``rows_tab`` [m, AAQ_COLS] of one group: t [R, m], +inf on a miss."""
    nk, D, ai, qa, bj, qb = (rows_tab[None, :, c] for c in range(6))
    o, d = rays[0:3], rays[3:6]
    ok_, dk = o[k][:, None], d[k][:, None]
    den = nk * dk
    good = torch.abs(den) >= 1e-8
    t = (D - nk * ok_) / torch.where(good, den, 1.0)
    alpha = (ai * o[i][:, None] - qa) + t * (ai * d[i][:, None])
    beta = (bj * o[j][:, None] - qb) + t * (bj * d[j][:, None])
    valid = (good & (t > T_MIN) & (alpha >= 0.0) & (alpha <= 1.0)
             & (beta >= 0.0) & (beta <= 1.0))
    return torch.where(valid, t, INF)


def _lex_min(t, i, t2, i2):
    """The lexicographic minimum of (t, i) and each column of (t2, i2)."""
    for k in range(t2.shape[1]):
        better = (t2[:, k] < t) | ((t2[:, k] == t) & (i2[:, k] < i))
        t = torch.where(better, t2[:, k], t)
        i = torch.where(better, i2[:, k], i)
    return t, i


def _aaq_mirror(packed, rays):
    """The "none" kernel's schedule on a scene without closed boxes:
    spheres, ``gen_rows`` by the general test, then the axis-aligned
    groups by the specialised test (a finite ray) or the general test (a
    non-finite ray); skip rows (live 0) untested.  Returns (t, kind, idx,
    aaq tests, general quad tests)."""
    assert packed.aab_tab.shape[0] == 0
    R = rays.shape[1]
    row = ch.closest_hit_reference(dataclasses.replace(packed, n_quad=0),
                                   rays)
    st, s_idx = row[ch.ROW_T], row[ch.ROW_IDX].long()
    qt = torch.full((R,), INF)
    qi = torch.zeros(R, dtype=torch.long)
    gen = packed.gen_rows.long()
    n_gen = int((packed.quad[gen, 12] != 0).sum())
    qt, qi = _lex_min(qt, qi, _quad_t(packed, rays, gen),
                      gen[None].expand(R, -1))
    finite = torch.isfinite(rays[0:6]).all(dim=0)
    n_aaq = n_fallback = 0
    for start, n, k, i, j in packed.aaq_groups.tolist():
        tab = packed.aaq_tab[start:start + n]
        rows = tab[:, 6].long()
        live = (tab[:, 7] != 0.0)[None]
        spec = live & finite[:, None]
        t = torch.where(finite[:, None], _aaq_t(tab, rays, k, i, j),
                        _quad_t(packed, rays, rows))
        t = torch.where(live, t, INF)
        qt, qi = _lex_min(qt, qi, t, rows[None].expand(R, -1))
        n_aaq += int(spec.sum())
        n_fallback += int((live & ~spec).sum())
    q_better = qt < st
    t = torch.where(q_better, qt, st)
    kind = torch.where(t < INF, torch.where(q_better, K_QUAD, 1), 0)
    return (t, kind, torch.where(q_better, qi, s_idx), n_aaq,
            R * n_gen + n_fallback)


def _camera_bounce(packed, cam, n, g):
    """n camera rays of ``cam`` and a random bounce from each hit point."""
    pix = torch.from_numpy(g.randint(0, cam.image_width * cam.image_height,
                                     n).astype(np.int64))
    smp = torch.from_numpy(g.randint(0, cam.sqrt_spp ** 2, n).astype(
        np.int64))
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


@pytest.fixture(scope="module")
def scenes():
    """Scenes 5, 6 and 7 (every surface row of 5 is axis-aligned; 6 and 7
    mix both paths): (JAX data, meta, camera, port data, meta, packed,
    camera)."""
    out = {}
    for idx in (5, 6, 7):
        world, jcam = jsc.build_scene(idx)
        jdata, jmeta = world.compile()
        out[idx] = (jdata, jmeta, jcam) + _port(jdata, jmeta, jcam)
    return out


def _rays(case, scene, seed):
    _jd, _jm, _jc, data, meta, packed, cam = scene
    g = np.random.RandomState(seed)
    if case == "camera_bounce":
        return _camera_bounce(packed, cam, 2048, g)
    if case == "window_edges":
        return window_edge_rays(data, meta, cam.lookfrom, 4096, seed,
                                tiny=0.0)
    if case == "tiny_components":
        return window_edge_rays(data, meta, cam.lookfrom, 2048, seed,
                                tiny=1.0)
    # one coordinate of each ray infinite (of either sign)
    rays = _camera_bounce(packed, cam, 256, g)
    lanes = torch.arange(rays.shape[1])
    rays[torch.from_numpy(g.randint(0, 6, rays.shape[1])), lanes] = \
        torch.from_numpy(np.where(g.rand(rays.shape[1]) < 0.5, np.inf,
                                  -np.inf).astype(np.float32))
    return rays


CASES = [(5, "camera_bounce"), (6, "camera_bounce"), (7, "camera_bounce"),
         (5, "window_edges"), (6, "window_edges"), (5, "tiny_components"),
         (6, "tiny_components"), (6, "non_finite")]


@pytest.mark.parametrize("idx,case", CASES,
                         ids=[f"scene{i}-{c}" for i, c in CASES])
def test_aaq_schedule_equals_plain(scenes, idx, case):
    packed = scenes[idx][5]
    rays = _rays(case, scenes[idx], CASES.index((idx, case)))
    want = ch.closest_hit_reference(packed, rays)
    t, kind, idx_, n_aaq, n_gen = _aaq_mirror(packed, rays)
    same = (t == want[ch.ROW_T]) | (torch.isnan(t)
                                    & torch.isnan(want[ch.ROW_T]))
    assert bool(same.all())
    assert torch.equal(kind.float(), want[ch.ROW_KIND])
    assert torch.equal(idx_.float(), want[ch.ROW_IDX])
    won = ((kind == K_QUAD)
           & torch.isin(idx_, packed.aaq_tab[:, 6].long())).sum()
    if case != "non_finite":
        assert int(won) > 0, "no axis-aligned quad won"
        assert n_aaq == rays.shape[1] * packed.aaq_tab.shape[0]
    else:
        assert n_aaq == 0
    if idx == 5:     # every surface row of scene 5 is axis-aligned
        assert packed.gen_rows.numel() == 0 and (n_gen > 0) == (
            case == "non_finite")


def test_aaq_row_off_its_axes_takes_the_general_test(scenes):
    """A gradient step can move quad_u off the axes while aaq_class stays:
    that row leaves the axis-aligned table for ``gen_rows``, and the
    schedule still equals the plain version."""
    _jd, _jm, _jc, data, meta, _p, cam = scenes[6]
    u = data.quad_u.clone()
    row = ch.aaq_groups_of(meta)[2][0]
    u[row, 1] += 1e-3
    data = data.replace(quad_u=u)
    qf = quad_frames(data)
    table, _ = build_prim_table(data, meta, qf)
    packed = ch.pack_scene(data, meta, qf, table)
    assert row not in packed.aaq_tab[:, 6].long().tolist()
    assert row in packed.gen_rows.tolist()
    assert packed.aaq_tab.shape[0] == 5
    assert int(packed.aaq_groups[:, 1].sum()) == 5
    rays = window_edge_rays(data, meta, cam.lookfrom, 2048, 21, tiny=0.0)
    want = ch.closest_hit_reference(packed, rays)
    t, kind, idx, n_aaq, _ = _aaq_mirror(packed, rays)
    assert torch.equal(t, want[ch.ROW_T])
    assert torch.equal(idx.float(), want[ch.ROW_IDX])
    assert n_aaq == rays.shape[1] * 5


@pytest.mark.parametrize("idx", [5, 7])
def test_aaq_path_matches_jax_pallas(scenes, idx):
    """The port (the general test's t) against the JAX kernel in interpret
    mode (``_aaq_group_best``'s t): kind and idx exact, t within the bound
    of test_torch_closest_hit.py; the lanes whose t differs are counted
    and differ by at most 2 ulps."""
    jdata, jmeta, _jc, _d, _m, packed, cam = scenes[idx]
    rays = _camera_bounce(packed, cam, 1024, np.random.RandomState(idx))
    want = ch.closest_hit_reference(packed, rays)
    t = want[ch.ROW_T].numpy()
    kind = want[ch.ROW_KIND].numpy().astype(np.int32)
    idx_ = want[ch.ROW_IDX].numpy().astype(np.int32)
    r = rays.numpy()
    jqf = j_quad_frames(jdata)
    jtable, _ = j_prim_table(jdata, jmeta, jqf)
    pt, pk, pi, _ = map(np.asarray, pal.closest_hit_pallas(
        jdata, jmeta, jqf, jtable, jnp.asarray(r[0:3].T),
        jnp.asarray(r[3:6].T), jnp.asarray(r[6]), interpret=True,
        accel="none"))
    hit = np.isfinite(pt)
    assert hit.any() and (np.isfinite(t) == hit).all()
    np.testing.assert_array_equal(kind, pk)
    np.testing.assert_array_equal(idx_[hit], pi[hit])
    err = np.abs(t[hit] - pt[hit])
    assert (err <= 3e-5 * np.abs(pt[hit]) + 1e-5).all()
    aaq = hit & (kind == K_QUAD) & np.isin(idx_, packed.aaq_tab[:, 6]
                                            .numpy().astype(np.int32))
    assert aaq.any()
    ulps = np.abs(t[aaq].view(np.int32).astype(np.int64)
                  - pt[aaq].view(np.int32).astype(np.int64))
    print(f"scene {idx}: {int(aaq.sum())} lanes hit an axis-aligned quad, "
          f"t differs on {int((ulps > 0).sum())} by at most "
          f"{int(ulps.max())} ulps")
    assert int(ulps.max()) <= 2
