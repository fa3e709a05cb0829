"""Port parity: the closest-hit module (the module that holds the CUDA
kernel).  On the CPU its wrapper takes ``closest_hit_reference``, which
performs the kernel's arithmetic op for op; it is held against the JAX
package's Pallas kernel in interpret mode and against its XLA intersector,
on the ``_mixed_world`` cases of test_pallas_kernel.py and on scene-1 rays.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from mort_tpu import World
from mort_tpu.render import pallas_intersect as pal
from mort_tpu.render.intersect import (
    intersect_best as j_intersect_best, quad_frames as j_quad_frames,
)
from mort_tpu.render.primtable import build_prim_table as j_prim_table
from mort_tpu.scene import scenes as jsc
from mort_tpu_torch.render import closest_hit as ch
from mort_tpu_torch.render.intersect import (
    K_NONE, intersect_best, quad_frames,
)
from mort_tpu_torch.render.primtable import build_prim_table
from mort_tpu_torch.render.vec import V3
from mort_tpu_torch.scene.build import scene_from_numpy


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _mixed_world(n_sph=7, n_quad=5, moving=False):
    """The scene of test_pallas_kernel.py::_mixed_world."""
    rng = np.random.RandomState(1)
    w = World()
    m = w.lambertian(w.solid_color([0.5, 0.5, 0.5]))
    for i in range(n_sph):
        c = rng.randn(3) * 3
        if moving and i % 2 == 0:
            w.sphere(c, 0.3 + rng.rand(), m, center2=c + rng.randn(3) * 0.5)
        else:
            w.sphere(c, 0.3 + rng.rand(), m)
    for _ in range(n_quad):
        w.quad(rng.randn(3) * 3, rng.randn(3) * 2, rng.randn(3) * 2, m)
    return w


def _rand_rays(n, seed=3, spread=6.0):
    rng = np.random.RandomState(seed)
    ro = (rng.randn(n, 3) * spread).astype(np.float32)
    rd = rng.randn(n, 3).astype(np.float32)
    tme = rng.rand(n).astype(np.float32)
    return ro, rd, tme


def _port_hit(jdata, jmeta, ro, rd, tme):
    data, meta = scene_from_numpy(_fields(jdata), _fields(jmeta))
    qf = quad_frames(data)
    table, _ = build_prim_table(data, meta, qf)
    packed = ch.pack_scene(data, meta, qf, table)
    t, kind, idx, row = ch.closest_hit(
        packed, V3.from_rows(torch.from_numpy(ro)),
        V3.from_rows(torch.from_numpy(rd)), torch.from_numpy(tme))
    return t.numpy(), kind.numpy(), idx.numpy(), row.numpy(), data, meta, qf


def _quadratic_slack(jdata, ro, rd, tme, kind, idx):
    """Per-lane rounding envelope of a sphere root computed in float32 from
    the expanded quadratic (float64 evaluation of its sensitivities).

    c_term sums terms as large as M_c = max(|ro|^2, 2|c.ro|, c.c, r^2, ...)
    (the XLA intersector adds c.c and -r^2 separately) down to a result
    that can be far smaller, so each float32 side
    carries an error of a few ulps of M_c, which reaches t as
    dc / (2 sqrt(disc)); half_b likewise carries a few ulps of
    M_h = max(|ro.rd|, |c.rd|, ...), reaching t as dh (1 + |hb|/sqrt(disc)) / a.
    Near a silhouette (disc -> 0) both blow up: there the JAX kernel, its
    XLA intersector and the port all deviate from a float64 evaluation by
    up to a few percent (measured on scene-1 rays), whatever their
    summation order."""
    u = 2.0 ** -24
    sph = kind == 1
    j = np.where(sph, idx, 0)
    o, d, tm = (x.astype(np.float64) for x in (ro, rd, tme))
    c = np.asarray(jdata.sph_center, np.float64)[j]
    cv = np.asarray(jdata.sph_cvec, np.float64)[j] * tm[:, None]
    r = np.asarray(jdata.sph_radius, np.float64)[j]
    a = (d * d).sum(1)
    hb = (o * d).sum(1) - (c * d).sum(1) - (cv * d).sum(1)
    m_h = np.max(np.abs([(o * d).sum(1), (c * d).sum(1), (cv * d).sum(1)]), 0)
    m_c = np.max(np.abs([(o * o).sum(1), 2 * (c * o).sum(1),
                         2 * (cv * o).sum(1), (c * c).sum(1), r * r,
                         2 * (c * cv).sum(1), (cv * cv).sum(1)]), 0)
    cterm = ((o - c - cv) ** 2).sum(1) - r * r
    sq = np.sqrt(np.maximum(hb * hb - a * cterm, 1e-300))
    slack = 16 * u * (m_c / (2 * sq) + m_h * (1 + np.abs(hb) / sq) / a)
    return np.where(sph, slack, 0.0)


def _check(jdata, jmeta, ro, rd, tme, envelope=False):
    """``envelope``: add ``_quadratic_slack`` to the t bound (scene-1 rays,
    whose grazing hits are ill-conditioned); kind and idx stay exact."""
    t, kind, idx, row, data, meta, qf = _port_hit(jdata, jmeta, ro, rd, tme)
    slack = (_quadratic_slack(jdata, ro, rd, tme, kind, idx) if envelope
             else np.zeros(len(t)))
    jqf = j_quad_frames(jdata)
    jtable, _ = j_prim_table(jdata, jmeta, jqf)
    R = ro.shape[0]

    pt_, pk, pi, prow = map(np.asarray, pal.closest_hit_pallas(
        jdata, jmeta, jqf, jtable, jnp.asarray(ro), jnp.asarray(rd),
        jnp.asarray(tme), interpret=True, accel="none"))
    bt, bk, bi = map(np.asarray, j_intersect_best(
        jdata, jmeta, jqf, jnp.asarray(ro), jnp.asarray(rd),
        jnp.asarray(tme), jnp.uint32(1), jnp.zeros(R, jnp.int32),
        jnp.zeros(R, jnp.int32), 0))

    for want_t, want_k, want_i in ((pt_, pk, pi), (bt, bk, bi)):
        hit = np.isfinite(want_t)
        assert hit.any() and (~hit).any()
        assert (np.isfinite(t) == hit).all()
        assert (kind[~hit] == K_NONE).all()
        # the bound test_pallas_kernel.py holds the Pallas kernel to: both
        # sides are float32 with different summation orders of the same
        # expanded quadratic (plus the conditioning envelope, if asked)
        err = np.abs(t[hit] - want_t[hit])
        bound = 3e-5 * np.abs(want_t[hit]) + 1e-5 + slack[hit]
        assert (err <= bound).all(), (err - bound).max()
        np.testing.assert_array_equal(kind[hit], want_k[hit])
        np.testing.assert_array_equal(idx[hit], want_i[hit])
    # joined rows on hit lanes: copies of the same table entries (quad
    # frames go through one sqrt/div each, so allow an ulp)
    hit = np.isfinite(pt_)
    np.testing.assert_allclose(row[:ch.ROW_T, hit], prow[:ch.ROW_T, hit],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(row[ch.ROW_KIND], kind)
    np.testing.assert_array_equal(row[ch.ROW_IDX], idx)

    # the port's reference intersector agrees with the kernel's plain form
    it, ik, ii = intersect_best(data, meta, qf, torch.from_numpy(ro),
                                torch.from_numpy(rd), torch.from_numpy(tme),
                                1, torch.zeros(R, dtype=torch.int64),
                                torch.zeros(R, dtype=torch.int64), 0)
    err = np.abs(it.numpy()[hit] - t[hit])
    assert (err <= 3e-5 * np.abs(t[hit]) + 1e-5 + slack[hit]).all()
    np.testing.assert_array_equal(ik.numpy(), kind)
    np.testing.assert_array_equal(ii.numpy()[hit], idx[hit])


@pytest.mark.parametrize("case", [
    dict(),                                    # mixed
    dict(n_sph=9, n_quad=0),                   # sphere only
    dict(n_sph=0, n_quad=6),                   # quad only
    dict(n_sph=8, n_quad=3, moving=True),      # moving spheres
], ids=["mixed", "sphere_only", "quad_only", "moving"])
def test_mixed_world_parity(case):
    jdata, jmeta = _mixed_world(**case).compile()
    _check(jdata, jmeta, *_rand_rays(256))


def test_scene1_ray_parity():
    """Scene 1's camera rays plus one bounce from their hit points."""
    from mort_tpu_torch.camera import (
        camera_from_numpy, derive_basis, get_rays_soa,
    )
    world, jcam = jsc.random_spheres()
    jdata, jmeta = world.compile()
    cam = camera_from_numpy(_fields(jcam))
    rs = np.random.RandomState(5)
    n = 1024
    pix = torch.from_numpy(rs.randint(0, 1200 * 675, n).astype(np.int64))
    smp = torch.from_numpy(rs.randint(0, 100, n).astype(np.int64))
    ro, rd, tme = get_rays_soa(cam, derive_basis(cam), 69420, pix, smp,
                               no_defocus=True)
    ro, rd, tme = ro.to_rows().numpy(), rd.to_rows().numpy(), tme.numpy()
    t, *_ = _port_hit(jdata, jmeta, ro, rd, tme)
    hit = np.isfinite(t)
    p = ro[hit] + rd[hit] * t[hit, None]
    d2 = rs.randn(p.shape[0], 3).astype(np.float32)
    ro2 = np.concatenate([ro, p.astype(np.float32)])
    rd2 = np.concatenate([rd, d2])
    tme2 = np.concatenate([tme, rs.rand(p.shape[0]).astype(np.float32)])
    _check(jdata, jmeta, ro2, rd2, tme2, envelope=True)


def test_cpu_wrapper_takes_plain_version_and_counts_no_launch():
    jdata, jmeta = _mixed_world().compile()
    before = ch.launch_count
    ro, rd, tme = _rand_rays(64)
    t, kind, idx, row = _port_hit(jdata, jmeta, ro, rd, tme)[:4]
    assert ch.launch_count == before
    assert row.shape == (ch.ROW_K, 64) and row.dtype == np.float32
    assert kind.dtype == np.int32 and idx.dtype == np.int32
    assert (row[ch.ROW_IDX + 1:] == 0).all()
