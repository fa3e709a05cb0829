"""Port parity: the closest-hit kernel's accel modes ("cull", "bvh").

The host side of "cull" (``cluster_boxes``, which the port packs widened)
and ``auto_accel`` must equal the JAX package's ("bvh"'s tree is the
port's own, with single-row leaves: test_torch_bvh.py).  The function
value of every mode is the plain version ``closest_hit_reference``, which
a CPU tensor takes whatever mode is packed; it is held against the JAX
package's Pallas kernel in that mode (interpret mode) on the forced-mode
cases of test_pallas_kernel.py, with that file's bound.  The CUDA modes
themselves are held against the plain version on the card
(test_torch_cuda.py, chip_smoke.py).
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from mort_tpu import World
from mort_tpu.render import pallas_intersect as pal
from mort_tpu.render.intersect import quad_frames as j_quad_frames
from mort_tpu.render.primtable import build_prim_table as j_prim_table
from mort_tpu.scene import scenes as jsc
from mort_tpu_torch.render import closest_hit as ch
from mort_tpu_torch.render.intersect import quad_frames
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


def _spread_world(n):
    """test_pallas_kernel.py's spread-spheres scene (boxes genuinely
    pruned)."""
    rng = np.random.RandomState(9)
    w = World()
    m = w.lambertian(w.solid_color([0.5, 0.5, 0.5]))
    for i in range(n):
        c = [i * 5.0 - n * 2.5, rng.randn() * 2, rng.randn() * 2]
        w.sphere(c, 0.4 + rng.rand(), m)
    return w


def _final_world():
    return jsc.build_scene(9)[0]


WORLDS = {
    "mixed": lambda: _mixed_world(),
    "sphere_only": lambda: _mixed_world(9, 0),
    "quad_only": lambda: _mixed_world(0, 6),
    "moving": lambda: _mixed_world(30, 6, moving=True),
    "spread600": lambda: _spread_world(600),
    "final_scene": _final_world,
}


def _both(world):
    jdata, jmeta = world.compile()
    data, meta = scene_from_numpy(_fields(jdata), _fields(jmeta))
    return jdata, jmeta, data, meta


@pytest.mark.parametrize("name", list(WORLDS))
def test_cluster_boxes_and_tree_equal_jax(name):
    """The "cull" mode's sub-cluster boxes equal the JAX package's (the
    "bvh" mode's tree is the port's own: test_torch_bvh.py)."""
    jdata, jmeta, data, meta = _both(WORLDS[name]())
    want = np.asarray(pal.cluster_boxes(jdata, jmeta, j_quad_frames(jdata)))
    got = ch.cluster_boxes(data, meta)
    # every sub-cluster, padding ones (inverted boxes) included
    np.testing.assert_array_equal(got.numpy(), want)
    real = want[:, 0] <= want[:, 3]
    assert real.any()
    # the packed scene carries them, and the sphere/quad split
    qf = quad_frames(data)
    table, _ = build_prim_table(data, meta, qf)
    packed = ch.pack_scene(data, meta, qf, table, "cull")
    assert packed.accel == "cull" and packed.n_accel == want.shape[0]
    assert packed.n_sph_sub * ch.CL >= packed.n_sph
    n_sph_rows = packed.n_sph_sub * ch.CL
    assert n_sph_rows == (pal._round_up(max(data.sph_center.shape[0],
                                            pal.CK), pal.CK)
                          if meta.n_spheres else 0)


def test_constants_and_auto_accel_match_jax():
    assert (ch.CL, ch.CK, ch.BVH_MIN_PRIMS) == (
        pal.CL, pal.CK, pal.BVH_MIN_PRIMS)
    for n in (0, 1, 485, 3408, 8191, 8192, 8193, 16384):
        assert ch.auto_accel(n) == pal.auto_accel(n)
    assert ch.auto_accel(8192) == "none" and ch.auto_accel(8193) == "bvh"


def _rand_rays(n, seed=3, spread=6.0):
    rng = np.random.RandomState(seed)
    ro = (rng.randn(n, 3) * spread).astype(np.float32)
    rd = rng.randn(n, 3).astype(np.float32)
    tme = rng.rand(n).astype(np.float32)
    return ro, rd, tme


@pytest.mark.parametrize("accel,world,spread", [
    ("cull", lambda: _mixed_world(40, 20), 6.0),
    ("cull", lambda: _mixed_world(30, 6, moving=True), 6.0),
    ("cull", lambda: _spread_world(200), 6.0),
    ("bvh", lambda: _mixed_world(), 6.0),
    ("bvh", lambda: _mixed_world(400, 260, moving=True), 6.0),
    ("bvh", lambda: _spread_world(600), 30.0),
], ids=["cull_mixed", "cull_moving", "cull_spread", "bvh_small",
        "bvh_large_mixed_moving", "bvh_spread"])
def test_mode_matches_jax_interpret_kernel(accel, world, spread):
    jdata, jmeta, data, meta = _both(world())
    ro, rd, tme = _rand_rays(256, spread=spread)
    jqf = j_quad_frames(jdata)
    jtable, _ = j_prim_table(jdata, jmeta, jqf)
    wt, wk, wi, wrow = map(np.asarray, pal.closest_hit_pallas(
        jdata, jmeta, jqf, jtable, jnp.asarray(ro), jnp.asarray(rd),
        jnp.asarray(tme), interpret=True, accel=accel))

    qf = quad_frames(data)
    table, _ = build_prim_table(data, meta, qf)
    packed = ch.pack_scene(data, meta, qf, table, accel)
    before = dict(ch.launch_count)
    t, kind, idx, row = ch.closest_hit(
        packed, V3.from_rows(torch.from_numpy(ro)),
        V3.from_rows(torch.from_numpy(rd)), torch.from_numpy(tme))
    assert ch.launch_count == before      # the CPU takes the plain version
    t, kind, idx, row = t.numpy(), kind.numpy(), idx.numpy(), row.numpy()

    hit = np.isfinite(wt)
    assert hit.any() and (~hit).any()
    assert (np.isfinite(t) == hit).all()
    # test_pallas_kernel.py's bound: both float32, different summation
    # orders of the same expanded quadratic
    np.testing.assert_allclose(t[hit], wt[hit], rtol=3e-5, atol=1e-5)
    np.testing.assert_array_equal(kind[hit], wk[hit])
    np.testing.assert_array_equal(idx[hit], wi[hit])
    np.testing.assert_allclose(row[:ch.ROW_T, hit], wrow[:ch.ROW_T, hit],
                               rtol=1e-6, atol=1e-6)


def test_pack_scene_rejects_unknown_accel():
    jdata, jmeta, data, meta = _both(_mixed_world())
    qf = quad_frames(data)
    table, _ = build_prim_table(data, meta, qf)
    with pytest.raises(ValueError):
        ch.pack_scene(data, meta, qf, table, "kdtree")
