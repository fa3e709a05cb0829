"""The closest hit's backward: the plain mirror of the CUDA kernels' order
of adds, on the CPU.

The kernels (``csrc/closest_hit.cu``, ``closest_hit_bwd_*``) sum each
entry of d_sph, d_quad and d_joined over the lanes whose winner selects it
by pairwise trees: over the lanes of a warp, then the warps of a
``BWD_TILE``-lane tile, then the tiles, each in order.
``closest_hit_bwd_ordered`` is that order in plain torch; on the card the
kernels equal it bit for bit (test_torch_cuda.py, chip_smoke.py phase 9).
Here it is held against the plain version ``closest_hit_bwd_reference``
(index_add_ order: within 1e-4 of each entry's sum of |terms|, d_rays bit
for bit) and against the JAX package's ``_closest_hit_vjp``, and its bits
are shown to depend on the tree.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from chip_smoke import Scene, camera_bounce_rays, moving_mixed_world
from test_torch_closest_hit_grad import _inputs, _mixed_world, _port_grads

from mort_tpu.render import pallas_intersect as pal
from mort_tpu.render.intersect import quad_frames as j_quad_frames
from mort_tpu.render.primtable import build_prim_table as j_prim_table
from mort_tpu_torch.parallel.sharding import _DIFF_FIELDS
from mort_tpu_torch.render import closest_hit as ch
from mort_tpu_torch.render.intersect import K_NONE, K_QUAD, K_SPHERE
from mort_tpu_torch.render.intersect import quad_frames
from mort_tpu_torch.render.primtable import build_prim_table
from mort_tpu_torch.scene import scenes as sc
from mort_tpu_torch.scene.build import scene_from_numpy

SUM_RTOL = 1e-4    # chip_smoke.BWD_SUM_RTOL
N_CAMERA = 1024    # camera rays of a set (and their bounces)


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in
            obj.__dataclass_fields__.values()}


def _pack(world):
    data, meta = world.compile()
    qf = quad_frames(data)
    table, _ = build_prim_table(data, meta, qf)
    return data, ch.pack_scene(data, meta, qf, table, "none")


def _random_rays(n, seed):
    g = np.random.RandomState(seed)
    ro = (g.randn(3, n) * 6).astype(np.float32)
    rd = g.randn(3, n).astype(np.float32)
    tm = g.rand(1, n).astype(np.float32)
    return torch.from_numpy(np.concatenate(
        [ro, rd, tm, np.zeros((1, n), np.float32)]))


def _args(packed, rays, seed, kind=None, idx=None, k_join=None):
    """The backward's arguments: the forward's winner (or the given one)
    and numpy cotangents."""
    R = rays.shape[1]
    if kind is None:
        row = ch.closest_hit_reference(packed, rays)
        kind = row[ch.ROW_KIND].to(torch.int32)
        idx = row[ch.ROW_IDX].to(torch.int32)
    g = np.random.RandomState(seed)
    dt = torch.from_numpy(g.randn(R).astype(np.float32))
    drow = torch.from_numpy(g.randn(ch.ROW_K, R).astype(np.float32))
    n_join = packed.joined.shape[0]
    shape = (n_join, packed.joined.shape[1] if k_join is None else k_join)
    return (rays, kind, idx, dt, drow, packed.sph, packed.quad, shape,
            packed.quad_base, ch.T_MIN)


@pytest.fixture(scope="module")
def sets():
    """{name: (scene, bwd args)}: scene 1's camera rays and their bounces,
    scene 9's (quads; quad_base > 0), and random rays through the moving
    sphere/quad world."""
    cpu = torch.device("cpu")
    out = {}
    for k, (name, (world, cam)) in enumerate((
            ("scene1", sc.random_spheres()),
            ("scene9", sc.final_scene(400, 250, 4)))):
        scene = Scene(world, cpu)
        rays = ch.stack_rays(*camera_bounce_rays(scene, cam, N_CAMERA, cpu))
        out[name] = (scene, _args(scene.packed["none"], rays, 20 + k))
    _data, mixed = _pack(moving_mixed_world())
    out["moving_mixed"] = (None, _args(mixed, _random_rays(4096, 3), 22))
    return out


def _hold(args):
    """The mirror against the plain version: d_rays bit-equal, the tables
    within SUM_RTOL of each entry's sum of |terms|.  Returns the mirror's
    outputs."""
    got = ch.closest_hit_bwd_ordered(*args)
    want = ch.closest_hit_bwd_reference(*args)
    scale = ch.closest_hit_bwd_reference(*args, absolute=True)
    assert torch.equal(got[0], want[0])
    for g, w, s in zip(got[1:], want[1:], scale[1:]):
        assert g.shape == w.shape
        assert bool(((g - w).abs() <= SUM_RTOL * s).all())
    # the columns no lane adds into
    assert not got[1][:, ch.SPH_COLS - 1].any()
    assert not got[2][:, 4:].any()
    return got


def _tree(x):
    """The pairwise tree of a list of float32 values, by its definition:
    the first 2^k (the largest power of two below n) and the rest."""
    if len(x) == 1:
        return x[0]
    half = 1 << ((len(x) - 1).bit_length() - 1)
    return np.float32(_tree(x[:half]) + _tree(x[half:]))


def test_pairwise_segments_is_the_pairwise_tree():
    g = np.random.RandomState(0)
    lens = [1, 2, 3, 5, 7, 8, 9, 31, 32, 33, 64, 100, 257]
    seg = np.repeat(np.arange(len(lens)) * 3, lens)
    vals = (g.randn(len(seg), 2) * 10.0 ** g.randint(-4, 5, (len(seg), 2))
            ).astype(np.float32)
    keys, sums = ch.pairwise_segments(torch.from_numpy(seg),
                                      torch.from_numpy(vals))
    assert keys.tolist() == (np.arange(len(lens)) * 3).tolist()
    starts = np.cumsum([0] + lens)
    for r, (a, b) in enumerate(zip(starts[:-1], starts[1:])):
        for c in range(2):
            want = _tree([np.float32(v) for v in vals[a:b, c]])
            assert sums[r, c].numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("name", ["scene1", "scene9", "moving_mixed"])
def test_ordered_equals_plain(sets, name):
    scene, args = sets[name]
    kind = args[1]
    assert bool((kind == K_SPHERE).any())
    if name != "scene1":
        assert bool((kind == K_QUAD).any()) and args[8] > 0
    got = _hold(args)
    assert bool(got[1].any()) and bool(got[3].any())


def test_ordered_matches_jax_vjp(monkeypatch):
    """The leaf and ray gradients through the JAX package's custom VJP of
    its Pallas kernel (interpret mode) and through the port with the
    mirror as its backward, on test_torch_closest_hit_grad's moving
    sphere/quad world and rays, within its tolerance.  (That tolerance is
    the per-lane formulas' conditioning, not the order of the sums: on
    other rays a near-grazing lane puts the two packages 1e-2 apart with
    either backward of the port, whose two gradients agree within 2e-7 of
    max |g|.)"""
    import jax

    jworld = _mixed_world()
    ro, rd, tme, dt, drow = _inputs()
    jdata, jmeta = jworld.compile()
    data, meta = scene_from_numpy(_fields(jdata), _fields(jmeta))

    def j_fn(leaves, ro_, rd_):
        d = jdata.replace(**leaves)
        qf = j_quad_frames(d)
        table, _ = j_prim_table(d, jmeta, qf)
        t, _k, _i, row = pal.closest_hit_pallas(
            d, jmeta, qf, table, ro_, rd_, jnp.asarray(tme), interpret=True,
            accel="none")
        return t, row

    leaves0 = {k: getattr(jdata, k) for k in _DIFF_FIELDS}
    _, vjp = jax.vjp(j_fn, leaves0, jnp.asarray(ro), jnp.asarray(rd))
    j_leaves, j_ro, j_rd = vjp((jnp.asarray(dt), jnp.asarray(drow)))
    want = {k: np.asarray(v) for k, v in j_leaves.items()}
    want.update(ro=np.asarray(j_ro), rd=np.asarray(j_rd))

    calls = []

    def ordered(*a, **kw):
        calls.append(1)
        return ch.closest_hit_bwd_ordered(*a, **kw)

    monkeypatch.setattr(ch, "closest_hit_bwd_reference", ordered)
    got, _ = _port_grads(data, meta, ro, rd, tme, dt, drow)
    assert calls
    live = 0
    for k, w in want.items():
        g = got[k]
        assert np.isfinite(g).all(), k
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=2e-5 * np.abs(w).max(), err_msg=k)
        live += np.abs(w).max() > 0
    assert live >= 9


def _synthetic(R, kind, idx, k_join=None, seed=5):
    _data, packed = _pack(moving_mixed_world())
    rays = _random_rays(R, seed)
    return _args(packed, rays, seed, torch.as_tensor(kind, dtype=torch.int32),
                 torch.as_tensor(idx, dtype=torch.int32), k_join)


def test_no_hit_lanes():
    R = 300
    got = _hold(_synthetic(R, np.zeros(R), np.zeros(R)))
    assert not any(bool(x.any()) for x in got)


@pytest.mark.parametrize("R", [1, 31, 33, 255, 257, 1000])
def test_one_key_every_lane(R):
    """Every lane on sphere row 3, at lane counts off the warp and the
    tile."""
    args = _synthetic(R, np.full(R, K_SPHERE), np.full(R, 3), seed=R)
    got = _hold(args)
    assert bool(got[1][3, :9].any())
    assert not got[1][torch.arange(got[1].shape[0]) != 3].any()


def test_short_joined_rows_and_zero_cotangents():
    """k_join < 27, and cotangent columns that are zero on every lane: their
    table columns are exactly zero."""
    R = 700
    g = np.random.RandomState(1)
    args = _synthetic(R, g.randint(0, 3, R), g.randint(0, 6, R), k_join=5)
    dt, drow = args[3].clone(), args[4].clone()
    dt.zero_()
    drow[ch.ROW_T] = 0.0
    drow[2] = 0.0
    args = args[:3] + (dt, drow) + args[5:]
    got = _hold(args)
    assert got[3].shape[1] == 5
    # dt and the t row are the only cotangents of t: no record partial
    assert not got[1].any() and not got[2].any() and not got[0].any()
    assert not got[3][:, 2].any() and bool(got[3][:, [0, 1, 3, 4]].all(
        dim=1).any())


def test_keys_on_both_sides_of_quad_base():
    """Sphere row 0 and quad row 0 (key quad_base) interleaved lane by
    lane: each lands in its own table."""
    R = 600
    kind = np.where(np.arange(R) % 3 == 0, K_QUAD, K_SPHERE)
    kind[::7] = K_NONE
    args = _synthetic(R, kind, np.zeros(R))
    got = _hold(args)
    assert args[8] > 0
    assert bool(got[1][0, :9].any()) and bool(got[2][0, :4].any())
    assert bool(got[3][0].any()) and bool(got[3][args[8]].any())
    rows = torch.arange(got[3].shape[0])
    assert not got[3][(rows != 0) & (rows != args[8])].any()


def _level_sums(args, monkeypatch, reverse_last=False):
    """The mirror's sums of scene 1's sphere keys, composed here: levels 1a
    and 1b by ``ordered_sums`` (its last level cut), then level 2 over the
    tiles in order or reversed."""
    rays, kind, idx, dt, drow, sph, quad, shape, quad_base, t_min = args
    _d, (s, js, ts), _q = ch._bwd_lane_terms(rays, kind, idx, dt, drow, sph,
                                             quad, t_min)
    n_join, k_join = shape
    vals = torch.cat([ts, drow[:k_join, s].T], dim=1)
    with monkeypatch.context() as m:
        m.setattr(ch, "BWD_LEVELS", ch.BWD_LEVELS[:2])
        key, part = ch.ordered_sums(s, js, vals, n_join)
    if reverse_last:
        key, part = key.flip(0), part.flip(0)
    order = torch.sort(key, stable=True).indices
    return ch.pairwise_segments(key[order], part[order])


def test_mirror_bits_depend_on_the_tree(sets, monkeypatch):
    """The mirror composed level by level gives its bits; with level 2's
    tiles reversed, scene 1's ground-sphere entries (hit in every tile)
    differ in bits: the card's bit-equality tests the order, not only the
    sum."""
    scene, args = sets["scene1"]
    # seven tiles: reversing a power-of-two count mirrors the tree, and
    # float addition commutes
    R = 6 * ch.BWD_TILE + 100
    rays, kind, idx, dt, drow = (x[..., :R] for x in args[:5])
    args = (rays, kind, idx, dt, drow) + args[5:]
    ground = int(torch.argmax(scene.data.sph_radius))
    mirror = ch.closest_hit_bwd_ordered(*args)
    key, sums = _level_sums(args, monkeypatch)
    at = int((key == ground).nonzero())
    assert torch.equal(sums[at, :9], mirror[1][ground, :9])
    assert torch.equal(sums[at, 9:], mirror[3][ground])
    rkey, rsums = _level_sums(args, monkeypatch, reverse_last=True)
    assert torch.equal(rkey, key)
    assert not torch.equal(rsums[at], sums[at])
    assert torch.allclose(rsums[at], sums[at], rtol=1e-4, atol=1e-4)
