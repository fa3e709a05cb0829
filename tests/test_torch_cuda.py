"""The CUDA closest-hit and Philox kernels against their plain versions, on
the card, and the wavefront spans', the train step's and the lockstep forward's
CUDA graphs against their eager routes.

Marked ``cuda``: without a card every test skips.  Imports no jax, so on a
machine without jax it runs without the repository's conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from chip_smoke import philox_lanes
from mort_tpu_torch import require_cuda, rng
from mort_tpu_torch.camera import derive_basis, get_rays_soa
from mort_tpu_torch.render import closest_hit as ch
from mort_tpu_torch.render import wavefront as wf
from mort_tpu_torch.render.intersect import quad_frames
from mort_tpu_torch.render.primtable import build_prim_table
from mort_tpu_torch.render.vec import V3
from mort_tpu_torch.render.wavefront import render_wavefront
from mort_tpu_torch.scene import scenes as sc
from mort_tpu_torch.scene.build import World

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return require_cuda()


def _mixed_world(n_sph=40, n_quad=20, moving=True):
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


def _packed(world, dev, accel="none"):
    data, meta = world.compile()
    data = data.to(dev)
    qf = quad_frames(data)
    table, _ = build_prim_table(data, meta, qf)
    return ch.pack_scene(data, meta, qf, table, accel)


def _rand_rays(n, dev, seed=3):
    g = np.random.RandomState(seed)
    ro = torch.from_numpy((g.randn(n, 3) * 6).astype(np.float32)).to(dev)
    rd = torch.from_numpy(g.randn(n, 3).astype(np.float32)).to(dev)
    tme = torch.from_numpy(g.rand(n).astype(np.float32)).to(dev)
    return V3.from_rows(ro), V3.from_rows(rd), tme


def _assert_same(packed, ro, rd, tme, need_miss=True):
    before = dict(ch.launch_count)
    t, kind, idx, row = ch.closest_hit(packed, ro, rd, tme)
    torch.cuda.synchronize()
    before[packed.accel] += 1
    assert ch.launch_count == before
    ref = ch.closest_hit_reference(packed, ch.stack_rays(ro, rd, tme))
    # the kernel performs the plain version's ops in the same order, each
    # rounded once (no FMA contraction), and every accel mode keeps the
    # lexicographic (t, row) minimum: the results are bit-identical
    assert torch.equal(row, ref)
    assert torch.equal(t, ref[ch.ROW_T])
    if kind.numel() >= 256:
        assert (kind > 0).any() and ((kind == 0).any() or not need_miss)


@pytest.mark.parametrize("n", [1, 255, 1000, 4096])
def test_kernel_equals_plain_mixed_moving(dev, n):
    _assert_same(_packed(_mixed_world(), dev), *_rand_rays(n, dev))


def test_kernel_equals_plain_quad_only_and_sphere_only(dev):
    for world in (_mixed_world(0, 12), _mixed_world(30, 0, moving=False)):
        _assert_same(_packed(world, dev), *_rand_rays(2048, dev))


def test_kernel_equals_plain_scene1_camera_rays(dev):
    world, cam = sc.random_spheres()
    cam = cam.to(dev)
    g = torch.Generator().manual_seed(0)
    n = 1 << 16
    pix = torch.randint(0, 1200 * 675, (n,), generator=g).to(dev)
    smp = torch.randint(0, 100, (n,), generator=g).to(dev)
    ro, rd, tme = get_rays_soa(cam, derive_basis(cam), 69420, pix, smp,
                               no_defocus=True)
    _assert_same(_packed(world, dev), ro, rd, tme)


def _camera_rays(world_cam, n, dev):
    world, cam = world_cam
    cam = cam.to(dev)
    g = torch.Generator().manual_seed(2)
    pix = torch.randint(0, cam.image_width * cam.image_height, (n,),
                        generator=g).to(dev)
    smp = torch.randint(0, cam.sqrt_spp ** 2, (n,), generator=g).to(dev)
    return get_rays_soa(cam, derive_basis(cam), 69420, pix, smp,
                        no_defocus=True)


@pytest.mark.parametrize("accel", ["none", "bvh", "cull"])
def test_modes_equal_plain_scene9(dev, accel):
    world, cam = sc.final_scene(400, 250, 4)
    ro, rd, tme = _camera_rays((world, cam), 1 << 14, dev)
    # every camera ray of scene 9 hits something
    _assert_same(_packed(world, dev, accel), ro, rd, tme, need_miss=False)
    # and from random origins in and around the scene, random directions
    g = np.random.RandomState(4)
    ro = torch.from_numpy((g.randn(4096, 3) * 1500).astype(np.float32)
                          ).to(dev)
    rd = torch.from_numpy(g.randn(4096, 3).astype(np.float32)).to(dev)
    _assert_same(_packed(world, dev, accel), V3.from_rows(ro),
                 V3.from_rows(rd), torch.rand(4096, device=dev))


@pytest.mark.parametrize("accel", ["none", "bvh", "cull"])
def test_modes_equal_plain_spread16k(dev, accel):
    world, cam = sc.spread_spheres()
    assert ch.auto_accel(16384) == "bvh"
    ro, rd, tme = _camera_rays((world, cam), 1 << 14, dev)
    _assert_same(_packed(world, dev, accel), ro, rd, tme)
    _assert_same(_packed(world, dev, accel), *_rand_rays(4096, dev))


@pytest.fixture(scope="module")
def box_world():
    """final_scene(quick=True) on the card (36 closed boxes): packed "none"
    tables and chip_smoke.py's rays at the boxes' edges and corners (from
    the camera, far points, box faces and box insides in turn, 15% with a
    direction component under 1e-8)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    from chip_smoke import box_bounds, box_edge_rays

    dev = require_cuda()
    world, cam = sc.final_scene(400, 16, 4, quick=True)
    data, meta = world.compile()
    rays = box_edge_rays(*box_bounds(data, meta), cam.lookfrom, 1 << 16, 6)
    return _packed(world, dev), rays.to(dev)


@pytest.mark.parametrize("n", [1, 255, 4096, 1 << 16])
def test_none_box_cull_equals_plain_on_edge_rays(box_world, n):
    """The "none" kernel's box path, bit-equal to the plain version on rays
    that graze box edges and corners, at ragged counts; its counted launch
    too."""
    packed, rays = box_world
    rays = rays[:, :n].contiguous()
    want = ch.closest_hit_reference(packed, rays)
    before = ch.launch_count["none"]
    got = ch._launch(packed, rays, ch.T_MIN)
    counts = torch.zeros(ch.N_TESTS, dtype=torch.int64, device=rays.device)
    counted = ch._launch(packed, rays, ch.T_MIN, counts)
    torch.cuda.synchronize()
    assert ch.launch_count["none"] == before + 2
    assert torch.equal(got, want) and torch.equal(counted, want)
    n_s, n_q, n_b, n_a, n_p = counts.tolist()
    surf_q = int((packed.quad[:packed.n_quad, 12] != 0).sum())
    assert n_s == n * packed.n_sph and n_b == n * 36
    # the lamp, the one quad outside the boxes, takes the axis-aligned path
    assert n_a == n and n_q + n_a <= n * surf_q


@pytest.fixture(scope="module")
def bvh_sets():
    """The "bvh" kernel's ray sets on the card: 2^16 camera rays of the
    16,384-sphere scene, and chip_smoke.py's 2^16 rays grazing scene 1's
    sphere silhouettes (the r = 1000 ground among them), each with its
    scene packed "bvh" and "cull"."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    from chip_smoke import silhouette_rays

    dev = require_cuda()
    world16, cam16 = sc.spread_spheres()
    rays16 = ch.stack_rays(*_camera_rays((world16, cam16), 1 << 16, dev))
    world1, cam1 = sc.random_spheres()
    data1, meta1 = world1.compile()
    silhouettes = silhouette_rays(data1, meta1, cam1.lookfrom, 1 << 16, 14)
    return {"spread16k": ({m: _packed(world16, dev, m)
                           for m in ("bvh", "cull")}, rays16),
            "silhouettes": ({m: _packed(world1, dev, m)
                             for m in ("bvh", "cull")}, silhouettes.to(dev))}


def _counted_equals_plain(packed, rays):
    """The kernel bit-equal to the plain version, its counted launch too;
    returns the (sphere, quad, slab, axis-aligned quad) tests counted."""
    want = ch.closest_hit_reference(packed, rays)
    before = ch.launch_count[packed.accel]
    got = ch._launch(packed, rays, ch.T_MIN)
    counts = torch.zeros(ch.N_TESTS, dtype=torch.int64, device=rays.device)
    counted = ch._launch(packed, rays, ch.T_MIN, counts)
    torch.cuda.synchronize()
    assert ch.launch_count[packed.accel] == before + 2
    assert torch.equal(got, want) and torch.equal(counted, want)
    return counts.tolist()


@pytest.mark.parametrize("n", [1, 255, 4096, 1 << 16])
@pytest.mark.parametrize("case", ["spread16k", "silhouettes"])
def test_bvh_equals_plain(bvh_sets, case, n):
    """The "bvh" kernel bit-equal to the plain version at ragged counts,
    its counted launch too, and the tree prunes: a ray tests a few rows."""
    packed, rays = bvh_sets[case]
    packed = packed["bvh"]
    n_s, n_q, n_b, n_a, n_p = _counted_equals_plain(packed,
                                               rays[:, :n].contiguous())
    assert n_b > 0 and n_b % 2 == 0 and n_a == 0
    assert n_s + n_q < 0.05 * n * (packed.n_sph + packed.n_quad)


@pytest.mark.parametrize("n", [255, 1 << 16])
def test_cull_equals_plain_on_silhouettes(bvh_sets, n):
    """The "cull" kernels, whose boxes are widened as "bvh"'s are, bit-equal
    to the plain version on the rays grazing scene 1's silhouettes; each
    ray slab-tests every box once."""
    packed, rays = bvh_sets["silhouettes"]
    packed = packed["cull"]
    n_s, n_q, n_b, n_a, n_p = _counted_equals_plain(packed,
                                               rays[:, :n].contiguous())
    assert 0 < n_s < n * packed.n_sph and n_q == n_a == 0
    assert n_b == n * packed.n_accel


@pytest.fixture(scope="module")
def cull_scene9():
    """Scene 9 packed "cull" on the card and 2^16 + 1 of its camera and
    bounce rays (a ragged count)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    dev = require_cuda()
    world, cam = sc.final_scene(400, 250, 4)
    packed = _packed(world, dev, "cull")
    rays = ch.stack_rays(*_camera_rays((world, cam), 1 << 15, dev))
    t = ch.closest_hit_reference(packed, rays)[ch.ROW_T]
    g = np.random.RandomState(9)
    bounce = torch.cat([rays[0:3] + rays[3:6] * t, torch.from_numpy(
        g.randn(3, rays.shape[1]).astype(np.float32)).to(dev), rays[6:]])
    rays = torch.cat([rays, bounce[:, torch.isfinite(t)]], 1)
    return packed, rays[:, :(1 << 16) + 1].contiguous()


@pytest.mark.parametrize("n", [1, 31, 255, 257, 1000, (1 << 16) + 1,
                               (1 << 18) + (1 << 16) + 3])
def test_cull_three_launches_bit_identical(cull_scene9, n):
    """Three launches of the "cull" kernels on scene 9's rays give the same
    bits, the plain version's, at counts off the warp and the block (the
    last, over 1024 tiles, scans each bin's tiles in two rounds): the keys'
    integer minimum does not depend on the order of the atomics."""
    packed, rays = cull_scene9
    rays = rays.repeat(1, -(-n // rays.shape[1]))[:, :n].contiguous()
    want = ch.closest_hit_reference(packed, rays)
    before = ch.launch_count["cull"]
    runs = [ch._launch(packed, rays, ch.T_MIN) for _ in range(3)]
    torch.cuda.synchronize()
    assert ch.launch_count["cull"] == before + 3
    for got in runs:
        assert torch.equal(got, want)


@pytest.mark.parametrize("n, rays_a_launch", [(37, 1), (4099, 1000)])
def test_cull_split_launches_equal_one(cull_scene9, monkeypatch, n,
                                       rays_a_launch):
    """A ray set split over several "cull" launches (CULL_MAX_PAIRS cut to
    ``rays_a_launch`` rays of scene 9's sub-clusters) gives the plain
    version's bits and the tests and pairs of one launch, one launch count
    a slice."""
    packed, rays = cull_scene9
    rays = rays[:, :n].contiguous()
    want = ch.closest_hit_reference(packed, rays)
    one = torch.zeros(ch.N_TESTS, dtype=torch.int64, device=rays.device)
    assert torch.equal(ch._launch(packed, rays, ch.T_MIN, one), want)
    monkeypatch.setattr(ch, "CULL_MAX_PAIRS", rays_a_launch * packed.n_accel)
    slices = ch.cull_slices(n, packed.n_accel)
    assert len(slices) == -(-n // rays_a_launch)
    split = torch.zeros_like(one)
    before = ch.launch_count["cull"]
    got = ch._launch(packed, rays, ch.T_MIN, split)
    torch.cuda.synchronize()
    assert ch.launch_count["cull"] == before + len(slices)
    assert torch.equal(got, want)
    assert torch.equal(split, one)


def _row_world(n=512):
    """n spheres on the x axis, 5 apart: the builder's Morton order is x's,
    so the four sub-clusters' boxes lie side by side."""
    g = np.random.RandomState(5)
    w = World()
    m = w.lambertian(w.solid_color([0.5, 0.5, 0.5]))
    for i in range(n):
        w.sphere([i * 5.0 - n * 2.5, 0.0, 0.0], 0.5 + g.rand(), m)
    return w


def _one_box_rays(packed, n, dev, k=1, seed=0):
    """n rays straight down (-y) onto the xz rectangle of cull box k, at
    least 3 units away from every other box's (more than a ray's own
    widening, make_slab): each enters box k alone."""
    box = packed.accel_tab.cpu().double()
    real = box[:, 0] <= box[:, 3]
    lo, hi = box[k, [0, 2]] + 1.0, box[k, [3, 5]] - 1.0
    g = np.random.RandomState(seed)
    xz = torch.from_numpy(g.uniform(lo.numpy(), hi.numpy(), (4 * n, 2)))
    alone = torch.ones(4 * n, dtype=torch.bool)
    for j in range(box.shape[0]):
        if j != k and real[j]:
            alone &= ~((xz >= box[j, [0, 2]] - 3.0)
                       & (xz <= box[j, [3, 5]] + 3.0)).all(dim=1)
    xz = xz[alone][:n]
    assert xz.shape[0] == n
    rays = torch.zeros(8, n)
    rays[0], rays[2] = xz[:, 0].float(), xz[:, 1].float()
    rays[1] = float(box[k, 4]) + 50.0
    rays[4] = -1.0
    rays[6] = torch.from_numpy(g.rand(n).astype(np.float32))
    return rays.to(dev)


def test_cull_every_ray_one_sub_cluster(dev):
    """Every ray enters one sub-cluster, the same: one bin of 2^16 rays in
    512 chunks.  Bit-equal to the plain version, and each ray tests that
    sub-cluster's 128 spheres and no other."""
    packed = _packed(_row_world(), dev, "cull")
    n = 1 << 16
    rays = _one_box_rays(packed, n, dev)
    n_s, n_q, n_b, n_a, n_p = _counted_equals_plain(packed, rays)
    assert n_s == n * ch.CL and n_q == n_a == 0
    assert n_b == n * packed.n_accel


def test_cull_no_ray_enters(dev):
    """Rays that enter no box (empty bins): every ray misses, bit-equal to
    the plain version, and no sphere or quad is tested."""
    world, _ = sc.final_scene(400, 250, 4)
    packed = _packed(world, dev, "cull")
    n = 4099
    g = np.random.RandomState(2)
    d = g.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = torch.zeros(8, n)
    rays[0:3] = torch.from_numpy(d.T * 1e5)
    rays[3:6] = torch.from_numpy(d.T)
    rays = rays.to(dev)
    n_s, n_q, n_b, n_a, n_p = _counted_equals_plain(packed, rays)
    assert n_s == n_q == n_a == 0 and n_b == n * packed.n_accel
    out = ch.closest_hit_reference(packed, rays)
    assert not bool((out[ch.ROW_KIND] > 0).any())


def test_cull_replays_from_a_cuda_graph(cull_scene9):
    """The "cull" call captured in a CUDA graph (no host sync in it: its
    scratch is sized from R and n_sub, its test grid from the card) and
    replayed on new rays equals an eager call on them."""
    packed, rays = cull_scene9
    n = 1 << 14
    static = rays[:, :n].clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ch._launch(packed, static, ch.T_MIN)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ch._launch(packed, static, ch.T_MIN)
    for lo in (n, 2 * n):
        static.copy_(rays[:, lo:lo + n])
        graph.replay()
        torch.cuda.synchronize()
        want = ch._launch(packed, static.clone(), ch.T_MIN)
        assert torch.equal(out, want)
        assert torch.equal(out, ch.closest_hit_reference(packed, static))


@pytest.fixture(scope="module")
def aaq_sets():
    """Scenes 5 and 6 packed "none" on the card, each with 2^16 camera and
    bounce rays of its camera and 2^16 of chip_smoke.py's rays at the
    window edges of its axis-aligned quads (15% with a direction component
    under 1e-8)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    from chip_smoke import window_edge_rays

    dev = require_cuda()
    out = {}
    for idx in (5, 6):
        world, cam = sc.build_scene(idx)
        data, meta = world.compile()
        packed = _packed(world, dev)
        ro, rd, tme = _camera_rays((world, cam), 1 << 15, dev)
        rays = ch.stack_rays(ro, rd, tme)
        t = ch.closest_hit_reference(packed, rays)[ch.ROW_T]
        g = np.random.RandomState(idx)
        bounce = torch.cat([rays[0:3] + rays[3:6] * t, torch.from_numpy(
            g.randn(3, rays.shape[1]).astype(np.float32)).to(dev), rays[6:]])
        bounce = bounce[:, torch.isfinite(t)]
        out[f"scene{idx}"] = (packed, torch.cat([rays, bounce], 1)[
            :, :1 << 16].contiguous())
        out[f"scene{idx}_edges"] = (packed, window_edge_rays(
            data, meta, cam.lookfrom, 1 << 16, 20 + idx).to(dev))
    return out


@pytest.mark.parametrize("n", [1, 255, 4096, 1 << 16])
@pytest.mark.parametrize("case", ["scene5", "scene5_edges", "scene6",
                                  "scene6_edges"])
def test_none_aaq_equals_plain(aaq_sets, case, n):
    """The "none" kernel's axis-aligned quad path, bit-equal to the plain
    version at ragged counts, its counted launch too: on scene 5 every
    quad test is an axis-aligned one."""
    packed, rays = aaq_sets[case]
    n = min(n, rays.shape[1])
    n_s, n_q, n_b, n_a, n_p = _counted_equals_plain(packed,
                                               rays[:, :n].contiguous())
    n_aaq = packed.aaq_tab.shape[0]
    assert n_a == n * n_aaq and n_b == 0
    if case.startswith("scene5"):
        assert n_aaq == 5 and n_q == 0 and n_s == 0
    else:
        assert n_aaq == 6 and n_q == n * packed.gen_rows.numel()


def test_wrapper_rejects_bad_inputs(dev):
    packed = _packed(_mixed_world(), dev)
    ro, rd, tme = _rand_rays(64, dev)
    rays = ch.stack_rays(ro, rd, tme)
    with pytest.raises(ValueError):
        ch._launch(packed, rays.double(), 1e-3)
    with pytest.raises(ValueError):
        ch._launch(packed, rays[:7].contiguous(), 1e-3)
    with pytest.raises(ValueError):
        ch._launch(packed, rays.t().contiguous().t(), 1e-3)
    with pytest.raises(ValueError):
        ch._launch(packed, rays, 1e-3, torch.zeros(2, dtype=torch.int64,
                                                   device=dev))
    with pytest.raises(ValueError):
        ch._launch(dataclasses.replace(packed, gen_rows=torch.cat(
            [packed.gen_rows, packed.gen_rows])), rays, 1e-3)


def test_render_kernel_vs_plain(dev):
    world, cam = sc.random_spheres()
    data, meta = world.compile()
    cam = cam.replace(image_width=64, image_height=36, sqrt_spp=2,
                      bounce_limit=8)
    a = render_wavefront(data, meta, cam, dev, seed=9)
    b = render_wavefront(data, meta, cam, dev, seed=9, use_kernel=False)
    # identical closest hits; the framebuffer's atomic adds may reorder
    np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("accel", ["none", "bvh", "cull"])
def test_render_modes_vs_plain_scene9(dev, accel):
    world, cam = sc.final_scene(400, 250, 4)
    data, meta = world.compile()
    cam = cam.replace(image_width=48, image_height=48, sqrt_spp=2)
    before = dict(ch.launch_count)
    a = render_wavefront(data, meta, cam, dev, seed=9, accel=accel)
    assert ch.launch_count[accel] > before[accel]
    b = render_wavefront(data, meta, cam, dev, seed=9, use_kernel=False)
    np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=1e-4,
                               atol=1e-5)


def _bwd_args(packed, n, dev, seed=5):
    ro, rd, tme = _rand_rays(n, dev)
    rays = ch.stack_rays(ro, rd, tme)
    row = ch._launch(packed, rays, 1e-3)
    g = np.random.RandomState(seed)
    dt = torch.from_numpy(g.randn(n).astype(np.float32)).to(dev)
    drow = torch.from_numpy(g.randn(ch.ROW_K, n).astype(np.float32)).to(dev)
    return (rays, row[ch.ROW_KIND].to(torch.int32),
            row[ch.ROW_IDX].to(torch.int32), dt, drow, packed.sph,
            packed.quad, tuple(packed.joined.shape), packed.quad_base, 1e-3)


def test_backward_kernel_equals_plain(dev):
    """d_rays bit-equal to the plain version (every lane's value is its
    rounded ops in its order); the table gradients bit-equal to the plain
    mirror of the kernels' order of adds, and within 1e-4 of each entry's
    sum of |terms| of the plain version's index_add_ order."""
    args = _bwd_args(_packed(_mixed_world(), dev), 4096, dev)
    before = ch.launch_count["bwd"]
    got = ch._launch_bwd(*args)
    torch.cuda.synchronize()
    assert ch.launch_count["bwd"] == before + 1
    want = ch.closest_hit_bwd_reference(*args)
    scale = ch.closest_hit_bwd_reference(*args, absolute=True)
    ordered = ch.closest_hit_bwd_ordered(*args)
    assert torch.equal(got[0], want[0])
    assert bool((got[1] != 0).any()) and bool((got[3] != 0).any())
    for g, o in zip(got, ordered):
        assert torch.equal(g, o)
    for g, w, s in zip(got[1:], want[1:], scale[1:]):
        assert bool(((g - w).abs() <= 1e-4 * s).all())


@pytest.mark.parametrize("shape", ["spheres", "quads", "mixed"])
@pytest.mark.parametrize("R", [1, 31, 255, 4096, 2 ** 16 + 3,
                               5 * 2 ** 16 + 3])
def test_backward_deterministic_and_ordered(dev, R, shape):
    """Three launches give the same bits, the plain mirror's of their order
    (``closest_hit_bwd_ordered``), at lane counts off the tile and the warp,
    on spheres only, quads only and both; above 4096 lanes four in five
    are given the first sphere or quad as their winner: 257 and 1,281
    tiles' runs on one key (9 and 41 level-2 chunks: one group of 32 and
    two)."""
    n_sph, n_quad = {"spheres": (40, 0), "quads": (0, 20),
                     "mixed": (40, 20)}[shape]
    packed = _packed(_mixed_world(n_sph, n_quad, moving=True), dev)
    args = _bwd_args(packed, R, dev, seed=R)
    if R > 4096:
        # most lanes on the first surface row: a dominant key, as scene
        # 1's ground sphere
        kind, idx = args[1].clone(), args[2].clone()
        lead = torch.arange(R, device=dev) % 5 != 0
        kind[lead] = ch.K_SPHERE if n_sph else ch.K_QUAD
        idx[lead] = 0
        args = (args[0], kind, idx) + args[3:]
    before = ch.launch_count["bwd"]
    runs = [ch._launch_bwd(*args) for _ in range(3)]
    torch.cuda.synchronize()
    assert ch.launch_count["bwd"] == before + 3
    ordered = ch.closest_hit_bwd_ordered(*args)
    for got in runs:
        for g, o in zip(got, ordered):
            assert torch.equal(g, o)
    want = ch.closest_hit_bwd_reference(*args)
    scale = ch.closest_hit_bwd_reference(*args, absolute=True)
    for g, w, s in zip(runs[0][1:], want[1:], scale[1:]):
        assert bool(((g - w).abs() <= 1e-4 * s).all())


def test_train_step_card_vs_cpu(dev):
    """A 16x16 Cornell box train step through the kernels on the card
    against the same step through their plain versions on the CPU."""
    from mort_tpu_torch import make_train_step, render

    world, cam = sc.cornell_box()
    data, meta = world.compile()
    cam = cam.replace(image_width=16, image_height=16, sqrt_spp=2,
                      bounce_limit=6)
    target = render(data, meta, cam, seed=3).cpu().numpy() * 0.9
    before = dict(ch.launch_count)
    loss, grads = make_train_step(meta)(data, cam, target, 7)
    torch.cuda.synchronize()
    assert ch.launch_count["none"] == before["none"] + 4 * 6
    assert ch.launch_count["bwd"] == before["bwd"] + 4 * 6
    c_loss, c_grads = make_train_step(meta, device="cpu", use_kernel=True)(
        data, cam, target, 7)
    torch.testing.assert_close(loss.cpu(), c_loss, rtol=1e-4, atol=0.0)
    scale = max(float(g.abs().max()) for g in c_grads.values())
    for k, g in grads.items():
        assert bool(torch.isfinite(g).all()), k
        # CUDA's and the CPU's exp, log, sin and pow may differ in the last
        # bit, and the sums run in another order
        torch.testing.assert_close(g.cpu(), c_grads[k], rtol=1e-3,
                                   atol=1e-5 * scale)


def test_progressive_resume_bit_identical_on_card(dev, tmp_path):
    """The progressive wavefront on the card, interrupted after one step and
    resumed from its checkpoint in a fresh call, equals the uninterrupted
    render bit for bit: layer-aligned spans deposit each pixel once per
    layer, so index_add_ never adds one pixel twice in a call."""
    from mort_tpu_torch.render.progressive import (
        load_state, render_progressive_wavefront,
    )

    world, cam = sc.cornell_box()
    data, meta = world.compile()
    cam = cam.replace(image_width=48, image_height=48, sqrt_spp=3,
                      bounce_limit=8)
    before = ch.launch_count["none"]
    full = render_progressive_wavefront(data, meta, cam, spt=3)
    assert ch.launch_count["none"] > before
    ckpt = str(tmp_path / "wf.npz")

    class Stop(BaseException):
        pass

    def stop(state):
        raise Stop

    with pytest.raises(Stop):
        render_progressive_wavefront(data, meta, cam, spt=3,
                                     checkpoint_path=ckpt, on_step=stop)
    state = load_state(ckpt)
    assert state.samples_done == 3
    resumed = render_progressive_wavefront(data, meta, cam, spt=3,
                                           state=state)
    assert np.isfinite(full.fb).all() and np.array_equal(resumed.fb,
                                                         full.fb)


def test_cli_render_on_card(dev, tmp_path, capsys):
    """``cli render`` without --device runs on the card and writes a finite
    image (the kernel launched)."""
    from mort_tpu_torch import cli

    out = str(tmp_path / "s5.npz")
    before = ch.launch_count["none"]
    rec = cli.main(["render", "5", "--width", "48", "--spp", "4",
                    "--depth", "8", "--out", out])
    img = np.load(out)["image"]
    assert ch.launch_count["none"] > before
    assert img.shape == (48, 48, 3) and np.isfinite(img).all()
    assert 0.0 < float(img.mean()) < 2.0 and rec["paths"] == 48 * 48 * 4


def test_one_rank_nccl_mesh_on_card(dev, tmp_path):
    """The sharded paths on a 1-rank NCCL group: ``render_wavefront`` over
    ``make_mesh(1)`` launches the kernel and is bit-equal to the render
    without a mesh over layer-aligned spans; the sharded train step runs
    one all-reduce (its flat gradient bucket) and gives the single-device
    step; ``render_sharded`` gives the lockstep ``render``."""
    import datetime

    import torch.distributed as dist
    from mort_tpu_torch import (
        make_mesh, make_train_step, render, render_sharded,
    )

    dist.init_process_group(
        "nccl", init_method=f"file://{tmp_path / 'store'}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh(1)
        assert mesh.device == dev and mesh.groups == (None,)
        world, cam = sc.random_spheres()
        data, meta = world.compile()
        cam = cam.replace(image_width=64, image_height=36, sqrt_spp=2,
                          bounce_limit=8)
        before = dict(ch.launch_count)
        img, stats = render_wavefront(data, meta, cam, mesh=mesh,
                                      return_stats=True)
        torch.cuda.synchronize()
        assert ch.launch_count["none"] > before["none"]
        assert stats["collectives"] == {"spans": 0, "gather": 1, "stats": 1}
        n_chunks = -(-cam.sqrt_spp ** 2 // min(cam.sqrt_spp ** 2, 8))
        want = render_wavefront(data, meta, cam, dev,
                                layer_range=(0, n_chunks))
        assert img.device == dev and torch.equal(img, want)

        target = want.cpu().numpy() * 0.9
        step = make_train_step(meta, mesh)
        before = dict(ch.launch_count)
        loss, grads = step(data, cam, target, 7)
        torch.cuda.synchronize()
        assert ch.launch_count["bwd"] > before["bwd"]
        assert step.collectives["all_reduce"] == 1
        w_loss, w_grads = make_train_step(meta)(data, cam, target, 7)
        torch.testing.assert_close(loss, w_loss, rtol=1e-4, atol=0.0)
        for k, g in grads.items():
            assert bool(torch.isfinite(g).all()), k
            torch.testing.assert_close(g, w_grads[k], rtol=1e-3, atol=1e-6)
        # the mesh's captured step against its eager step (the all-reduce
        # runs after the replay, outside the graph)
        _assert_step_routes(meta, data, cam, target, "none", 4 * 8,
                            mesh=mesh)

        sharded = render_sharded(data, meta, cam, mesh)
        lock = render(data, meta, cam).cpu().numpy()
        assert sharded.shape == lock.shape
        np.testing.assert_allclose(sharded, lock, rtol=0.0, atol=1e-5)
    finally:
        dist.destroy_process_group()


def test_intersect_world_card_vs_cpu(dev):
    """``intersect_world`` on scene 7 (two media): the kernel route on the
    card against the plain route on the CPU — hit and material exact, t
    and the gathered attributes within a few ulps (the CPU's float32 sqrt
    is not correctly rounded)."""
    from mort_tpu_torch.render.intersect import intersect_world

    world, cam = sc.build_scene(7)
    data, meta = world.compile()
    g = np.random.RandomState(5)
    R = 1 << 14
    ro = np.repeat(cam.lookfrom.numpy()[None], R, 0).astype(np.float32)
    ro[R // 2:] = g.uniform(50, 505, (R // 2, 3))
    rd = g.uniform(0, 555, (R, 3)).astype(np.float32) - ro
    args = [torch.from_numpy(x) for x in
            (ro, rd, g.uniform(0, 1, R).astype(np.float32))]
    pix = torch.from_numpy(g.randint(0, 600 * 600, R))
    smp = torch.from_numpy(g.randint(0, 64, R))
    want = intersect_world(data, meta, quad_frames(data), *args, 69420, pix,
                           smp, 2)
    dd = data.to(dev)
    got = intersect_world(dd, meta, quad_frames(dd),
                          *(a.to(dev) for a in args), 69420, pix.to(dev),
                          smp.to(dev), 2)
    assert torch.equal(got.hit.cpu(), want.hit)
    assert torch.equal(got.mat.cpu(), want.mat)
    for name in ("t", "p", "normal", "u", "v"):
        torch.testing.assert_close(getattr(got, name).cpu(),
                                   getattr(want, name), rtol=4e-6,
                                   atol=4e-6 * 555, msg=name)


def _images_close(got, want, frac_ok=0.98, atol=2e-2, mean_tol=4e-3):
    """tests/conftest.py's image rule (that conftest imports jax)."""
    diff = np.abs(np.asarray(got) - np.asarray(want))
    assert diff.shape == np.asarray(want).shape
    frac = float(np.mean(np.all(diff <= atol, axis=-1)))
    assert frac >= frac_ok and float(diff.mean()) <= mean_tol, (
        frac, float(diff.mean()))


def _both_routes(monkeypatch, fn):
    """``fn()`` on the spans' graph route, then on the eager route
    (``_span_core``'s private ``eager``); for each, its result, the
    closest-hit launches and the spans' graph counts it added."""
    out = []
    for eager in (False, True):
        with monkeypatch.context() as m:
            if eager:
                m.setattr(wf, "_span_core",
                          functools.partial(wf._span_core, eager=True))
            torch.cuda.synchronize()
            launches, graphs = dict(ch.launch_count), dict(wf.graph_count)
            res = fn()
            torch.cuda.synchronize()
            out.append((res, {k: ch.launch_count[k] - n
                              for k, n in launches.items()},
                        {k: wf.graph_count[k] - n
                         for k, n in graphs.items()}))
    return out


def _assert_routes_equal(graph, eager, accel, spans, captures=1):
    """Bit-equal images (raw int32 views), equal stats and launches; the
    graph route captured ``captures`` times over its ``spans`` spans (once
    a key: 1 for a new key, 0 for a kept one) and replayed every round
    after the key's first, the eager one never."""
    (g_img, g_stats), g_launch, g_count = graph
    (e_img, e_stats), e_launch, e_count = eager
    assert torch.equal(g_img.view(torch.int32), e_img.view(torch.int32))
    assert g_stats == e_stats
    assert g_launch == e_launch and g_launch[accel] > 0
    assert e_count["captures"] == e_count["replays"] == 0
    assert g_count["captures"] == captures and g_count["spans"] == spans
    assert g_count["rounds"] == e_count["rounds"]
    assert g_count["replays"] == g_count["rounds"] - captures > 0


@pytest.mark.parametrize("accel", ["none", "bvh", "cull"])
def test_span_graph_equals_eager_scene9(dev, monkeypatch, accel):
    """Scene 9 at 100x100, 16 spp, depth 4: the captured rounds give the
    eager rounds' image bit for bit over layer-aligned spans (each pixel
    deposits once a span, so index_add_'s atomic order cannot show), the
    same rounds, useful segments and kernel launches; over the default
    spans the images pass the image rule."""
    wf.drop_graph()
    world, cam = sc.final_scene(400, 250, 4)
    data, meta = world.compile()
    cam = cam.replace(image_width=100, image_height=100, sqrt_spp=4)
    graph, eager = _both_routes(monkeypatch, lambda: render_wavefront(
        data, meta, cam, dev, seed=9, accel=accel, layer_range=(0, 2),
        return_stats=True))
    _assert_routes_equal(graph, eager, accel, spans=2)
    (g_img, g_launch, g_count), (e_img, e_launch, _) = _both_routes(
        monkeypatch, lambda: render_wavefront(data, meta, cam, dev, seed=9,
                                              accel=accel))
    assert g_count["replays"] > 0 and g_launch == e_launch
    _images_close(g_img.cpu().numpy(), e_img.cpu().numpy())


def test_span_graph_equals_eager_spread16k(dev, monkeypatch):
    """The 16,384-sphere scene at 160x90, 4 spp, depth 4 (auto accel
    "bvh"): graph and eager routes bit-equal over layer-aligned spans."""
    wf.drop_graph()
    world, cam = sc.spread_spheres()
    data, meta = world.compile()
    cam = cam.replace(image_width=160, image_height=90, sqrt_spp=2,
                      bounce_limit=4)
    graph, eager = _both_routes(monkeypatch, lambda: render_wavefront(
        data, meta, cam, dev, seed=9, layer_range=(0, 1),
        return_stats=True))
    _assert_routes_equal(graph, eager, "bvh", spans=1)


def test_span_graph_equals_eager_progressive(dev, monkeypatch):
    """Progressive scene 6 (48x48, 9 spp, spt 3: three layers, a span
    each) through both routes: the same bits, launches and rounds."""
    wf.drop_graph()
    from mort_tpu_torch.render.progressive import (
        render_progressive_wavefront,
    )

    world, cam = sc.cornell_box()
    data, meta = world.compile()
    cam = cam.replace(image_width=48, image_height=48, sqrt_spp=3,
                      bounce_limit=8)
    graph, eager = _both_routes(monkeypatch, lambda: (
        torch.from_numpy(render_progressive_wavefront(
            data, meta, cam, spt=3).fb), {}))
    _assert_routes_equal(graph, eager, "none", spans=3)


def _scene9_small():
    world, cam = sc.final_scene(400, 250, 4)
    data, meta = world.compile()
    return data, meta, cam.replace(image_width=100, image_height=100,
                                   sqrt_spp=4)


@pytest.mark.parametrize("accel", ["none", "bvh", "cull"])
def test_span_graph_kept_across_calls(dev, monkeypatch, accel):
    """Scene 9 at 100x100, 16 spp, depth 4, over layer-aligned spans: two
    calls of one key with the seed, the camera's ``lookfrom`` and a
    sphere's centre changed between them each give the eager route's bits,
    stats and launches; one capture over both calls, and the second runs
    no eager round (every round a replay)."""
    wf.drop_graph()
    data, meta, cam = _scene9_small()
    centre = data.sph_center.clone()
    centre[5] += torch.tensor([3.0, -2.0, 1.0])
    calls = [(data, cam, 9),
             (dataclasses.replace(data, sph_center=centre),
              cam.replace(lookfrom=cam.lookfrom + torch.tensor(
                  [-20.0, 5.0, 10.0])), 10)]
    for k, (d, c, seed) in enumerate(calls):
        graph, eager = _both_routes(monkeypatch, lambda: render_wavefront(
            d, meta, c, dev, seed=seed, accel=accel, layer_range=(0, 2),
            return_stats=True))
        _assert_routes_equal(graph, eager, accel, spans=2, captures=1 - k)
        assert graph[2]["recaptures"] == 0


def test_span_graph_mesh_captures_once(dev, monkeypatch):
    """Scene 1 at 200x112, 16 spp, depth 20 through ``make_mesh(1)`` (its
    spans layer-aligned, two): one capture for the call, none for a second
    call at another seed; both bit-equal to the eager route."""
    from mort_tpu_torch import make_mesh

    wf.drop_graph()
    world, cam = sc.random_spheres()
    data, meta = world.compile()
    cam = cam.replace(image_width=200, image_height=112, sqrt_spp=4)
    mesh = make_mesh(1)
    for k, seed in enumerate((9, 10)):
        graph, eager = _both_routes(monkeypatch, lambda: render_wavefront(
            data, meta, cam, seed=seed, mesh=mesh, return_stats=True))
        _assert_routes_equal(graph, eager, "none", spans=2, captures=1 - k)


def test_span_graph_new_key_recaptures(dev):
    """A new pool (a field of the key) drops the kept program and captures
    again, counting a recapture; the same key again does not."""
    wf.drop_graph()
    data, meta, cam = _scene9_small()
    for k, pool in enumerate((1 << 16, 1 << 15, 1 << 15)):
        before = dict(wf.graph_count)
        render_wavefront(data, meta, cam, dev, seed=9, pool=pool)
        moved = {k: wf.graph_count[k] - n for k, n in before.items()}
        assert moved["captures"] == (1, 1, 0)[k], moved
        assert moved["recaptures"] == (0, 1, 0)[k], moved
        assert moved["replays"] == moved["rounds"] - moved["captures"]


def _steps(meta, data, cam, target, eager, seeds, **kw):
    """``make_train_step(meta, _eager=eager, **kw)`` at each seed: for each
    call its result, the closest-hit launches and the step graph counts it
    added."""
    from mort_tpu_torch import make_train_step
    from mort_tpu_torch.parallel import sharding

    step = make_train_step(meta, _eager=eager, **kw)
    runs = []
    for seed in seeds:
        torch.cuda.synchronize()
        launches = dict(ch.launch_count)
        counts = dict(sharding.step_graph_count)
        res = step(data, cam, target, seed)
        torch.cuda.synchronize()
        runs.append((res, {k: ch.launch_count[k] - n
                           for k, n in launches.items()},
                     {k: sharding.step_graph_count[k] - n
                      for k, n in counts.items()}))
    return runs


def _same_bits(a, b):
    (a_loss, a_grads), (b_loss, b_grads) = a, b
    return torch.equal(a_loss.view(torch.int32),
                       b_loss.view(torch.int32)) and all(
        torch.equal(g.view(torch.int32), b_grads[k].view(torch.int32))
        for k, g in a_grads.items())


def _assert_step_routes(meta, data, cam, target, mode, per_step,
                        seeds=(7, 8, 9), **kw):
    """The graph route's steps against the eager route's at the same seeds:
    the first graph call captures, every later one replays with no
    recapture; the launches of every call equal (``per_step`` a step in
    the forward ``mode`` and in the backward); loss and grads bit-equal
    where two eager steps at one seed are bit-equal to each other, else
    within phase 17's tolerance (loss rtol 1e-4, grads rtol 1e-3).  Returns which held:
    "bit-equal" or "within tolerance"."""
    graph = _steps(meta, data, cam, target, False, seeds, **kw)
    eager = _steps(meta, data, cam, target, True, seeds + seeds[-1:], **kw)
    deterministic = _same_bits(eager[-1][0], eager[-2][0])
    for k, ((g, g_l, g_c), (e, e_l, e_c)) in enumerate(zip(graph, eager)):
        assert g_l == e_l and g_l[mode] == g_l["bwd"] == per_step, (g_l,
                                                                    e_l)
        assert e_c["captures"] == e_c["replays"] == 0
        assert g_c["recaptures"] == 0
        assert (g_c["captures"], g_c["replays"]) == ((1, 0) if k == 0
                                                     else (0, 1)), g_c
        (g_loss, g_grads), (e_loss, e_grads) = g, e
        assert bool(torch.isfinite(g_loss))
        if deterministic:
            assert _same_bits(g, e), f"seed {seeds[k]}"
            continue
        torch.testing.assert_close(g_loss, e_loss, rtol=1e-4, atol=0.0)
        scale = max(float(x.abs().max()) for x in e_grads.values())
        for name, x in g_grads.items():
            torch.testing.assert_close(x, e_grads[name], rtol=1e-3,
                                       atol=1e-5 * scale,
                                       msg=lambda m, n=name: f"{n}: {m}")
    held = "bit-equal" if deterministic else "within tolerance"
    print(f"step graph vs eager, {mode}: {held}")
    return held


@pytest.mark.parametrize("accel", ["none", "cull", "bvh"])
def test_step_graph_equals_eager_scene1(dev, accel):
    """Scene 1 at 64x36, 4 spp, depth 8 through each closest-hit mode:
    the captured step against the eager step (``_assert_step_routes``)."""
    world, cam = sc.random_spheres()
    data, meta = world.compile()
    cam = cam.replace(image_width=64, image_height=36, sqrt_spp=2,
                      bounce_limit=8)
    target = np.zeros((36, 64, 3), np.float32)
    _assert_step_routes(meta, data, cam, target, accel, 4 * 8, accel=accel)


def test_step_graph_equals_eager_cornell(dev):
    """The Cornell box at 16x16, 4 spp, depth 6 (quads: the axis-aligned
    path and the boxes of "none"): the captured step against the eager
    step; then a quad moved off its axes captures once more."""
    from mort_tpu_torch import make_train_step, render
    from mort_tpu_torch.parallel import sharding

    world, cam = sc.cornell_box()
    data, meta = world.compile()
    cam = cam.replace(image_width=16, image_height=16, sqrt_spp=2,
                      bounce_limit=6)
    target = render(data, meta, cam, seed=3).cpu().numpy() * 0.9
    _assert_step_routes(meta, data, cam, target, "none", 4 * 6)
    step = make_train_step(meta)
    step(data, cam, target, 7)
    groups = ch.aaq_groups_of(meta)
    cls = sorted(groups)[0]
    u = data.quad_u.clone()
    u[groups[cls][0], 3 - cls // 3 - cls % 3] += 1e-3
    before = dict(sharding.step_graph_count)
    loss, grads = step(data.replace(quad_u=u), cam, target, 7)
    moved = {k: sharding.step_graph_count[k] - n for k, n in before.items()}
    assert moved["captures"] == moved["recaptures"] == 1, moved
    assert bool(torch.isfinite(loss))
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())


def test_step_graph_results_are_fresh(dev):
    """A replayed step's results are new tensors: the last step's loss and
    gradients stay as they were after the next step."""
    from mort_tpu_torch import make_train_step

    world, cam = sc.random_spheres()
    data, meta = world.compile()
    cam = cam.replace(image_width=32, image_height=18, sqrt_spp=2,
                      bounce_limit=4)
    target = np.zeros((18, 32, 3), np.float32)
    step = make_train_step(meta)
    step(data, cam, target, 1)
    first = step(data, cam, target, 2)
    kept = (first[0].clone(), {k: g.clone() for k, g in first[1].items()})
    second = step(data, cam, target, 3)
    assert _same_bits(first, kept)
    assert not _same_bits(first, second)


def _lockstep_routes(fn):
    """``fn(eager)`` on the lockstep graph route, then the eager one: for
    each its result, the closest-hit launches and the lockstep graph
    counts it added; the two results bit-equal, with the same launches,
    bounces and host reads, and no capture or replay on the eager
    route."""
    from mort_tpu_torch.render.integrator import lockstep_graph_count

    runs = []
    for eager in (False, True):
        torch.cuda.synchronize()
        launches, counts = dict(ch.launch_count), dict(lockstep_graph_count)
        res = fn(eager)
        torch.cuda.synchronize()
        runs.append((torch.as_tensor(res), {
            k: ch.launch_count[k] - n for k, n in launches.items()}, {
            k: lockstep_graph_count[k] - n for k, n in counts.items()}))
    (g, g_l, g_c), (e, e_l, e_c) = runs
    assert g.shape == e.shape and torch.equal(
        g.view(torch.int32), e.view(torch.int32))
    assert g_l == e_l, (g_l, e_l)
    assert (g_c["bounces"], g_c["syncs"]) == (e_c["bounces"], e_c["syncs"])
    assert e_c["captures"] == e_c["replays"] == 0
    assert g_c["replays"] > 0
    return g, g_l, g_c


@pytest.mark.parametrize("accel", ["none", "cull", "bvh"])
def test_lockstep_graph_equals_eager_scene9(dev, accel):
    """The lockstep forward of ``render`` (``radiance_batches``) on scene 9
    at 48x48, 4 spp, depth 4 in batches of 1000 pixels (a short tail)
    through each closest-hit mode: the captured units against the eager
    route, bit for bit with the same launches (one a bounce step); a
    second call at another seed replays with no capture."""
    from mort_tpu_torch.render.renderer import radiance_batches

    world, cam = sc.final_scene(400, 250, 4)
    data, meta = world.compile()
    data = data.to(dev)
    cam = cam.replace(image_width=48, image_height=48, sqrt_spp=2).to(dev)
    pix = torch.arange(48 * 48, device=dev)

    def fn(seed):
        return lambda eager: radiance_batches(data, meta, cam, seed, pix,
                                              1000, accel=accel, eager=eager)

    for seed in (9, 10):
        _, launches, counts = _lockstep_routes(fn(seed))
        assert launches[accel] == counts["bounces"] > 0, (launches, counts)
        assert counts["captures"] == (2 if seed == 9 else 0), counts


def test_lockstep_graph_equals_eager_intersect_best(dev):
    """``render(use_kernel=False)`` on the Cornell box at 32x32, 4 spp,
    depth 8: the graph route against the eager route, no kernel launch."""
    from mort_tpu_torch import render

    world, cam = sc.cornell_box()
    data, meta = world.compile()
    cam = cam.replace(image_width=32, image_height=32, sqrt_spp=2,
                      bounce_limit=8)
    _, launches, counts = _lockstep_routes(lambda eager: render(
        data, meta, cam, seed=5, use_kernel=False, _eager=eager))
    assert sum(launches.values()) == 0 and counts["bounces"] > 0


def test_lockstep_graph_progressive_resume(dev, tmp_path):
    """``render_progressive`` on the Cornell box at its own 600x600 (three
    batches of 2^17 pixels, the last short), 4 spp, depth 8, in steps of 3
    and 1 samples: the graph route against the eager route; then
    interrupted after its first step and resumed from the checkpoint, bit
    for bit the uninterrupted render."""
    from mort_tpu_torch.render.progressive import (
        load_state, render_progressive,
    )

    world, cam = sc.cornell_box()
    data, meta = world.compile()
    cam = cam.replace(sqrt_spp=2, bounce_limit=8)
    full, launches, _ = _lockstep_routes(lambda eager: render_progressive(
        data, meta, cam, samples_per_step=3, _eager=eager).fb)
    assert launches["none"] > 0
    ckpt = str(tmp_path / "lock.npz")

    class Stop(BaseException):
        pass

    def stop(state):
        raise Stop

    with pytest.raises(Stop):
        render_progressive(data, meta, cam, samples_per_step=3,
                           checkpoint_path=ckpt, on_step=stop)
    state = load_state(ckpt)
    assert state.samples_done == 3
    resumed = render_progressive(data, meta, cam, samples_per_step=3,
                                 state=state)
    assert np.array_equal(resumed.fb, full.numpy())


@pytest.mark.parametrize("differentiable", [False, True])
def test_lockstep_graph_render_sharded(dev, differentiable):
    """``render_sharded`` over ``make_mesh(1)`` (no process group) on scene
    1 at 64x36, 4 spp, depth 8: the graph route against the eager route;
    with ``differentiable`` every bounce runs, with no host read."""
    from mort_tpu_torch import make_mesh, render_sharded

    world, cam = sc.random_spheres()
    data, meta = world.compile()
    cam = cam.replace(image_width=64, image_height=36, sqrt_spp=2,
                      bounce_limit=8)
    mesh = make_mesh(1)
    _, launches, counts = _lockstep_routes(lambda eager: render_sharded(
        data, meta, cam, mesh, seed=5, differentiable=differentiable,
        _eager=eager))
    if differentiable:
        assert launches["none"] == 4 * 8 and counts["syncs"] == 0
    else:
        assert launches["none"] == counts["bounces"] > 0


def test_train_step_beside_lockstep_graphs(dev):
    """A train step replayed after a lockstep render and before another:
    the step replays with no recapture and stays equal to the eager step,
    and the render replays with no recapture and stays equal to its eager
    route."""
    from mort_tpu_torch import make_train_step, render
    from mort_tpu_torch.parallel import sharding
    from mort_tpu_torch.render.integrator import lockstep_graph_count

    world, cam = sc.cornell_box()
    data, meta = world.compile()
    cam = cam.replace(image_width=16, image_height=16, sqrt_spp=2,
                      bounce_limit=6)
    target = render(data, meta, cam, seed=3).cpu().numpy() * 0.9
    step = make_train_step(meta)
    eager_step = make_train_step(meta, _eager=True)
    step(data, cam, target, 7)
    for seed in (8, 9):
        lock = dict(lockstep_graph_count)
        img = render(data, meta, cam, seed=seed)
        assert lockstep_graph_count["captures"] == lock["captures"]
        assert lockstep_graph_count["replays"] > lock["replays"]
        assert torch.equal(img, render(data, meta, cam, seed=seed,
                                       _eager=True))
        before = dict(sharding.step_graph_count)
        got = step(data, cam, target, seed)
        moved = {k: sharding.step_graph_count[k] - n
                 for k, n in before.items()}
        assert moved["captures"] == 0 and moved["replays"] == 1, moved
        want = eager_step(data, cam, target, seed)
        torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=0.0)
        scale = max(float(g.abs().max()) for g in want[1].values())
        for k, g in got[1].items():
            torch.testing.assert_close(g, want[1][k], rtol=1e-3,
                                       atol=1e-5 * scale)


def _cpu(x):
    return x.cpu() if isinstance(x, torch.Tensor) else x


def _same_draws(got, want):
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert torch.equal(g.cpu().view(torch.int32),
                           w.cpu().view(torch.int32))


@pytest.mark.parametrize("bounce", ["int", "0-dim", "lanes"])
@pytest.mark.parametrize("seed", ["int", "tensor"])
def test_philox_kernel_equals_plain(dev, seed, bounce):
    """The kernel's four floats equal the plain version's on CPU copies of
    the same operands bit for bit, for slots 0-8, with one launch a draw
    and no plain call."""
    pix, smp, bnc = philox_lanes(4099, dev)
    seed = {"int": 2 ** 32 + 69420, "tensor": torch.tensor([-12345],
                                                            device=dev)}[seed]
    bounce = {"int": 7, "0-dim": torch.tensor(2 ** 32 + 3, device=dev),
              "lanes": bnc}[bounce]
    before = dict(rng.launch_count)
    for slot in range(9):
        got = rng.uniform4(seed, pix, smp, bounce, slot)
        torch.cuda.synchronize()
        _same_draws(got, rng.uniform4_plain(
            *(_cpu(x) for x in (seed, pix, smp, bounce)), slot))
    moved = {k: rng.launch_count[k] - n for k, n in before.items()}
    assert moved == {"kernel": 9, "plain": 0}, moved


def test_philox_kernel_broadcast_operands(dev):
    """An expanded sample, an int32 pixel, a [1] bounce, a [3, 1] by
    [1, n] broadcast and counters that are all ints (the shape is then the
    seed tensor's scalar) equal the plain version's draws."""
    pix, smp, _ = philox_lanes(1000, dev, seed=1)
    seed = torch.tensor([5], device=dev)
    for args in ((pix, smp[:1].expand_as(pix), torch.tensor([4], device=dev)),
                 (pix.to(torch.int32), 9, 2),
                 (pix[None, :], torch.arange(3, device=dev)[:, None], 3),
                 (123, 4, 2)):
        got = rng.uniform4(seed, *args, rng.SLOT_MIX)
        _same_draws(got, rng.uniform4_plain(
            *(_cpu(x) for x in (seed, *args)), rng.SLOT_MIX))


def test_philox_kernel_refuses_float_operands(dev):
    """A float word and a seed of two elements are refused before a
    launch, which the count then does not take."""
    before = dict(rng.launch_count)
    with pytest.raises(TypeError):
        rng.uniform4(1, torch.ones(8, device=dev), 0, 1, 0)
    with pytest.raises(ValueError):
        rng.uniform4(torch.tensor([1, 2], device=dev),
                     torch.arange(8, device=dev), 0, 1, 0)
    assert rng.launch_count == before


def test_philox_graph_reads_seed_and_bounce(dev):
    """A captured draw replayed after ``seed.fill_`` and ``bounce.fill_``
    gives the eager draws of the new values: the kernel reads both through
    their pointers at each replay."""
    pix, smp, _ = philox_lanes(5000, dev, seed=2)
    seed = torch.tensor([11], device=dev)
    bounce = torch.zeros((), dtype=torch.int64, device=dev)
    sample = smp[:1].expand_as(pix)

    def draw():
        return rng.uniform4(seed, pix, sample, 1 + bounce, rng.SLOT_FUZZ)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        draw()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = dict(rng.launch_count)
    with torch.cuda.graph(graph):
        out = draw()
    assert rng.launch_count["kernel"] == before["kernel"] + 1
    for s, b in ((2 ** 31 + 5, 4), (-3, 19), (0, 0)):
        seed.fill_(s)
        bounce.fill_(b)
        graph.replay()
        torch.cuda.synchronize()
        _same_draws(out, rng.uniform4(s, pix, sample, 1 + b,
                                      rng.SLOT_FUZZ))
        _same_draws(out, rng.uniform4_plain(s, pix.cpu(), sample.cpu(),
                                            1 + b, rng.SLOT_FUZZ))
    assert rng.launch_count["plain"] == before["plain"]


def _plain_on_cpu(dev, pixel, sample, bounce_plus1, slot, seed):
    """``rng._launch``'s stand-in: the plain version on CPU copies."""
    cpu = [_cpu(x) for x in (seed, pixel, sample, bounce_plus1, slot)]
    return tuple(u.to(dev) for u in rng.uniform4_plain(*cpu))


def test_philox_kernel_in_differentiable_trace(dev, monkeypatch):
    """The eager train step (``trace(differentiable=True)``, whose
    checkpoint recomputes each bounce's draws in the backward) through the
    kernel against the same step with the draws of the plain version on
    CPU copies: loss and gradients bit-equal where two kernel steps are,
    else within ``_assert_step_routes``' tolerance."""
    from mort_tpu_torch import make_train_step

    world, cam = sc.random_spheres()
    data, meta = world.compile()
    cam = cam.replace(image_width=64, image_height=36, sqrt_spp=2,
                      bounce_limit=8)
    target = np.zeros((36, 64, 3), np.float32)
    step = make_train_step(meta, _eager=True)
    before = dict(rng.launch_count)
    kern = [step(data, cam, target, 7) for _ in range(2)]
    torch.cuda.synchronize()
    moved = {k: rng.launch_count[k] - n for k, n in before.items()}
    assert moved["kernel"] > 0 and moved["plain"] == 0, moved
    monkeypatch.setattr(rng, "_launch", _plain_on_cpu)
    plain = step(data, cam, target, 7)
    assert rng.launch_count["plain"] == before["plain"]
    if _same_bits(kern[0], kern[1]):
        assert _same_bits(kern[0], plain)
        return
    (k_loss, k_grads), (p_loss, p_grads) = kern[0], plain
    torch.testing.assert_close(k_loss, p_loss, rtol=1e-4, atol=0.0)
    scale = max(float(x.abs().max()) for x in p_grads.values())
    for name, x in k_grads.items():
        torch.testing.assert_close(x, p_grads[name], rtol=1e-3,
                                   atol=1e-5 * scale)


def test_gloo_mesh_on_one_card_times_its_all_reduce(dev, tmp_path):
    """Two gloo ranks sharing the card run five steps of the mesh fit
    (``tests/test_torch_mesh_fit.py``'s worker, scene 1 at 64x36): the
    replayed steps' all-reduces are timed by their events and read at the
    next call without a host wait (the worker refuses every wait from its
    second step on), their reads paired with the replays'; both ranks hold
    the same scene."""
    import test_torch_mesh_fit as mf

    seeds = [11, 12, 13, 14, 15]
    ranks = mf._run_world(2, tmp_path, seeds, device=f"cuda:{dev.index}",
                          steps=5)
    for res in ranks:
        c = res["counters"]
        assert res["per_step"] == [1] * 5
        assert c["train.all_reduce_bytes"] == 5 * mf._bucket_bytes()
        # replays of steps 2-4 read at the entries of steps 3-5
        assert c["train.all_reduce_device_count"] == 3
        assert c["train.all_reduce_device_ns"] > 0
        assert c["train.step_device_ns"] > 0
        assert "train.all_reduce_device_unread" not in c
        assert "train.step_device_unread" not in c
        assert res["losses"] == ranks[0]["losses"]
        for th, th0 in zip(res["theta"], ranks[0]["theta"]):
            for k in th:
                np.testing.assert_array_equal(th[k], th0[k], err_msg=k)


def test_train_step_on_a_second_card_equals_the_first(dev):
    """The train step on cuda:1 (its own graph capture, the kernels
    launched under that card) gives cuda:0's losses and gradients, eager
    first step and replays alike: bit for bit where two runs on cuda:0 are
    bit-equal to each other, else within ``_assert_step_routes``'
    tolerance."""
    from mort_tpu_torch import make_train_step

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    world, cam = sc.random_spheres()
    data, meta = world.compile()
    cam = cam.replace(image_width=64, image_height=36, sqrt_spp=2,
                      bounce_limit=8)
    target = np.full((36, 64, 3), 0.4, np.float32)
    runs = []
    for card in ("cuda:0", "cuda:0", "cuda:1"):
        step = make_train_step(meta, device=card)
        got = []
        for k in range(3):
            loss, grads = step(data, cam, target, 7 + k)
            assert loss.device == torch.device(card)
            got.append((loss.cpu(), {f: g.cpu() for f, g in grads.items()}))
        runs.append(got)
    stable = all(_same_bits(a, b) for a, b in zip(runs[0], runs[1]))
    print(f"cuda:0 twice bit-equal: {stable}")
    for (l0, g0), (l1, g1) in zip(runs[0], runs[2]):
        if stable:
            assert _same_bits((l0, g0), (l1, g1))
            continue
        torch.testing.assert_close(l1, l0, rtol=1e-4, atol=0.0)
        scale = max(float(x.abs().max()) for x in g0.values())
        for f, x in g1.items():
            torch.testing.assert_close(x, g0[f], rtol=1e-3,
                                       atol=1e-5 * scale)
