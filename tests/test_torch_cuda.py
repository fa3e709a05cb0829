"""The CUDA closest-hit kernel against its plain version, on the card.

Marked ``cuda``: without a card every test skips.  Imports no jax, so on a
machine without jax it runs without the repository's conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from mort_tpu_torch import require_cuda
from mort_tpu_torch.camera import derive_basis, get_rays_soa
from mort_tpu_torch.render import closest_hit as ch
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
    """d_rays bit-equal (every lane's value is the plain version's rounded
    ops in its order); the table gradients are sums in atomic order, which
    changes from run to run: within 1e-4 of each entry's sum of |terms|."""
    args = _bwd_args(_packed(_mixed_world(), dev), 4096, dev)
    before = ch.launch_count["bwd"]
    got = ch._launch_bwd(*args)
    torch.cuda.synchronize()
    assert ch.launch_count["bwd"] == before + 1
    want = ch.closest_hit_bwd_reference(*args)
    scale = ch.closest_hit_bwd_reference(*args, absolute=True)
    assert torch.equal(got[0], want[0])
    assert bool((got[1] != 0).any()) and bool((got[3] != 0).any())
    for g, w, s in zip(got[1:], want[1:], scale[1:]):
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
