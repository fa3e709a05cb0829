#!/usr/bin/env python3
"""Build and run the port on one NVIDIA card, as a user would.

    python3 chip_smoke.py

Phases, one line each or more (any failure raises and exits non-zero):

1. card: the device, its name and power limit (nvidia-smi), versions;
2. build: nvcc-compiles csrc/closest_hit.cu (or loads it from the build
   cache) and reports the seconds;
3. philox: the pinned Philox vector of tests/test_rng.py, on the card;
4. parity: the CUDA closest-hit kernel in each accel mode ("none", "bvh",
   "cull") against its plain PyTorch version on the same card tensors, on
   four ray sets — scene 1 (2^18 camera rays and their bounces), scene 9
   (2^16, its default pool), a moving sphere/quad scene (2^18) and a
   16,384-sphere spread scene (2^18) — t, kind, idx and rows bit-equal,
   also from a launch that counts its sphere and quad tests (the
   operation bound of each mode); then every mode and the plain version
   timed with CUDA events on each set;
5. main path, scene 1: ``render_wavefront`` at its bench config (1200x675,
   100 spp, depth 20, default pool/window/spt), launch counts reset just
   before and read just after; then, at a reduced config, the same render
   through the kernel and through the plain closest hit must agree by the
   image rule of tests/conftest.py;
6. main path, scene 9 (final_scene: quads, a light, media, image and noise
   textures) at its code-true config (400x400, 250 spp — 225 as the camera
   floors it to 15^2 — depth 4, auto accel);
7. scene 9 at 100x100, 16 spp, depth 4 through the "none", "bvh" and
   "cull" kernels and the plain closest hit: the four images agree by the
   image rule;
8. scenes 2-8 and 10 at the golden config (48 px, 4 spp, depth 8), kernel
   against plain by the image rule, each with kernel launches; the
   16,384-sphere scene at a small config, where the auto policy runs "bvh";
9. backward parity: the CUDA backward kernel (the gradient of the closest
   hit) against its plain version on phase 4's four ray sets with random
   cotangents — d_rays bit-equal, the atomically summed table gradients
   within BWD_SUM_RTOL of the sum of |terms| per entry — and timed on
   scene 1's rays at the train step's config (R = 202,800);
10. main path, the train step: ``make_train_step`` on scene 1 at
   ``bench.py --grad``'s config (600x338, 4 spp, depth 8), one warm-up step
   and three timed ones, launch counts reset just before and read just
   after (32 forward and 32 backward launches a step);
11. the lockstep ``render`` of scene 1 (200x112, 16 spp, depth 20) through
   the kernel, through the plain closest hit and against
   ``render_wavefront``, by the image rule;
12. the Cornell box train step (12x12, 4 spp, depth 6) on the card against
   the same step on the CPU (the Function's plain versions), and the card's
   ``intersect_best`` route.

The line before the last is the nvidia-smi name/power line, the one before
it a JSON record of the kernels (launches on the paths above, the largest
error against the plain version, kernel, plain and bound ms); the last
line is a JSON object with ``ok`` and the device.  Imports neither jax nor
the JAX package.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from mort_tpu_torch import (  # noqa: E402
    make_train_step, render, render_wavefront, require_cuda,
)
from mort_tpu_torch import _build, rng  # noqa: E402
from mort_tpu_torch.device import card_line  # noqa: E402
from mort_tpu_torch.camera import derive_basis, get_rays_soa  # noqa: E402
from mort_tpu_torch.render import closest_hit as ch  # noqa: E402
from mort_tpu_torch.render.hitshade import finalize_and_shade  # noqa: E402
from mort_tpu_torch.render.intersect import (  # noqa: E402
    K_QUAD, K_SPHERE, T_MIN, media_pass, quad_frames,
)
from mort_tpu_torch.render.primtable import build_prim_table  # noqa: E402
from mort_tpu_torch.render.vec import V3  # noqa: E402
from mort_tpu_torch.scene import scenes as sc  # noqa: E402
from mort_tpu_torch.scene.build import World  # noqa: E402

R_PARITY = 1 << 18          # the default pool of scene 1: the kernel's R
R_SCENE9 = 1 << 16          # the default pool of scene 9 (> 1024 prims)
SEED = 69420
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 peak memory rate
FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
# float32 operations every (ray, surface primitive) pair costs in the
# kernel whatever the data: a sphere up to its discriminant (two 3-term dots
# and two subtractions for half_b, two dots and seven more ops for c_term,
# three for the discriminant), a quad up to its t test (two dots, a
# subtraction, a division)
SPHERE_OPS, QUAD_OPS = 34, 12
# float32 operations of the backward kernel per hit lane: a sphere lane
# recomputes the ray terms (23) and half_b, c_term, the discriminant and the
# root choice (38), forms the partials of t (20), the nine record terms (16)
# and d_rays (33); a quad lane its t (13), the four record terms (10) and
# d_rays (9)
BWD_SPHERE_OPS, BWD_QUAD_OPS = 130, 32
# The backward kernel's table gradients are float32 sums taken in atomic
# order, which changes from run to run, against the plain version's
# index_add_: they are held within BWD_SUM_RTOL of the sum of |terms| of
# each entry (float32 summation of n terms in two orders differs by about
# sqrt(n) * 6e-8 of that sum for random rounding; 2^17 terms on one
# entry give ~2e-5).
BWD_SUM_RTOL = 1e-4
GRAD_W, GRAD_H = 600, 338   # bench.py --grad's train step config
GRAD_SEEDS = (69420, 69421, 69422, 69423)   # warm-up, then three timed


def log(msg):
    print(msg, flush=True)


def assert_images_close(got, want, frac_ok=0.98, atol=2e-2, mean_tol=4e-3):
    """tests/conftest.py's rule (restated: that file imports jax): at least
    98% of pixels within 2e-2 on every channel, mean abs diff <= 4e-3."""
    diff = np.abs(np.asarray(got) - np.asarray(want))
    frac = float(np.mean(np.all(diff <= atol, axis=-1)))
    mean = float(diff.mean())
    assert frac >= frac_ok and mean <= mean_tol, (
        f"images differ: frac_within={frac:.4f} (need {frac_ok}), "
        f"mean_abs={mean:.6f} (need {mean_tol}); max={diff.max():.4f}")
    return frac, mean


def reset_counts():
    torch.cuda.synchronize()
    for mode in ch.launch_count:
        ch.launch_count[mode] = 0


def read_counts():
    torch.cuda.synchronize()
    return dict(ch.launch_count)


class Scene:
    """A compiled scene on the card and its packed tables, per mode."""

    def __init__(self, world, dev):
        data, meta = world.compile()
        self.data, self.meta = data.to(dev), meta
        self.qf = quad_frames(self.data)
        self.table, self.mat_cols = build_prim_table(self.data, meta,
                                                     self.qf)
        self.packed = {mode: ch.pack_scene(self.data, meta, self.qf,
                                           self.table, mode)
                       for mode in ch.ACCELS}


def camera_bounce_rays(scene, cam, n, dev):
    """n camera rays of ``cam`` (random pixels and samples) and the n
    bounces they take (shading as the wavefront does), 2n rays."""
    g = torch.Generator().manual_seed(1)
    pix = torch.randint(0, cam.image_width * cam.image_height, (n,),
                        generator=g).to(dev)
    smp = torch.randint(0, cam.sqrt_spp ** 2, (n,), generator=g).to(dev)
    cam = cam.to(dev)
    ro, rd, tme = get_rays_soa(cam, derive_basis(cam), SEED, pix, smp,
                               no_defocus=True)
    bt, bk, bi, row = ch.closest_hit(scene.packed["none"], ro, rd, tme)
    bt, bk, bi = media_pass(scene.data, scene.meta, scene.qf, ro, rd, SEED,
                            pix, smp, 0, T_MIN, bt, bk, bi)
    out = finalize_and_shade(scene.data, scene.meta, scene.qf, scene.table,
                             scene.mat_cols, ro, rd, tme, bt, bk, bi, SEED,
                             pix, smp, 0, row_t=row)
    cat = lambda a, b: torch.cat([a, b])  # noqa: E731
    return (V3(*(cat(a, b) for a, b in zip(ro, out.p))),
            V3(*(cat(a, b) for a, b in zip(rd, out.new_dir))),
            cat(tme, tme))


def moving_mixed_world():
    """A moving sphere/quad scene (test_pallas_kernel.py's _mixed_world
    shape, larger)."""
    rs = np.random.RandomState(1)
    w = World()
    m = w.lambertian(w.solid_color([0.5, 0.5, 0.5]))
    for i in range(300):
        c = rs.randn(3) * 3
        if i % 2 == 0:
            w.sphere(c, 0.1 + 0.3 * rs.rand(), m,
                     center2=c + rs.randn(3) * 0.5)
        else:
            w.sphere(c, 0.1 + 0.3 * rs.rand(), m)
    for _ in range(200):
        w.quad(rs.randn(3) * 3, rs.randn(3), rs.randn(3), m)
    return w


def random_rays(n, dev):
    g = np.random.RandomState(3)
    ro = torch.from_numpy((g.randn(n, 3) * 6).astype(np.float32))
    rd = torch.from_numpy(g.randn(n, 3).astype(np.float32))
    tme = torch.from_numpy(g.rand(n).astype(np.float32))
    return V3.from_rows(ro.to(dev)), V3.from_rows(rd.to(dev)), tme.to(dev)


def compare(name, packed, rays, want):
    """Kernel vs plain version on the same card tensors: the whole [32, R]
    output bit-equal (t, kind, idx and the joined rows).  Returns the
    largest |dt| over hit lanes (0 when bit-equal)."""
    got = ch._launch(packed, rays, T_MIN)
    torch.cuda.synchronize()
    hit = want[ch.ROW_KIND] > 0
    t, wt = got[ch.ROW_T][hit], want[ch.ROW_T][hit]
    err = float((t - wt).abs().max()) if hit.any() else 0.0
    assert torch.equal(got[ch.ROW_KIND], want[ch.ROW_KIND]), \
        f"{name}: kind differs"
    assert torch.equal(got[ch.ROW_IDX], want[ch.ROW_IDX]), \
        f"{name}: idx differs"
    assert torch.equal(got[ch.ROW_T], want[ch.ROW_T]), \
        f"{name}: t differs (max |dt| {err:.3e})"
    assert torch.equal(got, want), f"{name}: joined rows differ"
    log(f"parity {name}: R={rays.shape[1]} hits={int(hit.sum())} t, kind, "
        f"idx and rows bit-equal to the plain version")
    return err


def time_ms(fn, reps=20, warmup=3):
    """Median ms per call, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def count_tests(name, packed, rays, want):
    """The (sphere, quad) tests one launch of ``packed.accel`` performs, from
    the kernel's optional counter; the counted launch must still equal the
    plain version bit for bit.  In "none" every ray tests every surface
    primitive."""
    n = torch.zeros(2, dtype=torch.int64, device=rays.device)
    got = ch._launch(packed, rays, T_MIN, n)
    torch.cuda.synchronize()
    assert torch.equal(got, want), f"{name}: the counted launch differs"
    n_s, n_q = int(n[0]), int(n[1])
    if packed.accel == "none":
        R = rays.shape[1]
        surf_s = int((packed.sph[:packed.n_sph, 9] != 0).sum())
        surf_q = int((packed.quad[:packed.n_quad, 12] != 0).sum())
        assert (n_s, n_q) == (R * surf_s, R * surf_q), \
            f"{name}: counted {(n_s, n_q)} tests"
    return n_s, n_q


def bound_parts(packed, R, n_tests):
    """(bytes bound, operations bound) of one call in ms: the bytes the
    call must move (the [8, R] rays in, the [32, R] rows out, every table
    once) over HBM bandwidth, and the operations of the (sphere, quad)
    tests ``n_tests`` that the call performed (counted by the kernel) over
    the float32 peak."""
    tabs = [packed.sph, packed.quad, packed.joined]
    if packed.accel_tab is not None:
        tabs.append(packed.accel_tab)
    n_bytes = R * (8 + ch.ROW_K) * 4 + sum(t.numel() * 4 for t in tabs)
    n_s, n_q = n_tests
    return (n_bytes / HBM_BYTES_PER_S * 1e3,
            (n_s * SPHERE_OPS + n_q * QUAD_OPS) / FP32_OPS_PER_S * 1e3)


def bound_ms(packed, R, n_tests):
    """The least time the card could take for one call: the larger of the
    two ``bound_parts``, and which it is."""
    t_bytes, t_ops = bound_parts(packed, R, n_tests)
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def parity_and_timing(dev, card):
    """Phase 4.  Returns {mode: {"err", "ms", "plain_ms", "bound_ms",
    "bound_by"}} at scene 9's shapes, and the four ray sets
    {name: (scene, rays, plain output)}."""
    world1, cam1 = sc.random_spheres()
    world9, cam9 = sc.final_scene(400, 250, 4)
    world16, cam16 = sc.spread_spheres()
    s1, s9, s16 = Scene(world1, dev), Scene(world9, dev), Scene(world16, dev)
    assert ch.auto_accel(s16.meta.n_spheres) == "bvh"
    sets = {
        "scene1": (s1, camera_bounce_rays(s1, cam1, R_PARITY // 2, dev)),
        "scene9": (s9, camera_bounce_rays(s9, cam9, R_SCENE9 // 2, dev)),
        "moving_mixed": (Scene(moving_mixed_world(), dev),
                         random_rays(R_PARITY, dev)),
        "spread16k": (s16, camera_bounce_rays(s16, cam16, R_PARITY // 2,
                                              dev)),
    }
    err = dict.fromkeys(ch.ACCELS, 0.0)
    times, tests, out_sets = {}, {}, {}
    for name, (scene, (ro, rd, tme)) in sets.items():
        rays = ch.stack_rays(ro, rd, tme)
        want = ch.closest_hit_reference(scene.packed["none"], rays)
        out_sets[name] = (scene, rays, want)
        tests[name] = {}
        for mode in ch.ACCELS:
            err[mode] = max(err[mode], compare(
                f"{name}/{mode}", scene.packed[mode], rays, want))
            tests[name][mode] = count_tests(f"{name}/{mode}",
                                            scene.packed[mode], rays, want)
        plain = time_ms(lambda: ch.closest_hit_reference(
            scene.packed["none"], rays), reps=3, warmup=1)
        row = {"plain": plain}
        for mode in ch.ACCELS:
            row[mode] = time_ms(lambda: ch._launch(scene.packed[mode], rays,
                                                   T_MIN))
        times[name] = row
        R = rays.shape[1]
        parts = []
        for m in ch.ACCELS:
            t_bytes, t_ops = bound_parts(scene.packed[m], R, tests[name][m])
            n_s, n_q = tests[name][m]
            parts.append(f"{m} {row[m]:.4f} ms (operations bound "
                         f"{t_ops:.4f} ms for {n_s / R:.1f} sphere + "
                         f"{n_q / R:.1f} quad tests a ray, bytes bound "
                         f"{t_bytes:.4f} ms)")
        log(f"timing {name} R={R}: " + ", ".join(parts)
            + f", plain {plain:.4f} ms | {card}")
    R = R_SCENE9
    out = {}
    for mode in ch.ACCELS:
        b, by = bound_ms(s9.packed[mode], R, tests["scene9"][mode])
        out[mode] = {"err": err[mode], "ms": times["scene9"][mode],
                     "plain_ms": times["scene9"]["plain"], "bound_ms": b,
                     "bound_by": by}
    return out, out_sets


def random_cotangents(R, dev, seed):
    """dt [R] and drow [32, R] from numpy."""
    g = np.random.RandomState(seed)
    dt = torch.from_numpy(g.randn(R).astype(np.float32)).to(dev)
    drow = torch.from_numpy(g.randn(ch.ROW_K, R).astype(np.float32)).to(dev)
    return dt, drow


def bwd_args(scene, rays, fwd, dt, drow):
    p = scene.packed["none"]
    return (rays, fwd[ch.ROW_KIND].to(torch.int32),
            fwd[ch.ROW_IDX].to(torch.int32), dt, drow, p.sph, p.quad,
            tuple(p.joined.shape), p.quad_base, T_MIN)


def compare_bwd(name, args):
    """The backward kernel against its plain version on the same card
    tensors: d_rays bit-equal (each lane's value is the same rounded ops),
    d_sph, d_quad and d_joined within BWD_SUM_RTOL of each entry's sum of
    |terms|.  Returns (largest |difference|, largest |difference| / sum of
    |terms|)."""
    got = ch._launch_bwd(*args)
    want = ch.closest_hit_bwd_reference(*args)
    scale = ch.closest_hit_bwd_reference(*args, absolute=True)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]), f"{name}: d_rays differ"
    err, rel = 0.0, 0.0
    for what, g, w, s in zip(("d_sph", "d_quad", "d_joined"), got[1:],
                             want[1:], scale[1:]):
        diff = (g - w).abs()
        if diff.numel():
            err = max(err, float(diff.max()))
            rel = max(rel, float((diff / s.clamp_min(1e-30)).max()))
        bad = int((diff > BWD_SUM_RTOL * s).sum())
        assert bad == 0, (f"{name}: {what} differs beyond {BWD_SUM_RTOL} of "
                          f"the sum of |terms| at {bad} entries (largest "
                          f"ratio {rel:.3e})")
    return err, rel


def bwd_bound_ms(args):
    """The least time of one backward call: the larger of the bytes it must
    move over HBM bandwidth, and its float32 operations per hit lane over
    the float32 peak.  Every lane reads kind and writes its 8 rows of
    d_rays; only a hit lane reads its 7 ray rows, idx, dt and the 28 rows
    of drow it uses (a miss drops its cotangents).  The record tables are
    read once and the three gradient tables written once."""
    rays, kind, _idx, _dt, _drow, sph, quad, joined_shape = args[:8]
    R = rays.shape[1]
    n_join, k_join = joined_shape
    n_sph_hits = int((kind == K_SPHERE).sum())
    n_quad_hits = int((kind == K_QUAD).sum())
    n_bytes = (4 * R * (1 + 8)
               + 4 * (n_sph_hits + n_quad_hits) * (7 + 1 + 1 + (k_join + 1))
               + 4 * 2 * (sph.numel() + quad.numel()) + 4 * n_join * k_join)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    n_ops = n_sph_hits * BWD_SPHERE_OPS + n_quad_hits * BWD_QUAD_OPS
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def backward_parity_and_timing(dev, card, sets):
    """Phase 9.  Returns the closest_hit_bwd record at the train step's
    shapes (scene 1, R = 202,800)."""
    err = 0.0
    for k, (name, (scene, rays, fwd)) in enumerate(sets.items()):
        args = bwd_args(scene, rays, fwd, *random_cotangents(
            rays.shape[1], dev, 10 + k))
        e, rel = compare_bwd(f"{name}/bwd", args)
        err = max(err, e)
        log(f"bwd parity {name}: R={rays.shape[1]} "
            f"hits={int((args[1] > 0).sum())} d_rays bit-equal; table sums "
            f"max |diff| {e:.3e}, max |diff| / sum|terms| {rel:.3e} (limit "
            f"{BWD_SUM_RTOL})")
    # the train step's first bounce: every pixel's camera ray, sample 0
    s1 = sets["scene1"][0]
    _w, cam = sc.random_spheres()
    cam = cam.replace(image_width=GRAD_W, image_height=GRAD_H, sqrt_spp=2,
                      bounce_limit=8).to(dev)
    R = GRAD_W * GRAD_H
    pix = torch.arange(R, device=dev)
    ro, rd, tme = get_rays_soa(cam, derive_basis(cam), SEED, pix,
                               torch.zeros_like(pix))
    rays = ch.stack_rays(ro, rd, tme)
    fwd = ch._launch(s1.packed["none"], rays, T_MIN)
    args = bwd_args(s1, rays, fwd, *random_cotangents(R, dev, 9))
    e, rel = compare_bwd("scene1 grad/bwd", args)
    err = max(err, e)
    ms = time_ms(lambda: ch._launch_bwd(*args))
    plain = time_ms(lambda: ch.closest_hit_bwd_reference(*args), reps=5,
                    warmup=1)
    b, by = bwd_bound_ms(args)
    hits = int((args[1] > 0).sum())
    ground = int((args[2][args[1] == K_SPHERE] == int(torch.argmax(
        s1.data.sph_radius))).sum())
    log(f"bwd timing scene1 grad R={R} ({hits} hits, {ground} on the ground "
        f"sphere): kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {b:.4f} "
        f"ms by {by} | {card}")
    return {"err": err, "ms": ms, "plain_ms": plain, "bound_ms": b,
            "bound_by": by}


def step_grads_ok(loss, grads, need=()):
    assert bool(torch.isfinite(loss)), f"loss {float(loss)}"
    for k, g in grads.items():
        assert bool(torch.isfinite(g).all()), f"non-finite grad {k}"
    for k in need:
        assert bool((grads[k] != 0).any()), f"zero grad {k}"


def train_step_main_path(dev, card):
    """Phase 10: the scene-1 train step at bench.py --grad's config."""
    world, cam = sc.random_spheres()
    data, meta = world.compile()
    cam = cam.replace(image_width=GRAD_W, image_height=GRAD_H, sqrt_spp=2,
                      bounce_limit=8)
    steps_per_run = len(GRAD_SEEDS)
    per_step = cam.sqrt_spp ** 2 * cam.bounce_limit
    n_paths = GRAD_W * GRAD_H * cam.sqrt_spp ** 2
    target = np.zeros((GRAD_H, GRAD_W, 3), np.float32)
    step = make_train_step(meta)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    loss, grads = step(data, cam, target, GRAD_SEEDS[0])
    float(loss)
    walls = []
    for seed in GRAD_SEEDS[1:]:
        t0 = time.perf_counter()
        loss, grads = step(data, cam, target, seed)
        float(loss)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    step_grads_ok(loss, grads, ("sph_center", "mat_albedo", "tex_color"))
    assert counts["none"] == steps_per_run * per_step, counts
    assert counts["bwd"] == steps_per_run * per_step, counts
    wall = statistics.median(walls)
    log(f"main path train step scene1 {GRAD_W}x{GRAD_H} @ "
        f"{cam.sqrt_spp ** 2}spp depth {cam.bounce_limit}: median wall "
        f"{wall:.3f} s ({', '.join(f'{w:.3f}' for w in walls)}), "
        f"{n_paths / wall:.1f} grad paths/s, loss {float(loss):.6f}, "
        f"launches per step none {counts['none'] // steps_per_run} bwd "
        f"{counts['bwd'] // steps_per_run} ({steps_per_run} steps), peak "
        f"memory {peak / 2 ** 30:.3f} GiB | {card}")
    return counts


def lockstep_render(dev):
    """Phase 11: the lockstep render of scene 1 on the card, through the
    kernel and through the plain closest hit, and against the wavefront."""
    world, cam = sc.random_spheres()
    data, meta = world.compile()
    cam = cam.replace(image_width=200, image_height=112, sqrt_spp=4,
                      bounce_limit=20)
    reset_counts()
    a = render(data, meta, cam, seed=SEED)
    counts = read_counts()
    assert counts["none"] > 0, "the lockstep render launched no kernel"
    b = render(data, meta, cam, seed=SEED, use_kernel=False)
    c = render_wavefront(data, meta, cam, dev, seed=SEED)
    a, b, c = (x.cpu().numpy() for x in (a, b, c))
    assert np.isfinite(a).all(), "non-finite pixels"
    fp, mp = assert_images_close(a, b)
    fw, mw = assert_images_close(a, c)
    log(f"lockstep render scene1 200x112 @ 16spp depth 20: kernel "
        f"({counts['none']} launches) vs plain frac_within={fp:.5f}, "
        f"mean_abs={mp:.3e}; vs render_wavefront frac_within={fw:.5f}, "
        f"mean_abs={mw:.3e}")


def train_step_card_vs_cpu(dev):
    """Phase 12: the Cornell box step through the kernels on the card
    against the same step through their plain versions on the CPU."""
    world, cam = sc.cornell_box()
    data, meta = world.compile()
    cam = cam.replace(image_width=12, image_height=12, sqrt_spp=2,
                      bounce_limit=6)
    target = render(data, meta, cam, seed=SEED).cpu().numpy() * 0.9
    reset_counts()
    loss, grads = make_train_step(meta)(data, cam, target, SEED)
    counts = read_counts()
    assert counts["none"] > 0 and counts["bwd"] > 0, counts
    c_loss, c_grads = make_train_step(meta, device="cpu", use_kernel=True)(
        data, cam, target, SEED)
    step_grads_ok(loss, grads)
    scale = max(float(g.abs().max()) for g in c_grads.values())
    worst = 0.0
    for k, g in grads.items():
        g, w = g.cpu(), c_grads[k]
        # the two run the same ops, but CUDA's and the CPU's exp, log, sin
        # and pow may differ in the last bit, and the CPU sums in another
        # order: the tolerance of the port-vs-JAX gradient tests
        torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-5 * scale,
                                   msg=lambda m, k=k: f"{k}: {m}")
        worst = max(worst, float((g - w).abs().max()) / scale)
    torch.testing.assert_close(loss.cpu(), c_loss, rtol=1e-4, atol=0.0)
    x_loss, x_grads = make_train_step(meta, use_kernel=False)(
        data, cam, target, SEED)
    step_grads_ok(x_loss, x_grads)
    log(f"train step cornell 12x12 @ 4spp depth 6: card loss "
        f"{float(loss):.7f} vs CPU {float(c_loss):.7f}; grads max |diff| / "
        f"max|g| {worst:.3e}; card intersect_best route loss "
        f"{float(x_loss):.7f}, grads finite")


def render_pair(data, meta, cam, dev):
    """The kernel's and the plain closest hit's image of one config, and
    the kernel launches per mode of the first."""
    reset_counts()
    a = render_wavefront(data, meta, cam, dev, seed=SEED)
    counts = read_counts()
    b = render_wavefront(data, meta, cam, dev, seed=SEED, use_kernel=False)
    assert bool(torch.isfinite(a).all()), "non-finite pixels"
    return a.cpu().numpy(), b.cpu().numpy(), counts


def main_path(name, world, cam, dev, card):
    """Drive ``render_wavefront`` once at ``cam``'s config; returns the
    launch counts per mode."""
    data, meta = world.compile()
    spp = cam.sqrt_spp ** 2
    n_paths = cam.image_width * cam.image_height * spp
    reset_counts()
    t0 = time.perf_counter()
    img, stats = render_wavefront(data, meta, cam, dev, seed=SEED,
                                  return_stats=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    assert sum(counts.values()) > 0, f"{name}: the kernel never launched"
    assert img.shape == (cam.image_height, cam.image_width, 3)
    assert bool(torch.isfinite(img).all()), "non-finite pixels"
    mean = float(img.mean())
    assert 0.01 < mean < 2.0, f"implausible image mean {mean}"
    segs = stats["useful_segments"]
    log(f"main path {name} {cam.image_width}x{cam.image_height} @ {spp}spp "
        f"depth {cam.bounce_limit}: wall {wall:.3f} s, "
        f"{n_paths / wall:.1f} paths/s, {segs / wall:.1f} segments/s, "
        f"occupancy {segs / stats['slots_executed']:.4f}, "
        f"{stats['iterations']} rounds, kernel launches {counts}, "
        f"image mean {mean:.5f} | {card}")
    return counts


def main():
    t_start = time.perf_counter()
    # ---- 1. card ----
    dev = require_cuda()
    card = card_line()
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    log(f"card: {torch.cuda.get_device_name(dev)} | nvidia-smi: {card} | "
        f"SM clock, max SM clock: {clocks} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | devices {torch.cuda.device_count()}")

    # ---- 2. build ----
    t0 = time.perf_counter()
    built = _build.library_path("closest_hit").exists()
    _build.load_library("closest_hit")
    build_s = time.perf_counter() - t0
    log(f"build: closest_hit {'loaded from cache' if built else 'compiled'}"
        f" in {build_s:.2f} s -> {_build.library_path('closest_hit')}")

    # ---- 3. philox ----
    u = rng.uniform4(SEED, torch.tensor([123], device=dev),
                     torch.tensor([4], device=dev), 2, 1)
    got = [float(x[0]) for x in u]
    want = [0.7667282223701477, 0.9874579310417175,
            0.48183852434158325, 0.6557576656341553]
    assert got == want, f"philox on the card: {got} != {want}"
    log(f"philox: pinned vector reproduced bit for bit on {dev}")

    # ---- 4. every mode vs the plain version, and timings ----
    kern, sets = parity_and_timing(dev, card)
    log(f"phase 4 done at {time.perf_counter() - t_start:.1f} s")

    # ---- 5. main path: scene 1 at its bench config ----
    world1, cam1 = sc.random_spheres()
    counts1 = main_path("scene1", world1, cam1, dev, card)
    data1, meta1 = world1.compile()
    small = cam1.replace(image_width=200, image_height=112, sqrt_spp=4)
    a, b, _ = render_pair(data1, meta1, small, dev)
    # on the card index_add_ adds in atomic order, so the last bits of a
    # pixel can vary from run to run: compare by the image rule
    frac, mdiff = assert_images_close(a, b)
    log(f"main path kernel vs plain closest-hit, scene1 "
        f"{small.image_width}x{small.image_height} @ {small.sqrt_spp ** 2}spp"
        f" depth {small.bounce_limit}: frac_within={frac:.5f}, "
        f"mean_abs={mdiff:.3e}")

    # ---- 6. main path: scene 9 at its code-true config ----
    world9, cam9 = sc.final_scene(400, 250, 4)
    counts9 = main_path("scene9", world9, cam9, dev, card)
    assert counts9["none"] > 0, "scene 9's auto accel should be none"

    # ---- 7. scene 9 four ways: none, bvh, cull kernels and plain ----
    data9, meta9 = world9.compile()
    small9 = cam9.replace(image_width=100, image_height=100, sqrt_spp=4)
    imgs, four_counts = {}, {}
    for mode in ch.ACCELS:
        reset_counts()
        imgs[mode] = render_wavefront(data9, meta9, small9, dev, seed=SEED,
                                      accel=mode).cpu().numpy()
        four_counts[mode] = read_counts()[mode]
        assert four_counts[mode] > 0, f"{mode}: no launch"
    plain = render_wavefront(data9, meta9, small9, dev, seed=SEED,
                             use_kernel=False).cpu().numpy()
    for mode in ch.ACCELS:
        frac, mdiff = assert_images_close(imgs[mode], plain)
        log(f"scene9 100x100 @ 16spp depth 4, {mode} kernel "
            f"({four_counts[mode]} launches) vs plain: frac_within="
            f"{frac:.5f}, mean_abs={mdiff:.3e}")

    # ---- 8. every scene on the card, and the 16k-sphere scene ----
    for idx in (2, 3, 4, 5, 6, 7, 8, 10):
        world, cam = sc.build_scene(idx)
        data, meta = world.compile()
        h = max(1, int(48 * cam.image_height / cam.image_width))
        golden = cam.replace(image_width=48, image_height=h, sqrt_spp=2,
                             bounce_limit=8)
        a, b, counts = render_pair(data, meta, golden, dev)
        assert counts["none"] > 0, f"scene {idx}: no kernel launch"
        frac, mdiff = assert_images_close(a, b)
        log(f"scene{idx} golden config: kernel ({counts['none']} launches) "
            f"vs plain frac_within={frac:.5f}, mean_abs={mdiff:.3e}, "
            f"image mean {float(a.mean()):.4f}")
    world16, cam16 = sc.spread_spheres()
    data16, meta16 = world16.compile()
    small16 = cam16.replace(image_width=160, image_height=90, sqrt_spp=2,
                            bounce_limit=4)
    a, b, counts16 = render_pair(data16, meta16, small16, dev)
    assert counts16["bvh"] > 0, "16k spheres: the auto policy ran no bvh"
    frac, mdiff = assert_images_close(a, b)
    log(f"spread16k 160x90 @ 4spp depth 4, auto accel: bvh kernel "
        f"({counts16['bvh']} launches) vs plain frac_within={frac:.5f}, "
        f"mean_abs={mdiff:.3e}")

    # ---- 9. the backward kernel vs its plain version, and timings ----
    kern["bwd"] = backward_parity_and_timing(dev, card, sets)
    del sets
    log(f"phase 9 done at {time.perf_counter() - t_start:.1f} s")

    # ---- 10. main path: the scene-1 train step ----
    counts10 = train_step_main_path(dev, card)
    log(f"phase 10 done at {time.perf_counter() - t_start:.1f} s")

    # ---- 11. the lockstep render on the card ----
    lockstep_render(dev)

    # ---- 12. the Cornell train step, card against CPU ----
    train_step_card_vs_cpu(dev)

    launches = {"none": counts9["none"],
                "bvh": four_counts["bvh"] + counts16["bvh"],
                "cull": four_counts["cull"], "bwd": counts10["bwd"]}
    log(f"launches: none {counts9['none']} (scene 9 main path; scene 1 main "
        f"path {counts1['none']}), bvh {launches['bvh']} (scene 9 four-way "
        f"{four_counts['bvh']} + spread16k {counts16['bvh']}), cull "
        f"{launches['cull']} (scene 9 four-way), bwd {launches['bwd']} "
        f"(the train step main path, {len(GRAD_SEEDS)} steps)")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    names = {"none": "closest_hit", "bvh": "closest_hit_bvh",
             "cull": "closest_hit_cull", "bwd": "closest_hit_bwd"}
    replaces = dict.fromkeys(ch.ACCELS,
                             "mort_tpu/render/pallas_intersect.py:1215")
    replaces["bwd"] = "mort_tpu/render/pallas_intersect.py:1305"
    shapes = dict.fromkeys(ch.ACCELS, f"scene9 R={R_SCENE9}")
    shapes["bwd"] = f"scene1 grad R={GRAD_W * GRAD_H}"
    log(json.dumps({"kernels": [{
        "name": names[k], "route": "cuda",
        "source": "mort_tpu_torch/csrc/closest_hit.cu",
        "replaces": replaces[k], "launches": launches[k],
        "max_abs_err": kern[k]["err"], "ms": kern[k]["ms"],
        "plain_ms": kern[k]["plain_ms"], "bound_ms": kern[k]["bound_ms"],
        "bound_by": kern[k]["bound_by"], "library_ms": None,
        "shape": shapes[k]} for k in ch.ACCELS + ("bwd",)]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
