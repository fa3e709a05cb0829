#!/usr/bin/env python3
"""Build and run the port on one NVIDIA card, as a user would.

    python3 chip_smoke.py

Phases, one line each (any failure raises and exits non-zero):

1. card: the device, its name and power limit (nvidia-smi), versions;
2. build: nvcc-compiles csrc/closest_hit.cu (or loads it from the build
   cache) and reports the seconds;
3. philox: the pinned Philox vector of tests/test_rng.py, on the card;
4. parity: the CUDA closest-hit kernel against its plain PyTorch version
   on the same card tensors — scene 1's tables with 2^18 rays (camera rays
   plus one bounce) and a moving sphere/quad scene — then both timed at
   R = 2^18 with CUDA events;
5. main path: ``render_wavefront`` of scene 1 at its bench config
   (1200x675, 100 spp, depth 20, default pool/window/spt) with the
   kernel's launch count reset just before and read just after; then, at
   a reduced config, the same render through the kernel and through the
   plain closest-hit must agree by the image rule of tests/conftest.py.

The line before the last is the nvidia-smi name/power line, the one before
it a JSON record of the kernels (launches in the main path, the largest
|dt| against the plain version, kernel and plain ms); the last line is a
JSON object with ``ok`` and the device.  Imports neither jax nor the JAX
package.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from mort_tpu_torch import render_wavefront, require_cuda  # noqa: E402
from mort_tpu_torch import _build, rng  # noqa: E402
from mort_tpu_torch.device import card_line  # noqa: E402
from mort_tpu_torch.camera import derive_basis, get_rays_soa  # noqa: E402
from mort_tpu_torch.render import closest_hit as ch  # noqa: E402
from mort_tpu_torch.render.hitshade import finalize_and_shade  # noqa: E402
from mort_tpu_torch.render.intersect import quad_frames  # noqa: E402
from mort_tpu_torch.render.primtable import build_prim_table  # noqa: E402
from mort_tpu_torch.render.vec import V3  # noqa: E402
from mort_tpu_torch.scene import scenes as sc  # noqa: E402
from mort_tpu_torch.scene.build import World  # noqa: E402

R_PARITY = 1 << 18          # the default pool of scene 1: the kernel's R
T_RTOL, T_ATOL = 3e-5, 1e-5
SEED = 69420


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


def pack(world, dev):
    data, meta = world.compile()
    data = data.to(dev)
    qf = quad_frames(data)
    table, mat_cols = build_prim_table(data, meta, qf)
    return data, meta, qf, table, mat_cols, ch.pack_scene(data, meta, qf,
                                                          table)


def scene1_rays(dev):
    """R_PARITY rays of scene 1: camera rays, and the bounce each takes."""
    world, cam = sc.random_spheres()
    data, meta, qf, table, mat_cols, packed = pack(world, dev)
    cam = cam.to(dev)
    g = torch.Generator().manual_seed(1)
    n = R_PARITY // 2
    pix = torch.randint(0, cam.image_width * cam.image_height, (n,),
                        generator=g).to(dev)
    smp = torch.randint(0, cam.sqrt_spp ** 2, (n,), generator=g).to(dev)
    ro, rd, tme = get_rays_soa(cam, derive_basis(cam), SEED, pix, smp,
                               no_defocus=True)
    bt, bk, bi, row = ch.closest_hit(packed, ro, rd, tme)
    out = finalize_and_shade(data, meta, qf, table, mat_cols, ro, rd, tme,
                             bt, bk, bi, SEED, pix, smp, 0, row_t=row)
    cat = lambda a, b: torch.cat([a, b])  # noqa: E731
    ro2 = V3(*(cat(a, b) for a, b in zip(ro, out.p)))
    rd2 = V3(*(cat(a, b) for a, b in zip(rd, out.new_dir)))
    return packed, ro2, rd2, cat(tme, tme)


def moving_mixed_rays(dev):
    """A moving sphere/quad scene (test_pallas_kernel.py's _mixed_world
    shape, larger) and R_PARITY random rays."""
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
    packed = pack(w, dev)[-1]
    g = np.random.RandomState(3)
    ro = torch.from_numpy((g.randn(R_PARITY, 3) * 6).astype(np.float32))
    rd = torch.from_numpy(g.randn(R_PARITY, 3).astype(np.float32))
    tme = torch.from_numpy(g.rand(R_PARITY).astype(np.float32))
    return (packed, V3.from_rows(ro.to(dev)), V3.from_rows(rd.to(dev)),
            tme.to(dev))


def compare(name, packed, ro, rd, tme):
    """Kernel vs plain version on the same card tensors.  Returns the
    largest |difference| over t (hit lanes) and the joined rows."""
    rays = ch.stack_rays(ro, rd, tme)
    got = ch._launch(packed, rays, ch.T_MIN)
    want = ch.closest_hit_reference(packed, rays)
    torch.cuda.synchronize()
    kind, wkind = got[ch.ROW_KIND], want[ch.ROW_KIND]
    hit = wkind > 0
    assert torch.equal(kind, wkind), f"{name}: kind differs"
    assert torch.equal(got[ch.ROW_IDX][hit], want[ch.ROW_IDX][hit]), \
        f"{name}: idx differs"
    t, wt = got[ch.ROW_T][hit], want[ch.ROW_T][hit]
    assert torch.isinf(got[ch.ROW_T][~hit]).all(), f"{name}: miss t"
    assert torch.allclose(t, wt, rtol=T_RTOL, atol=T_ATOL), f"{name}: t"
    rows_equal = torch.equal(got[:ch.ROW_T, hit], want[:ch.ROW_T, hit])
    assert rows_equal, f"{name}: joined rows differ on hit lanes"
    err = float((t - wt).abs().max()) if hit.any() else 0.0
    log(f"parity {name}: R={rays.shape[1]} hits={int(hit.sum())} kind/idx "
        f"equal, max|dt|={err:.3e} (rtol {T_RTOL}), rows equal")
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


def main():
    t_start = time.perf_counter()
    # ---- 1. card ----
    dev = require_cuda()
    card = card_line()
    log(f"card: {torch.cuda.get_device_name(dev)} | nvidia-smi: {card} | "
        f"torch {torch.__version__} cuda {torch.version.cuda} | "
        f"devices {torch.cuda.device_count()}")

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

    # ---- 4. kernel vs plain version ----
    packed1, ro, rd, tme = scene1_rays(dev)
    err = compare("scene1", packed1, ro, rd, tme)
    err = max(err, compare("moving_mixed", *moving_mixed_rays(dev)))
    rays = ch.stack_rays(ro, rd, tme)
    k_ms = time_ms(lambda: ch._launch(packed1, rays, ch.T_MIN))
    p_ms = time_ms(lambda: ch.closest_hit_reference(packed1, rays), reps=5)
    k_ms2 = time_ms(lambda: ch._launch(packed1, rays, ch.T_MIN))
    log(f"timing closest_hit scene1 R={rays.shape[1]}: kernel {k_ms:.4f} ms"
        f" (again {k_ms2:.4f} ms), plain {p_ms:.4f} ms | {card}")

    # ---- 5. main path: scene 1 at its bench config ----
    world, cam = sc.random_spheres()
    data, meta = world.compile()
    spp = cam.sqrt_spp ** 2
    n_paths = cam.image_width * cam.image_height * spp
    torch.cuda.synchronize()
    ch.launch_count = 0
    t0 = time.perf_counter()
    img, stats = render_wavefront(data, meta, cam, dev, seed=SEED,
                                  return_stats=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ch.launch_count
    assert launches > 0, "the main path never launched the kernel"
    assert img.shape == (cam.image_height, cam.image_width, 3)
    assert bool(torch.isfinite(img).all()), "non-finite pixels"
    mean = float(img.mean())
    assert 0.05 < mean < 2.0, f"implausible image mean {mean}"
    segs = stats["useful_segments"]
    log(f"main path scene1 {cam.image_width}x{cam.image_height} @ {spp}spp "
        f"depth {cam.bounce_limit}: wall {wall:.3f} s, "
        f"{n_paths / wall:.1f} paths/s, {segs / wall:.1f} segments/s, "
        f"occupancy {segs / stats['slots_executed']:.4f}, "
        f"{stats['iterations']} rounds, kernel launches {launches}, "
        f"image mean {mean:.5f} | {card}")

    small = cam.replace(image_width=200, image_height=112, sqrt_spp=4)
    a = render_wavefront(data, meta, small, dev, seed=SEED).cpu().numpy()
    b = render_wavefront(data, meta, small, dev, seed=SEED,
                         use_kernel=False).cpu().numpy()
    # on the card index_add_ adds in atomic order, so the last bits of a
    # pixel can vary from run to run: compare by the image rule
    frac, mdiff = assert_images_close(a, b)
    log(f"main path kernel vs plain closest-hit, scene1 "
        f"{small.image_width}x{small.image_height} @ {small.sqrt_spp ** 2}spp"
        f" depth {small.bounce_limit}: frac_within={frac:.5f}, "
        f"mean_abs={mdiff:.3e}")

    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": [{
        "name": "closest_hit", "route": "cuda",
        "source": "mort_tpu_torch/csrc/closest_hit.cu",
        "replaces": "mort_tpu/render/pallas_intersect.py:1215",
        "launches": launches, "max_abs_err": err,
        "ms": k_ms, "plain_ms": p_ms}]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
