"""Sweep the wavefront's scheduling knobs (spt, window, span size, pool)
on the card for the bench workloads.

The port's counterpart of ``tools/tune_wavefront.py``: its seven (spt,
window, span) configs, each at every pool of ``--pools`` (default: the
port's default pool of the scene), on the scene's full geometry with spp
cut to at most 49 (sqrt_spp 7) as the JAX tool cuts it.  Each config
renders once to warm up, then once timed, and prints one line: seconds,
paths/s, lane occupancy and the warm-up's seconds.  The sweep only
measures; it changes no default.

    python -m mort_tpu_torch.tune_wavefront [scene ...]      # default 8 1
    python -m mort_tpu_torch.tune_wavefront 1 --pools 65536 262144
    python -m mort_tpu_torch.tune_wavefront 5 --device cpu --width 16 --spp 4
"""

from __future__ import annotations

import argparse
import time

import torch

from .cli import override_camera
from .device import device_line, require_cuda, synchronize
from .render.wavefront import default_pool, render_wavefront
from .scene import scenes as sc

# (spt, window, span in M camera paths)
CONFIGS = ((16, 8, 200), (8, 8, 200), (4, 8, 200), (2, 8, 200),
           (4, 4, 200), (4, 8, 80), (4, 8, 400))
MAX_SQRT_SPP = 7


def sweep(idx, device=None, pools=None, width=None, spp=None, depth=None,
          configs=CONFIGS, log=print) -> list:
    """Every (spt, window, span) of ``configs`` at every pool of ``pools``
    (None: the default pool) on scene ``idx``; returns one dict a run."""
    device = require_cuda() if device is None else torch.device(device)
    world, cam = sc.random_spheres() if idx == 1 else sc.build_scene(idx)
    data, meta = world.compile()
    cam = override_camera(cam.replace(sqrt_spp=min(cam.sqrt_spp,
                                                   MAX_SQRT_SPP)),
                          width, spp, depth)
    W, H = cam.image_width, cam.image_height
    n_paths = W * H * cam.sqrt_spp ** 2
    pools = pools or [default_pool(meta, W * H)]
    card = device_line(device)
    log(f"scene {idx}: {W}x{H} @ {cam.sqrt_spp ** 2}spp depth "
        f"{cam.bounce_limit}"
        f" ({n_paths / 1e6:.2f}M paths), default pool "
        f"{default_pool(meta, W * H)} | {card}")
    out = []
    for pool in pools:
        for spt, window, span_m in configs:
            rkw = dict(spt=spt, window=window, pool=pool,
                       max_paths_per_call=span_m * 1_000_000)
            t0 = time.perf_counter()
            render_wavefront(data, meta, cam, device, seed=1, **rkw)
            synchronize(device)
            warm_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            _, st = render_wavefront(data, meta, cam, device, seed=2,
                                     return_stats=True, **rkw)
            synchronize(device)
            dt = time.perf_counter() - t0
            occ = st["useful_segments"] / max(st["slots_executed"], 1)
            rec = {"scene": idx, "spt": spt, "window": window,
                   "span_m": span_m, "pool": pool, "seconds": dt,
                   "paths_per_s": n_paths / dt, "occupancy": occ,
                   "warmup_s": warm_s}
            out.append(rec)
            log(f"  spt={spt:2d} w={window} span={span_m:3d}M pool={pool}: "
                f"{dt:8.3f}s {n_paths / dt / 1e6:8.3f}M paths/s occ "
                f"{occ:.3f} (warm-up {warm_s:.2f}s)")
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(prog="python -m mort_tpu_torch.tune_wavefront",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("scenes", type=int, nargs="*", default=[8, 1])
    ap.add_argument("--pools", type=int, nargs="*", default=None,
                    help="lane pools to sweep (default: the default pool)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--spp", type=int, default=None,
                    help=f"samples per pixel (default: the scene's, at most "
                         f"{MAX_SQRT_SPP ** 2})")
    ap.add_argument("--depth", type=int, default=None)
    a = ap.parse_args(argv)
    device = require_cuda() if a.device is None else torch.device(a.device)
    out = []
    for idx in a.scenes:
        out += sweep(idx, device, a.pools, a.width, a.spp, a.depth,
                     log=lambda m: print(m, flush=True))
    return out


if __name__ == "__main__":
    main()
