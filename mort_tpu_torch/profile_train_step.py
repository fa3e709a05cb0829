"""Where the train step's time goes on the card.

    python -m mort_tpu_torch.profile_train_step [--width W --height H]

Runs ``make_train_step`` on scene 1 at ``bench.py --grad``'s config
(600x338, 4 spp, depth 8, zero target) after a warm-up step: once plainly
for the wall time, once by hand with the forward (to the loss) and the
backward (``torch.autograd.grad``) timed apart, and once under
``torch.profiler`` (CPU + CUDA).  Prints the two halves, the device's busy
and idle shares of the unprofiled wall time, device kernels per bounce,
the forward and backward closest-hit kernels' device time (the
backward's summed over its six ``closest_hit_bwd_*`` kernels), and the top
kernels, beside the card's name and power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from . import require_cuda
from .device import card_line
from .parallel.sharding import _extract_diff, _merge_diff, make_train_step
from .profile_wavefront import _device_us
from .render import closest_hit as ch
from .render.renderer import radiance_for_pixels
from .scene import scenes as sc


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--width", type=int, default=600)
    ap.add_argument("--height", type=int, default=338)
    args = ap.parse_args(argv)

    dev = require_cuda()
    card = card_line()
    world, cam = sc.random_spheres()
    data, meta = world.compile()
    cam = cam.replace(image_width=args.width, image_height=args.height,
                      sqrt_spp=2, bounce_limit=8)
    bounces = cam.sqrt_spp ** 2 * cam.bounce_limit
    target = np.zeros((cam.image_height, cam.image_width, 3), np.float32)
    step = make_train_step(meta)
    float(step(data, cam, target, 69420)[0])

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    float(step(data, cam, target, 69421)[0])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    # the step's own operands, then its two halves timed apart
    data_dev, cam_dev, tgt, pix = step.prep_cache["val"]
    diff = {k: v.detach().requires_grad_()
            for k, v in _extract_diff(data_dev).items()}
    t0 = time.perf_counter()
    img = radiance_for_pixels(_merge_diff(data_dev, diff), meta, cam_dev,
                              69422, pix, differentiable=True)
    loss = torch.mean((img - tgt) ** 2)
    float(loss.detach())
    t1 = time.perf_counter()
    torch.autograd.grad(loss, list(diff.values()), allow_unused=True)
    torch.cuda.synchronize()
    t2 = time.perf_counter()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        float(step(data, cam, target, 69423)[0])
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
    busy_us = sum(_device_us(e) for e in kernels)
    n_launch = sum(e.count for e in kernels)
    fwd_us = sum(_device_us(e) for e in kernels
                 if any(f"closest_hit_{m}_" in e.key
                        for m in ch.ACCELS))
    # the backward's six kernels (closest_hit_bwd_tile_kernel, ...)
    bwd = [e for e in kernels if "closest_hit_bwd_" in e.key]
    bwd_us = sum(_device_us(e) for e in bwd)
    n_bwd = max((e.count for e in bwd), default=0)

    print(f"train step scene1 {cam.image_width}x{cam.image_height} @ "
          f"{cam.sqrt_spp ** 2}spp depth {cam.bounce_limit}: wall {wall:.4f} "
          f"s unprofiled; forward {t1 - t0:.4f} s, backward {t2 - t1:.4f} s "
          f"| {card}")
    print(f"device busy {busy_us / 1e6:.4f} s = {busy_us / 1e6 / wall:.4f} "
          f"of the unprofiled wall (idle share "
          f"{1 - busy_us / 1e6 / wall:.4f}); {n_launch} kernel launches = "
          f"{n_launch / bounces:.1f} per bounce; closest_hit forward "
          f"{fwd_us / 1e6:.4f} s, backward {bwd_us / 1e6:.4f} s over its "
          f"{len(bwd)} kernels ({n_bwd} calls, "
          f"{bwd_us / 1e3 / max(n_bwd, 1):.4f} ms a call; "
          f"{ch.launch_count['bwd']} backward launches so far)")
    print("top kernels by device time (s, launches, name):")
    for e in sorted(kernels, key=_device_us, reverse=True)[:20]:
        print(f"  {_device_us(e) / 1e6:9.4f} {e.count:8d}  {e.key[:100]}")


if __name__ == "__main__":
    main()
