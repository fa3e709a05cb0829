"""Where the train step's time goes on the card, on both routes.

    python -m mort_tpu_torch.profile_train_step [--width W --height H]

Runs ``make_train_step`` on scene 1 at ``bench.py --grad``'s config
(600x338, 4 spp, depth 8, zero target) on the graph route (the step is
captured into a CUDA graph on its first call and replayed on every later
one) and on the eager route (``make_train_step``'s private ``_eager``), in
the order graph, eager, eager, graph: each route's first call (the graph
route's capture among it), two timed steps, then one step of each under
``torch.profiler`` (CUDA).  Prints for each route the step's wall, the
first call's and the capture's seconds, the device's busy and idle shares
of the step, device kernels per bounce, the forward and backward
closest-hit kernels' device time (the backward's summed over its six
``closest_hit_bwd_*`` kernels) and the top kernels, beside the card's name
and power limit; then the program's span totals and counters
(``metrics``) of the unprofiled timed steps beside ``step_graph_count``,
and each profiled step's device idle seconds by the innermost program
span open on the host.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from . import metrics, require_cuda
from .device import card_line
from .parallel.sharding import make_train_step, step_graph_count
from .profile_wavefront import (
    _device_us, device_times, idle_by_span, span_report,
)
from .scene import scenes as sc


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--width", type=int, default=600)
    ap.add_argument("--height", type=int, default=338)
    args = ap.parse_args(argv)

    require_cuda()
    card = card_line()
    world, cam = sc.random_spheres()
    data, meta = world.compile()
    cam = cam.replace(image_width=args.width, image_height=args.height,
                      sqrt_spp=2, bounce_limit=8)
    bounces = cam.sqrt_spp ** 2 * cam.bounce_limit
    target = np.zeros((cam.image_height, cam.image_width, 3), np.float32)
    routes = {"graph": make_train_step(meta),
              "eager": make_train_step(meta, _eager=True)}
    walls = {k: [] for k in routes}

    def timed(route, seed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(routes[route](data, cam, target, seed)[0])
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for route in routes:
        capture_s = step_graph_count["capture_s"]
        first = timed(route, 69420)
        print(f"{route} route: first call {first:.4f} s, of it capture "
              f"{step_graph_count['capture_s'] - capture_s:.4f} s | {card}")
    metrics.reset_spans()
    before = dict(step_graph_count)
    for seed, order in ((69421, ("graph", "eager")),
                        (69422, ("eager", "graph"))):
        for route in order:
            walls[route].append(timed(route, seed))
    graphs = {k: step_graph_count[k] - n for k, n in before.items()}
    print(f"spans of the four timed steps (count, total, self, path) beside "
          f"their {graphs['steps']} steps and {graphs['replays']} replays:")
    print("\n".join(span_report(metrics.span_totals(), metrics.counters())))

    for route in routes:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            timed(route, 69423)
        kernels, busy_us, n_launch, modes = device_times(prof)
        idle, _ = idle_by_span(prof)
        wall = statistics.median(walls[route])
        bwd = [e for e in kernels if "closest_hit_bwd_" in e.key]
        bwd_us = sum(_device_us(e) for e in bwd)
        n_bwd = max((e.count for e in bwd), default=0)
        fwd_us = sum(modes.values())
        print(f"{route} route, train step scene1 {cam.image_width}x"
              f"{cam.image_height} @ {cam.sqrt_spp ** 2}spp depth "
              f"{cam.bounce_limit}: wall {wall:.4f} s unprofiled "
              f"({', '.join(f'{w:.4f}' for w in walls[route])}) | {card}")
        print(f"  device busy {busy_us / 1e6:.4f} s = "
              f"{busy_us / 1e6 / wall:.4f} of the unprofiled wall (idle "
              f"share {1 - busy_us / 1e6 / wall:.4f}); {n_launch} device "
              f"kernels = {n_launch / bounces:.1f} per bounce; closest_hit "
              f"forward {fwd_us / 1e6:.4f} s, backward {bwd_us / 1e6:.4f} s "
              f"over its {len(bwd)} kernels ({n_bwd} calls, "
              f"{bwd_us / 1e3 / max(n_bwd, 1):.4f} ms a call)")
        print("  top kernels by device time (s, launches, name):")
        for e in sorted(kernels, key=_device_us, reverse=True)[:12]:
            print(f"  {_device_us(e) / 1e6:9.4f} {e.count:8d}  "
                  f"{e.key[:100]}")
        print("  device idle (s) by innermost program span: " + ", ".join(
            f"{k} {v:.6f}" for k, v in sorted(idle.items(),
                                               key=lambda kv: -kv[1])))


if __name__ == "__main__":
    main()
