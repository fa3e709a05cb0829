"""Where the wavefront's time goes on the card: one torch.profiler window.

    python -m mort_tpu_torch.profile_wavefront [--scene {1..10,spread16k}]
                                               [--tasks N]

Renders a reference scene at its code-true config (scene 1, the default:
1200x675, 100 spp, depth 20; scene 9: 400x400, 250 spp, depth 4), or the
16,384-sphere ``spread16k`` at its own (400x225, 4 spp, depth 8, auto accel
"bvh"), over the first ``--tasks`` chunk-tasks (tasks past a frame's last
are further sample chunks: spread16k's frame is 90,000 tasks), after a
warm-up span: once plainly for the wall time, then once under
``torch.profiler`` (CPU + CUDA).  The spans run as ``render_wavefront``
runs them on a card: every round a replay of the span program that the
warm-up captured and that the same graph key keeps (the profiler
attributes the kernels of a replay like eager ones).  Prints the device
time by kernel, the closest-hit kernel's share of it by accel mode, the
device's busy and idle shares of the unprofiled wall time, device kernels
per bounce step, host syncs, graphs captured and replayed, capture
seconds and peak device memory, beside the card's name and power limit.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from . import require_cuda
from .device import card_line
from .render import closest_hit as ch
from .render import wavefront as wf
from .render.wavefront import render_wavefront
from .scene import scenes as sc


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


@dataclasses.dataclass
class DeviceKernel:
    """One kernel name's device time (us) and launches in a window, with
    the names of ``key_averages()``'s rows (``_device_us`` reads both)."""
    key: str
    count: int = 0
    self_device_time_total: float = 0.0


def device_times(prof):
    """(device kernels, busy us, launches, closest-hit us by accel mode)
    of a finished ``torch.profiler`` window, summed over its raw device
    events in one pass: ``key_averages()`` spends ~0.1 ms an event, minutes
    for a frame's ~10^6 kernels, this a few seconds."""
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        k = by_name.get(e.name())
        if k is None:
            k = by_name[e.name()] = DeviceKernel(e.name())
        k.count += 1
        k.self_device_time_total += e.duration_ns() / 1e3
    kernels = list(by_name.values())
    modes = {m: sum(_device_us(e) for e in kernels
                    if f"closest_hit_{m}_" in e.key)
             for m in ch.ACCELS}
    return (kernels, sum(_device_us(e) for e in kernels),
            sum(e.count for e in kernels), modes)


def build(scene):
    """(world, camera) of ``--scene``: a reference scene's number or
    "spread16k"."""
    if scene == "spread16k":
        return sc.spread_spheres()
    return sc.build_scene(int(scene))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="1",
                    choices=[str(i) for i in range(1, 11)] + ["spread16k"])
    ap.add_argument("--tasks", type=int, default=1 << 20,
                    help="chunk-tasks to render (up to 8 paths each)")
    args = ap.parse_args(argv)

    dev = require_cuda()
    card = card_line()
    world, cam = build(args.scene)
    data, meta = world.compile()
    kw = dict(seed=69420, task_range=(0, args.tasks), return_stats=True)
    render_wavefront(data, meta, cam, dev, seed=1, task_range=(0, 4096))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mode in ch.launch_count:
        ch.launch_count[mode] = 0
    before = dict(wf.graph_count)
    t0 = time.perf_counter()
    _, stats = render_wavefront(data, meta, cam, dev, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = sum(ch.launch_count.values())
    graphs = {k: wf.graph_count[k] - n for k, n in before.items()}
    peak = torch.cuda.max_memory_allocated()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        render_wavefront(data, meta, cam, dev, **kw)
        torch.cuda.synchronize()
    kernels, busy_us, n_launch, modes = device_times(prof)
    ch_us = sum(modes.values())

    print(f"scene {args.scene} {cam.image_width}x{cam.image_height} @ "
          f"{cam.sqrt_spp ** 2}spp depth {cam.bounce_limit}, tasks "
          f"[0, {args.tasks}): wall {wall:.4f} s "
          f"unprofiled, {stats['iterations']} rounds, {steps} bounce steps, "
          f"occupancy {stats['useful_segments'] / stats['slots_executed']:.4f}"
          f" | {card}")
    print(f"span graphs: {graphs['spans']} spans, {graphs['captures']} "
          f"captured in {graphs['capture_s']:.4f} s, {graphs['replays']} of "
          f"{graphs['rounds']} rounds replayed; {graphs['syncs']} host syncs; "
          f"peak device memory {peak / 2 ** 30:.4f} GiB")
    print(f"device busy {busy_us / 1e6:.4f} s = "
          f"{busy_us / 1e6 / wall:.4f} of the unprofiled wall "
          f"(idle share {1 - busy_us / 1e6 / wall:.4f}); "
          f"{n_launch} kernel launches = {n_launch / max(steps, 1):.1f} per "
          f"bounce step; closest_hit {ch_us / 1e6:.4f} s = "
          f"{ch_us / max(busy_us, 1):.4f} of device time ("
          + ", ".join(f"{m} {us / max(busy_us, 1):.4f}"
                      for m, us in modes.items() if us) + ")")
    print("top kernels by device time (s, launches, name):")
    for e in sorted(kernels, key=_device_us, reverse=True)[:20]:
        print(f"  {_device_us(e) / 1e6:9.4f} {e.count:8d}  {e.key[:100]}")


if __name__ == "__main__":
    main()
