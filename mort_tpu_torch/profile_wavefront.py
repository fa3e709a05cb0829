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
per bounce step, host reads, graphs captured and replayed, capture
seconds and peak device memory, beside the card's name and power limit;
then the program's span totals and counters (``metrics``) of the
unprofiled render, and the profiled window's device idle seconds by the
innermost program span open on the host.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import bisect
import dataclasses
import re
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from . import metrics, require_cuda
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


# a program span's name on the profiler's timeline: "<layer>.<part>"
# (``metrics.span``); torch's operators ("aten::"), the runtime's calls and
# the profiler's own events are named otherwise
SPAN_NAME = re.compile(r"^[a-z_]+\.[a-z_]+$")
OUTSIDE = "outside any span"


def _innermost(spans):
    """The timeline cut where the innermost open span changes: sorted
    ``(start, end, name)`` pieces of nested ``(start, end, name)`` spans
    (one host thread's)."""
    pieces, stack, t = [], [], None
    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            end, top = stack.pop()
            pieces.append((t, end, top))
            t = end
        if stack:
            pieces.append((t, s, stack[-1][1]))
        stack.append((e, name))
        t = s
    while stack:
        end, top = stack.pop()
        pieces.append((t, end, top))
        t = end
    return [p for p in pieces if p[1] > p[0]]


def idle_by_span(prof, long_ns=1_000_000):
    """The device's idle time in a finished ``torch.profiler`` window by
    the innermost program span (``metrics.span``'s range) open on the host
    meanwhile, from the raw events ``device_times`` walks: the gaps between
    the union of the device's operations, each cut where the innermost span
    changes.  Returns (seconds by span name, with ``OUTSIDE`` for time in
    no span; the gaps longer than ``long_ns`` as (start ns, length ns,
    {span: ns}) in time order)."""
    dev, spans = [], []
    for e in prof.profiler.kineto_results.events():
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append((s, s + d))
        elif d > 0 and SPAN_NAME.match(e.name()):
            spans.append((s, s + d, e.name()))
    gaps, end = [], None
    for s, e in sorted(dev):
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    pieces = _innermost(spans)
    starts = [p[0] for p in pieces]
    by_span, long = {}, []
    for g0, g1 in gaps:
        parts = {}
        i = max(0, bisect.bisect_right(starts, g0) - 1)
        covered = 0
        while i < len(pieces) and pieces[i][0] < g1:
            lo, hi = max(g0, pieces[i][0]), min(g1, pieces[i][1])
            if hi > lo:
                parts[pieces[i][2]] = parts.get(pieces[i][2], 0) + hi - lo
                covered += hi - lo
            i += 1
        if g1 - g0 > covered:
            parts[OUTSIDE] = g1 - g0 - covered
        for name, ns in parts.items():
            by_span[name] = by_span.get(name, 0.0) + ns / 1e9
        if g1 - g0 > long_ns:
            long.append((g0, g1 - g0, parts))
    return by_span, long


def span_report(totals, counts) -> list:
    """Lines of the span totals (count, ms, self ms by path) and the
    counters, for a tool's output."""
    lines = [f"  {t.count:7d} {t.ns / 1e6:11.3f} ms {t.self_ns / 1e6:11.3f} "
             f"ms self  {path}" for path, t in sorted(totals.items())]
    lines += [f"  counter {k} {v}" for k, v in sorted(counts.items())]
    return lines


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
    metrics.reset_spans()
    before = dict(wf.graph_count)
    t0 = time.perf_counter()
    _, stats = render_wavefront(data, meta, cam, dev, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = sum(ch.launch_count.values())
    graphs = {k: wf.graph_count[k] - n for k, n in before.items()}
    peak = torch.cuda.max_memory_allocated()
    totals, counts = metrics.span_totals(), metrics.counters()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        render_wavefront(data, meta, cam, dev, **kw)
        torch.cuda.synchronize()
    kernels, busy_us, n_launch, modes = device_times(prof)
    idle, _ = idle_by_span(prof)
    ch_us = sum(modes.values())

    print(f"scene {args.scene} {cam.image_width}x{cam.image_height} @ "
          f"{cam.sqrt_spp ** 2}spp depth {cam.bounce_limit}, tasks "
          f"[0, {args.tasks}): wall {wall:.4f} s "
          f"unprofiled, {stats['iterations']} rounds, {steps} bounce steps, "
          f"occupancy {stats['useful_segments'] / stats['slots_executed']:.4f}"
          f" | {card}")
    print(f"span graphs: {graphs['spans']} spans, {graphs['captures']} "
          f"captured in {graphs['capture_s']:.4f} s, {graphs['replays']} of "
          f"{graphs['rounds']} rounds replayed; {graphs['syncs']} host reads; "
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
    print(f"spans of the unprofiled render (count, total, self, path) beside "
          f"its {graphs['rounds']} rounds and {graphs['replays']} replays:")
    print("\n".join(span_report(totals, counts)))
    print("profiled window's device idle (s) by innermost program span: "
          + ", ".join(f"{k} {v:.6f}" for k, v in
                      sorted(idle.items(), key=lambda kv: -kv[1])))


if __name__ == "__main__":
    main()
