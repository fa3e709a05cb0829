"""The traced slice: one ``torch.profiler`` window, read in one pass.

``profiled(fn)`` runs ``fn`` under the profiler (CPU and CUDA activity)
and returns what the per-layer metrics read: the device time and launches
of each kernel name, the seconds in which any device operation ran (the
union of their intervals), the slice's wall time, the top device
operations and the longest idle gaps by what the host was doing.  The raw
kineto events are summed directly: ``key_averages()`` takes ~0.1 ms an
event, minutes for a frame's 10^6 kernels.
"""

from __future__ import annotations

import bisect
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


# a breakdown entry keeps a kernel's name up to here (a templated
# elementwise kernel's full name runs to several hundred characters)
NAME_CHARS = 160


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profiled(fn, device) -> dict:
    _sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        _sync(device)
        wall = time.perf_counter() - t0
    return summarize(prof.profiler.kineto_results.events(), wall)


def _union(intervals):
    """(busy ns, gaps [(start, end)]) of sorted (start, end) intervals."""
    busy, gaps = 0, []
    cur_s = cur_e = None
    for s, e in intervals:
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, gaps


def _host_op(cpu, starts, t):
    """The innermost host op running at time ``t`` (the latest-starting
    one that covers it), or "host idle"."""
    i = bisect.bisect_right(starts, t)
    best = None
    for j in range(i - 1, max(-1, i - 2000), -1):
        s, e, name = cpu[j]
        if e >= t:
            best = name
            break
    return best or "host idle"


def summarize(events, wall: float, top: int = 10) -> dict:
    kernels = {}
    dev, cpu = [], []
    for e in events:
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            k = kernels.setdefault(e.name(), [0, 0.0])
            k[0] += 1
            k[1] += d / 1e3
            dev.append((s, s + d))
        elif d > 0:
            cpu.append((s, s + d, e.name()))
    dev.sort()
    cpu.sort()
    busy_ns, gaps = _union(dev)
    starts = [c[0] for c in cpu]
    by_host = {}
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:500]:
        name = _host_op(cpu, starts, (g0 + g1) // 2)
        by_host[name] = by_host.get(name, 0.0) + (g1 - g0) / 1e9
    ops = sorted(kernels.items(), key=lambda kv: -kv[1][1])
    return {
        "kernels": kernels,
        "busy_s": busy_ns / 1e9,
        "window_s": wall,
        "device_ops": [[n[:NAME_CHARS], v[1] / 1e6] for n, v in ops[:top]],
        "idle_gaps": sorted(([n, s] for n, s in by_host.items()),
                            key=lambda x: -x[1])[:top],
    }


def launches(kernels: dict, fragment: str, exclude: str | None = None):
    """(launches, device us) of the kernels whose name holds
    ``fragment`` (and not ``exclude``)."""
    n = us = 0
    for name, (count, t) in kernels.items():
        if fragment in name and (exclude is None or exclude not in name):
            n += count
            us += t
    return n, us
