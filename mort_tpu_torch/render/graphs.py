"""Captured device programs: the port's counterpart of ``jax.jit``.

A wavefront round (``wavefront._span_core``), a train step
(``parallel.sharding.make_train_step``) and a lockstep sample's start and
bounce (``renderer.radiance_batches``) each run once eagerly on a card,
which builds or loads the kernel library and does torch's lazy
initialisation, and are then captured once into a ``torch.cuda.CUDAGraph``
and replayed, each kept by its graph key across calls.  A replay reads
and writes the addresses the capture saw, so what is captured works on
static tensors that it writes in place, and makes no host read and no
tensor from host data (``device.constant`` serves the constants).  Every
graph starts and ends with a timing event, so each replay stamps its own
device time, which the caller reads once the replay is done.
"""

from __future__ import annotations

import dataclasses
import gc
import time

import torch

from .. import metrics
from . import closest_hit as ch


def graph_route(dev: torch.device, eager: bool) -> bool:
    """Whether work on ``dev`` is replayed from a CUDA graph: on a card,
    unless ``eager`` (private to the tests and chip_smoke.py, which compare
    the two routes).  The CPU always runs eagerly."""
    return dev.type == "cuda" and not eager


def capture(fn, dev: torch.device, counts: dict):
    """Capture ``fn()`` into a CUDA graph (on ``torch.cuda.graph``'s side
    stream, with its own memory pool), in the span "graphs.capture";
    returns ``(graph, replay)``.  ``counts``' "captures" and "capture_s"
    count the capture, its "replays" each replay.  The capture runs
    nothing on the card, so the closest-hit launches it counted are taken
    back, and ``replay()`` adds them each time it replays.  The graph's
    first and last work record two timing events (event-record nodes of
    ``external`` events), which every replay stamps anew: ``replay()``
    returns them, ``(start, end)``, for ``metrics.elapsed_ns`` once the
    replay is done.  A failure raises."""
    before = dict(ch.launch_count)
    graph = torch.cuda.CUDAGraph()
    stamps = tuple(torch.cuda.Event(enable_timing=True, external=True)
                   for _ in range(2))
    t0 = time.perf_counter()
    # no cyclic collection while capturing (torch.cuda.graph collects just
    # before): a collected graph, an earlier step's, would destroy its
    # executable, which invalidates the capture
    collecting = gc.isenabled()
    gc.disable()
    try:
        with metrics.span("graphs.capture"), torch.cuda.device(dev), \
                torch.cuda.graph(graph):
            stamps[0].record()
            fn()
            stamps[1].record()
    finally:
        if collecting:
            gc.enable()
    counts["capture_s"] += time.perf_counter() - t0
    counts["captures"] += 1
    held = {k: ch.launch_count[k] - n for k, n in before.items()}
    ch.launch_count.update(before)

    def replay():
        graph.replay()
        for k, n in held.items():
            ch.launch_count[k] += n
        counts["replays"] += 1
        return stamps

    return graph, replay


def tensors(obj) -> list:
    """Every tensor of ``obj`` in order: ``obj`` a tensor, a dataclass (its
    fields in order) or a tuple, nested; any other value holds none."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if dataclasses.is_dataclass(obj):
        return [t for f in dataclasses.fields(obj)
                for t in tensors(getattr(obj, f.name))]
    if isinstance(obj, tuple):
        return [t for x in obj for t in tensors(x)]
    return []


def cloned(obj):
    """``obj`` (as in ``tensors``) with every tensor cloned, detached: a
    static copy that a captured graph can read while the caller's tensors
    change or go."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().clone()
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: cloned(getattr(obj, f.name))
            for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple):
        items = [cloned(x) for x in obj]
        return type(obj)(*items) if hasattr(obj, "_fields") else tuple(items)
    return obj


def layout(obj):
    """What a graph captured over ``obj`` (as in ``tensors``) fixes besides
    its tensors' values: each tensor's shape and dtype, every other
    value."""
    if isinstance(obj, torch.Tensor):
        return tuple(obj.shape), obj.dtype
    if dataclasses.is_dataclass(obj):
        return tuple(layout(getattr(obj, f.name))
                     for f in dataclasses.fields(obj))
    if isinstance(obj, tuple):
        return tuple(layout(x) for x in obj)
    return obj
