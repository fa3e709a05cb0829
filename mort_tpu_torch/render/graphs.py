"""Captured device programs: the port's counterpart of ``jax.jit``.

A wavefront round (``wavefront._span_core``), a lockstep sample's start
and bounce (``renderer.radiance_batches``) and a train step
(``make_train_step``) are each a ``KeptProgram``: kept
by graph key across calls, its units run once eagerly on a card, which
builds or loads the kernel library and does torch's lazy initialisation,
and are then captured into a ``torch.cuda.CUDAGraph`` and replayed.  A
replay reads and writes the addresses the capture saw, so what is captured
works on static tensors that it writes in place, and makes no host read
and no tensor from host data (``device.constant`` serves the constants).
Every graph starts and ends with a timing event, so each replay stamps its
own device time, which the caller reads once the replay is done.
"""

from __future__ import annotations

import contextlib
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


# one side stream a card to capture on: ``torch.cuda.graph``'s default
# capture stream is made once, on the card of a process's first capture,
# and entering it makes that card current, so a capture on another card
# would run its work outside the capture (seen on the card as
# cudaErrorStreamCaptureUnsupported)
_capture_streams = {}


def _capture_stream(dev: torch.device) -> torch.cuda.Stream:
    """The side stream that captures on card ``dev`` run on."""
    index = torch.device(dev).index
    if index is None:
        index = torch.cuda.current_device()
    stream = _capture_streams.get(index)
    if stream is None:
        stream = _capture_streams[index] = torch.cuda.Stream(index)
    return stream


def capture(fn, dev: torch.device, counts: dict):
    """Capture ``fn()`` into a CUDA graph (on ``dev``'s side stream,
    ``_capture_stream``, with its own memory pool), in the span
    "graphs.capture"; returns ``(graph, replay)``.  ``counts``' "captures"
    and "capture_s" count the capture, its "replays" each replay.  The
    capture runs nothing on the card, so the closest-hit launches it
    counted are taken back, and ``replay()`` adds them each time it
    replays.  The graph's first and last work record two timing events
    (event-record nodes of ``external`` events), which every replay stamps
    anew: ``replay()`` returns them, ``(start, end)``, for
    ``metrics.elapsed_ns`` once the replay is done.  A failure raises."""
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
                torch.cuda.graph(graph, stream=_capture_stream(dev)):
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


def _span(name):
    """The span ``name``, or none for None."""
    return metrics.span(name) if name else contextlib.nullcontext()


class KeptProgram:
    """One captured device program kept by graph key across calls: the
    counterpart of a jitted function's cache, with one entry.

    ``entered(key, operands, build, dev)`` is the context of one use of
    the program of ``key``, the caller's ``operands`` in its statics; it
    gives the program's state.  A new key resets the old program's graphs
    (one more ``counts["recaptures"]`` if there was one), clones
    ``operands`` into new statics (``cloned``) and builds the program over
    them: ``build(statics)`` returns ``(state, units)``, what the caller
    fills and reads around a run and its units by name, each a function of
    no argument that works on the statics and the state in place.  A kept
    key copies every tensor of ``operands`` into the statics
    (``tensors``' order), on every entry.  The key is the caller's: all
    that a capture fixes besides the operands' values.

    ``run(name)`` inside it: the unit's first run on its key is eager, on
    the statics, and gives ``(its result, None)``; the unit is captured
    right after it (``capture``).  Every later run is a replay and gives
    ``(None, its timing events)``.  Any failure inside the context (the
    entry, an eager run, a capture, a replay, or the caller's own reads
    and writes around them, where a replay's device fault surfaces) drops
    the key (``drop``) and raises.

    ``counts`` (the caller's dict) counts the captures, recaptures,
    replays and capture seconds.  The spans are the caller's names (None:
    no span): ``copy_in`` the copy into a kept key's statics, ``warm`` a
    unit's first run with its capture, ``eager`` that run alone and
    ``launch`` a replay."""

    def __init__(self, counts: dict, *, copy_in=None, warm=None, eager=None,
                 launch=None):
        self.counts = counts
        self._spans = {"copy_in": copy_in, "warm": warm, "eager": eager,
                       "launch": launch}
        self._graphs = {}
        self.drop()

    def drop(self) -> None:
        """Drop the kept program: its CUDA graphs (their hold on their
        memory pools), its statics and state; the next entry builds
        anew."""
        for graph, _ in self._graphs.values():
            graph.reset()
        self._graphs = {}
        self.key = self.state = self._statics = self._units = None

    @contextlib.contextmanager
    def entered(self, key, operands, build, dev: torch.device):
        """One use of the kept program of ``key``, ``operands`` in its
        statics; gives its state (the class docstring)."""
        try:
            with torch.no_grad():
                if key != self.key:
                    if self.key is not None:
                        self.counts["recaptures"] += 1
                    self.drop()
                    statics = cloned(operands)
                    self.state, self._units = build(statics)
                    self.key, self._statics, self._dev = key, statics, dev
                else:
                    with _span(self._spans["copy_in"]):
                        for dst, src in zip(tensors(self._statics),
                                            tensors(operands)):
                            dst.copy_(src)
            yield self.state
        except BaseException:
            self.drop()
            raise

    def run(self, name: str):
        """Run the unit ``name`` of the entered key: ``(result, None)``
        eagerly, then captured, on its first run; ``(None, (start,
        end))`` from a replay after."""
        captured = self._graphs.get(name)
        if captured is not None:
            with _span(self._spans["launch"]):
                return None, captured[1]()
        unit = self._units[name]
        with _span(self._spans["warm"]):
            with _span(self._spans["eager"]):
                result = unit()
            self._graphs[name] = capture(unit, self._dev, self.counts)
        return result, None
