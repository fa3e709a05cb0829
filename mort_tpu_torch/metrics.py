"""Structured metrics, timing, spans and profiling.

The port of ``mort_tpu.metrics``: per-render throughput metrics as JSON
lines (the JAX package's keys), a frame timer in the reference's printf
format (mort.cu:110-119), ``timed``, which waits for the card before it
reads the clock, and ``trace``, a ``torch.profiler`` capture (host and CUDA
activity) exported as a Chrome trace, in place of ``jax.profiler``.

Spans and counters (``span``, ``count``) mark the program's layer
boundaries: the wavefront's round loop, the viewer and the train step.
They are always on and cost a few microseconds a span.  With no profiler
active a span adds its duration to in-memory totals keyed by its path from
the root span (``span_totals``) and a counter to its named total
(``counters``); while a ``torch.profiler`` is active a span is entered as
a profiler range instead (``_range``), so it shows on the profiler's
timeline, on the device trace's clock, and the profiled work stays out of
the totals.  Nothing is written out: a caller reads the totals.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import sys
import threading
import time
from typing import NamedTuple

import torch
import torch.autograd.profiler as _autograd_profiler


class FrameTimer:
    """Running average frame timer, printf-compatible with mort.cu:119."""

    def __init__(self, log=sys.stderr):
        self.total = 0.0
        self.frames = 0
        self.log = log

    @contextlib.contextmanager
    def frame(self):
        t0 = time.perf_counter()
        yield
        self.total += time.perf_counter() - t0
        self.frames += 1

    @property
    def avg_ms(self):
        return 1000.0 * self.total / max(1, self.frames)

    def print_avg(self):
        print(f"Avg. time per frame: {self.avg_ms:.1f} ms", file=self.log)


# ---------------------------------------------------------------------------
# Spans and counters
# ---------------------------------------------------------------------------

# the clock of every span, in ns (a test puts a stand-in here)
_clock = time.perf_counter_ns
_local = threading.local()
_lock = threading.Lock()
# span path -> [count, total ns, self ns]; counter name -> total
_totals = {}
_counters = {}
_roots = itertools.count(1)


class SpanTotal(NamedTuple):
    """The totals of one span path: how many spans ended there, their
    duration and their self time (the duration less the part that their
    child spans cover), in ns."""
    count: int
    ns: int
    self_ns: int


def profiling() -> bool:
    """Whether a ``torch.profiler`` (or the autograd profiler) is active."""
    return _autograd_profiler._is_profiler_enabled


def _range(name: str):
    """A host range of the profiler's, ``name`` on its timeline.  It is a
    record function of the scope that torch's operators have (kineto's
    "cpu_op"), not ``torch.profiler.record_function``'s user scope: the
    profiler mirrors a user-scope range onto the device's timeline as a
    device event spanning the range's device work, which a reader of the
    device events would count as a kernel and as busy time."""
    return torch._C._profiler._RecordFunctionFast(name)


def _stack() -> list:
    """This thread's open spans, innermost last."""
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class span:
    """A span of the program: ``with span("wavefront.read") as s: ...``.

    The span's parent is the innermost span open on this thread when it
    starts (each thread keeps its own stack), its ``path`` the names from
    the root down (``"viewer.frame/wavefront.call"``), and ``root`` the
    sequence number of its root span, which every span of one unit of
    work shares.  ``start`` and ``end`` are on ``_clock``
    (``time.perf_counter_ns``).  On its end a span adds its duration and
    self time to ``span_totals()[path]``, unless a profiler was active at
    its start: then it ran as a profiler range (``_range``) and adds
    nothing."""

    __slots__ = ("name", "parent", "path", "root", "start", "end",
                 "child_ns", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "span":
        stack = _stack()
        parent = self.parent = stack[-1] if stack else None
        if parent is None:
            self.path, self.root = self.name, next(_roots)
        else:
            self.path = parent.path + "/" + self.name
            self.root = parent.root
        self.child_ns = 0
        self.end = None
        self._range = None
        if profiling():
            self._range = _range(self.name)
            self._range.__enter__()
        stack.append(self)
        self.start = _clock()
        return self

    def __exit__(self, *exc) -> None:
        self.end = _clock()
        _stack().pop()
        ns = self.end - self.start
        if self.parent is not None:
            self.parent.child_ns += ns
        if self._range is not None:
            self._range.__exit__(*exc)
            return
        with _lock:
            rec = _totals.get(self.path)
            if rec is None:
                rec = _totals[self.path] = [0, 0, 0]
            rec[0] += 1
            rec[1] += ns
            rec[2] += ns - self.child_ns


def spanned(name: str):
    """Decorator: every call of the function is a span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n=1) -> None:
    """Add ``n`` to the counter ``name``, unless a profiler is active (a
    profiled slice stays out of the counters, as out of the spans)."""
    if profiling():
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def elapsed_ns(start: torch.cuda.Event, end: torch.cuda.Event) -> int:
    """Device time between two recorded, completed timing events, in ns."""
    return round(start.elapsed_time(end) * 1e6)


def span_totals() -> dict:
    """A copy of the span totals: path -> ``SpanTotal``."""
    with _lock:
        return {k: SpanTotal(*v) for k, v in _totals.items()}


def counters() -> dict:
    """A copy of the counters: name -> total."""
    with _lock:
        return dict(_counters)


def reset_spans() -> None:
    """Clear the span totals and the counters."""
    with _lock:
        _totals.clear()
        _counters.clear()


def total_of(totals: dict, name: str, under: str | None = None) -> SpanTotal:
    """The sum of ``totals``' entries for spans named ``name`` (the last
    part of the path), of those with an enclosing span named ``under``
    if given."""
    n = ns = self_ns = 0
    for path, t in totals.items():
        parts = path.split("/")
        if parts[-1] == name and (under is None or under in parts[:-1]):
            n += t.count
            ns += t.ns
            self_ns += t.self_ns
    return SpanTotal(n, ns, self_ns)


def render_metrics(cam, meta, wall_s, compile_s=None, avg_path_len=None):
    """One JSON-ready dict of render throughput metrics."""
    n_paths = cam.image_width * cam.image_height * cam.sqrt_spp ** 2
    m = {
        "width": cam.image_width,
        "height": cam.image_height,
        "spp": cam.sqrt_spp ** 2,
        "bounce_limit": cam.bounce_limit,
        "n_spheres": meta.n_spheres,
        "n_quads": meta.n_quads,
        "n_media": len(meta.media),
        "paths": n_paths,
        "wall_s": round(wall_s, 4),
        "paths_per_s": round(n_paths / wall_s, 1),
    }
    if compile_s is not None:
        m["compile_s"] = round(compile_s, 2)
    if avg_path_len is not None:
        m["avg_path_len"] = round(avg_path_len, 3)
        m["ray_segments_per_s"] = round(n_paths * avg_path_len / wall_s, 1)
    return m


def log_metrics(m, log=sys.stderr):
    print(json.dumps(m), file=log)


@contextlib.contextmanager
def trace(dir="mort_tpu_torch_trace"):
    """``torch.profiler`` capture of the block (host and, where a card is
    visible, CUDA activity), written to ``dir`` as a Chrome trace
    (``trace.json``, for chrome://tracing or Perfetto).  Yields the
    profiler; its ``key_averages()`` has the per-op table."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(dir, "trace.json"))


def timed(fn, *args, **kwargs):
    """Run fn, wait for the card (CUDA work is queued, not done, when a
    call returns), return (result, seconds)."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0
