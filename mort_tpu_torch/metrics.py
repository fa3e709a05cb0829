"""Structured metrics, timing, and profiling.

The port of ``mort_tpu.metrics``: per-render throughput metrics as JSON
lines (the JAX package's keys), a frame timer in the reference's printf
format (mort.cu:110-119), ``timed``, which waits for the card before it
reads the clock, and ``trace``, a ``torch.profiler`` capture (host and CUDA
activity) exported as a Chrome trace, in place of ``jax.profiler``.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time

import torch


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
