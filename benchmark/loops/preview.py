"""The interactive viewer: ``interactive.view`` with one-sample layers.

A seeded command stream drives ``view(..., preview_spt=1)``: after every
``frames_per_move`` frames one camera event, a move away from the
starting view (W, A, S, D or a drag of ``drag_px`` pixels along one axis)
or the move back.  A frame renders one layer of one sample a pixel
through the wavefront's layer-aligned span, accumulates it and copies the
image to the host; a camera event restarts the accumulation.  A viewer frame
starts when the stream hands ``view`` a frame event and ends when ``view``
asks for its next event.  The window closes at the end of the first frame
that ends ``--seconds`` after the first began; ``view`` returns that
frame, which the check compares at ``check_pixels`` pixels with the
reference's mean over the layers accumulated since the last camera
event, with the camera worked out again from the commands.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from benchmark.harness import check, window as win
from benchmark.harness.profiling import profiled
from benchmark.reference import tracer, viewer

def moves(drag: int) -> list:
    """The eight camera events, each with the event that undoes it: the
    keys W, A, S, D and drags of ``drag`` pixels along each axis."""
    keys = [(("key", a), ("key", b)) for a, b in ("ws", "ad", "sw", "da")]
    drags = [(("mouse", x, y), ("mouse", -x, -y))
             for x, y in ((drag, 0), (-drag, 0), (0, drag), (0, -drag))]
    return keys + drags


def commands(ctx, tag):
    """An endless stream of ('frame',) events with one camera event after
    every ``frames_per_move`` frames.  The events are excursions from the
    starting view: each of the eight moves and then the move that undoes
    it, the eight in an order the seed shuffles anew for each round.  Every
    seed visits the same views for as many frames, in another order, so
    the seed orders the work without changing it."""
    r = win.rng(ctx.seed, tag)
    every = int(ctx.traffic["frames_per_move"])
    pairs = moves(int(ctx.traffic["drag_px"]))
    while True:
        for i in r.permutation(len(pairs)):
            for ev in pairs[i]:
                for _ in range(every):
                    yield ("frame",)
                yield ev


def setup(ctx):
    import mort_tpu_torch as mt
    from mort_tpu_torch.interactive import view

    data, meta = ctx.program_scene()
    data = data.to(ctx.device)
    cam = mt.camera_from_numpy(ctx.cam)
    log = open(os.devnull, "w")
    st = {"data": data, "meta": meta, "cam": cam, "view": view, "log": log,
          "seed": win.unit_seeds(ctx.seed, "view", 1)[0]}
    warm = [("frame",), ("key", "w"), ("frame",), ("frame",)]
    run_view(ctx, st, iter(warm))
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    st["pix"] = setup_pixels(ctx)
    return st


def setup_pixels(ctx):
    """The pixels the check compares, drawn from the seed."""
    wh = ctx.cam["image_width"] * ctx.cam["image_height"]
    return np.sort(win.rng(ctx.seed, "pixels").choice(
        wh, size=min(wh, int(ctx.traffic["check_pixels"])), replace=False))


def run_view(ctx, st, events):
    return st["view"](st["data"], st["meta"], st["cam"], events,
                      seed=st["seed"], preview_spt=1, device=ctx.device,
                      log=st["log"])


def _timed(stream, seconds, log, times):
    """Hand ``stream``'s events on, stamping each frame's start and end,
    until a frame ends ``seconds`` after the first frame began."""
    t0 = None
    for ev in stream:
        log.append(ev)
        if ev[0] != "frame":
            yield ev
            continue
        start = time.perf_counter()
        t0 = start if t0 is None else t0
        yield ev
        end = time.perf_counter()
        times.append((start, end))
        if end - t0 >= seconds:
            return


def counted(stream, frames, log, times):
    """``_timed`` by a count: hand on events until ``frames`` frames have
    ended."""
    for ev in stream:
        log.append(ev)
        if ev[0] != "frame":
            yield ev
            continue
        start = time.perf_counter()
        yield ev
        times.append((start, time.perf_counter()))
        if len(times) >= frames:
            return


def window(ctx, st):
    from mort_tpu_torch.render import wavefront as wf

    log, times = [], []
    rounds = wf.graph_count["rounds"]
    frame = run_view(ctx, st, _timed(commands(ctx, "commands"), ctx.seconds,
                                     log, times))
    n = len(times)
    ms = [(b - a) * 1e3 for a, b in times]
    return {"units": n, "wall": times[-1][1] - times[0][0], "ms": ms,
            "rounds": wf.graph_count["rounds"] - rounds, "commands": log,
            "px": frame.reshape(-1, 3)[st["pix"]].copy(), "pix": st["pix"],
            "seed": st["seed"],
            "metrics": {"preview_ms_p95": (win.percentile(ms, 95), "ms")}}


def traced(ctx, st, w):
    """The window's rounds a frame, and one profiled viewer call of
    ``trace_frames`` frames from a camera event on."""
    events = [("key", "a")] + [("frame",)] * int(ctx.traffic["trace_frames"])
    obs = profiled(lambda: run_view(ctx, st, iter(events)), ctx.device)
    obs.update(frames=w["units"], rounds=w["rounds"])
    return obs


def reference_frame(ctx, cmds, pix, seed, dtype=torch.float32):
    """The reference's pixels of the frame that ``view`` returns after
    ``cmds``: the mean over the one-sample layers since the last camera
    event (at most every sample of the camera)."""
    last = max([i for i, ev in enumerate(cmds) if ev[0] != "frame"] + [-1])
    fields = viewer.apply(ctx.cam, cmds)
    cam = tracer.make_cam(fields, ctx.device, dtype)
    spp = cam.sqrt_spp ** 2
    done = min(sum(ev[0] == "frame" for ev in cmds[last + 1:]), spp)
    s = tracer.make_scene(ctx.leaves, ctx.meta, ctx.device, dtype)
    return tracer.pixels(s, cam, seed, pix, range(done)) * np.float32(
        spp / done)


def compare(ctx, w):
    ref = reference_frame(ctx, w["commands"], w["pix"], w["seed"])
    share = float(check.pixels_off(w["px"], ref).mean())
    limit = float(ctx.limits["numbers"]["px_off"]["limit"])
    return {"px_off": share}, int(share > limit)
