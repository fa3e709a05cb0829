"""Back-to-back frames through ``render_wavefront``, a new seed a frame.

Set-up compiles the scene's description by the program, moves it to the card
and warms the graph key with one short span (``warm_tasks`` chunk-tasks),
which builds the kernel library on a cold checkout and captures the
span's program; every frame of the window replays it.  A frame ends when
its image is on the host, as the CLI's ``render`` has it before it writes
the file.  The check compares ``check_frames`` frames, drawn from the
seed, at ``check_pixels`` pixels drawn from the seed, with the reference's
mean of every sample of those pixels.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness import bounds, check, window as win
from benchmark.harness.cells import paths_per_unit
from benchmark.harness.profiling import profiled
from benchmark.reference import tracer


def setup(ctx):
    import mort_tpu_torch as mt
    from mort_tpu_torch.render.wavefront import render_wavefront

    data, meta = ctx.program_scene()
    data = data.to(ctx.device)
    cam = mt.camera_from_numpy(ctx.cam)
    render_wavefront(data, meta, cam, ctx.device,
                     seed=win.unit_seeds(ctx.seed, "warm", 1)[0],
                     task_range=(0, int(ctx.traffic["warm_tasks"])))
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    return {"data": data, "meta": meta, "cam": cam, "render":
            render_wavefront, "pix": setup_pixels(ctx)}


def setup_pixels(ctx):
    """The pixels the check compares, drawn from the seed."""
    wh = ctx.cam["image_width"] * ctx.cam["image_height"]
    return np.sort(win.rng(ctx.seed, "pixels").choice(
        wh, size=min(wh, int(ctx.traffic["check_pixels"])), replace=False))


def window(ctx, st):
    seeds = win.unit_seeds(ctx.seed, "frames")
    frames = []

    def frame(k):
        img, stats = st["render"](st["data"], st["meta"], st["cam"],
                                  ctx.device, seed=seeds[k],
                                  return_stats=True)
        host = img.cpu().numpy().reshape(-1, 3)
        frames.append({"seed": seeds[k], "px": host[st["pix"]].copy(),
                       "stats": stats})

    w = win.run_units(frame, ctx.seconds)
    n = w["units"]
    return {"units": n, "wall": w["wall"], "frames": frames, "pix": st["pix"],
            "metrics": {"paths_per_s": (n * paths_per_unit(ctx.cam)
                                        / w["wall"], "paths/s")}}


def traced(ctx, st, w):
    """The counters of the window's frames, and one profiled slice of the
    same graph key: the first ``trace_pools`` pools' worth of chunk-tasks
    of a frame."""
    from mort_tpu_torch.render import closest_hit as ch
    from mort_tpu_torch.render.wavefront import default_pool

    meta = st["meta"]
    rays = default_pool(meta, ctx.cam["image_width"]
                        * ctx.cam["image_height"])
    tasks = int(ctx.traffic["trace_pools"]) * rays
    before = dict(ch.launch_count)
    obs = profiled(lambda: st["render"](
        st["data"], meta, st["cam"], ctx.device,
        seed=win.unit_seeds(ctx.seed, "trace", 1)[0],
        task_range=(0, tasks)), ctx.device)
    fwd = sum(ch.launch_count[m] - before[m] for m in ch.ACCELS)
    stats = [f["stats"] for f in w["frames"]]
    obs.update(
        frames=len(stats),
        rounds=sum(s["iterations"] for s in stats),
        useful=sum(s["useful_segments"] for s in stats),
        slots=sum(s["slots_executed"] for s in stats),
        fwd_calls=fwd,
        fwd_bound_s=bounds.fwd_bound_s(fwd, rays, ctx.meta["n_spheres"],
                                       ctx.meta["n_quads"]))
    return obs


def reference_pixels(ctx, seed, pix, dtype=torch.float32):
    s = tracer.make_scene(ctx.leaves, ctx.meta, ctx.device, dtype)
    cam = tracer.make_cam(ctx.cam, ctx.device, dtype)
    return tracer.pixels(s, cam, seed, pix, range(cam.sqrt_spp ** 2))


def compare(ctx, w):
    """(numbers, failed units): the share of the checked frames' pixels
    that are off, and how many of those frames are over the limit."""
    frames = w["frames"]
    pick = win.rng(ctx.seed, "check").choice(
        len(frames), size=min(len(frames), int(ctx.traffic["check_frames"])),
        replace=False)
    limit = float(ctx.limits["numbers"]["px_off"]["limit"])
    off, failed = [], 0
    for k in sorted(pick):
        ref = reference_pixels(ctx, frames[k]["seed"], w["pix"])
        bad = check.pixels_off(frames[k]["px"], ref)
        off.append(bad)
        failed += int(bad.mean() > limit)
    return {"px_off": float(np.concatenate(off).mean())}, failed
