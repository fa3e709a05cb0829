"""Benchmark entry: the reference workloads against the RTX 2080 anchor.

The port's counterpart of the repo's ``bench.py``, with its configs,
seeds and record keys.  The reference's only published number: scene 1
(random_spheres, 1200x675 at 100 spp, depth 20, ~490 spheres) renders in
~16 s on an RTX 2080 (the reference README), i.e. 5.0625 M camera paths/s;
``vs_baseline`` > 1 is faster than that card.

    python -m mort_tpu_torch.bench [--scene 1] [--frames 3]
    python -m mort_tpu_torch.bench --grad
    python -m mort_tpu_torch.bench --all [--out chiprun_out/bench_scenes.json]

The default mode benches one scene (and, for scene 1, the quick train step
beside it) and prints ONE JSON line last on stdout, ``bench.py``'s
``{"metric", "value", "unit": "paths/s/chip", "vs_baseline"}``.  The
first render is a warm-up span of ``task_range=(0, 4096)``; its seconds,
the kernel's nvcc build included on a cold cache, fill ``compile_s``.  On
a card it captures the span's CUDA graph, which the frames (the same
graph key) replay, so ``compile_s`` holds the capture, as ``bench.py``'s
warm-up holds the jit compile.
Then ``--frames`` frames are timed and the median kept; every timed window
ends with ``torch.cuda.synchronize`` on the render's device.  ``--all``
benches every reference scene at its code-true geometry and the train
step and writes the records to ``--out``.  ``--width/--spp/--depth``
override the camera (a CPU smoke run: ``--device cpu``).  Every record
carries the ``nvidia-smi`` name and power-limit line (``card``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from .cli import override_camera
from .device import device_line, require_cuda, synchronize
from .parallel.sharding import make_mesh, make_train_step
from .render.wavefront import render_wavefront
from .scene import scenes as sc

BASELINE_PATHS_PER_S = 1200 * 675 * 100 / 16.0   # RTX 2080 anchor

# camera paths a span (one ``_span_core`` call) may hold, by scene
SPAN_PATHS = {1: 200_000_000, 6: 80_000_000, 7: 80_000_000, 8: 80_000_000}
DEFAULT_OUT = os.path.join("chiprun_out", "bench_scenes.json")
WARMUP_TASKS = 4096
SEED = 69420


def bench_scene(idx, frames, quick=False, span_paths=None, device=None,
                width=None, spp=None, depth=None, log=None) -> dict:
    """``bench.py``'s ``_bench_scene`` on ``device`` (None: the card)."""
    device = require_cuda() if device is None else torch.device(device)
    if idx == 1:
        world, cam = sc.random_spheres(quick=quick)
    else:
        world, cam = sc.build_scene(idx)
    data, meta = world.compile()
    if quick:
        cam = cam.replace(image_width=300, image_height=168, sqrt_spp=3,
                          bounce_limit=8)
    cam = override_camera(cam, width, spp, depth)
    spp = cam.sqrt_spp ** 2
    n_paths = cam.image_width * cam.image_height * spp
    if span_paths is None:
        span_paths = SPAN_PATHS.get(idx, 40_000_000)
    say = log or (lambda m: None)
    say(f"bench scene {idx}: {cam.image_width}x{cam.image_height} @ {spp}spp "
        f"depth {cam.bounce_limit}, {meta.n_spheres} spheres {meta.n_quads} "
        f"quads ({n_paths / 1e6:.1f}M paths/frame)")
    kw = dict(max_paths_per_call=span_paths)

    # the warm-up span builds the kernel (nvcc on a cold cache)
    t0 = time.perf_counter()
    render_wavefront(data, meta, cam, device, seed=SEED,
                     task_range=(0, WARMUP_TASKS), **kw)
    synchronize(device)
    compile_s = time.perf_counter() - t0
    say(f"  build+warm-up span: {compile_s:.1f}s")

    times, stats = [], None
    for i in range(frames):
        t0 = time.perf_counter()
        img, stats = render_wavefront(data, meta, cam, device,
                                      seed=SEED + i, return_stats=True,
                                      **kw)
        synchronize(device)
        times.append(time.perf_counter() - t0)
        say(f"  frame {i}: {times[-1]:.3f}s")
    wall = sorted(times)[len(times) // 2]   # median

    rec = {
        "scene": idx,
        "width": cam.image_width, "height": cam.image_height,
        "spp": spp, "depth": cam.bounce_limit,
        "wall_s": round(wall, 3),
        "compile_s": round(compile_s, 1),
        "frames": frames,
        "paths_per_s": round(n_paths / wall, 1),
        "vs_baseline": round(n_paths / wall / BASELINE_PATHS_PER_S, 4),
    }
    if stats:
        segs = stats["useful_segments"]
        rec["ray_segments_per_s"] = round(segs / wall, 1)
        rec["avg_path_len"] = round(segs / n_paths, 3)
        rec["lane_occupancy"] = round(segs / max(stats["slots_executed"], 1),
                                      4)
    rec["card"] = device_line(device)
    say(f"  -> {rec['paths_per_s'] / 1e6:.2f}M paths/s, "
        f"{rec.get('ray_segments_per_s', 0) / 1e6:.1f}M segs/s, "
        f"occupancy {rec.get('lane_occupancy', 0):.3f} | {rec['card']}")
    return rec


def bench_grad_step(quick=False, device=None, width=None, spp=None,
                    depth=None, log=None) -> dict:
    """``bench.py``'s ``_bench_grad_step``: one train step (forward,
    backward and the gradient all-reduce over a 1-device mesh) on scene 1
    at 600x338 (quick: 160x90), 4 spp, depth 8, as camera paths/s.
    ``compile_s`` is the first call: on a card the eager warm-up step and
    the capture of the step's CUDA graph, which the timed steps replay."""
    device = require_cuda() if device is None else torch.device(device)
    world, cam = sc.random_spheres(quick=quick)
    data, meta = world.compile()
    cam = cam.replace(image_width=160 if quick else 600,
                      image_height=90 if quick else 338, sqrt_spp=2,
                      bounce_limit=8)
    cam = override_camera(cam, width, spp, depth)
    spp = cam.sqrt_spp ** 2
    n_paths = cam.image_width * cam.image_height * spp
    step = make_train_step(meta, make_mesh(1, devices=[device]))
    target = np.zeros((cam.image_height, cam.image_width, 3), np.float32)

    t0 = time.perf_counter()
    loss, grads = step(data, cam, target, seed=SEED)
    float(loss)
    synchronize(device)
    compile_s = time.perf_counter() - t0
    times = []
    # seeds differ from the warm-up's, and the loss is read inside the
    # timed window
    for i in range(3):
        t0 = time.perf_counter()
        loss, grads = step(data, cam, target, seed=SEED + 1 + i)
        float(loss)
        synchronize(device)
        times.append(time.perf_counter() - t0)
    wall = sorted(times)[len(times) // 2]
    rec = {
        "scene": 1, "mode": "grad_step",
        "width": cam.image_width, "height": cam.image_height,
        "spp": spp, "depth": cam.bounce_limit,
        "wall_s": round(wall, 3), "compile_s": round(compile_s, 1),
        "grad_paths_per_s": round(n_paths / wall, 1),
        "loss": float(loss),
        "card": device_line(device),
    }
    if log is not None:
        log(f"  grad step: {wall:.3f}s -> {rec['grad_paths_per_s'] / 1e6:.3f}"
            f"M paths/s (fwd+bwd+all-reduce) | {rec['card']}")
    return rec


def summary_line(rec) -> dict:
    """The one-line summary record of a scene or a grad-step record."""
    if rec.get("mode") == "grad_step":
        return {"metric": "scene1_grad_paths_per_s",
                "value": rec["grad_paths_per_s"], "unit": "paths/s/chip",
                "vs_baseline": round(rec["grad_paths_per_s"]
                                     / BASELINE_PATHS_PER_S, 4)}
    return {"metric": f"scene{rec['scene']}_paths_per_s",
            "value": rec["paths_per_s"], "unit": "paths/s/chip",
            "vs_baseline": rec["vs_baseline"]}


def main(argv=None) -> list:
    """Run the bench; returns its records (the summary line's last)."""
    ap = argparse.ArgumentParser(prog="python -m mort_tpu_torch.bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="reduced geometry/spp for a fast smoke run")
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--scene", type=int, default=1)
    ap.add_argument("--all", action="store_true",
                    help="bench every reference scene (1-10) + the train "
                         "step; write the records to --out")
    ap.add_argument("--grad", action="store_true",
                    help="bench only the train step")
    ap.add_argument("--span-paths", type=int, default=None,
                    help="max camera paths per span")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--depth", type=int, default=None)
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help=f"--all's records (default {DEFAULT_OUT})")
    a = ap.parse_args(argv)
    device = require_cuda() if a.device is None else torch.device(a.device)
    cam_kw = dict(width=a.width, spp=a.spp, depth=a.depth)

    def say(m):
        print(m, file=sys.stderr, flush=True)

    if a.grad:
        recs = [bench_grad_step(a.quick, device, log=say, **cam_kw)]
    elif a.all:
        # every reference scene at code-true geometry
        recs = [bench_scene(idx, frames, a.quick, a.span_paths, device,
                            log=say, **cam_kw)
                for idx, frames in ((1, a.frames), (2, 2), (3, 2), (4, 2),
                                    (5, 2), (6, 2), (7, 2), (8, 2), (9, 2),
                                    (10, 2))]
        recs.append(bench_grad_step(a.quick, device, log=say, **cam_kw))
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(recs, f, indent=1)
        say(f"wrote {os.path.abspath(a.out)}")
        recs = recs[:1]
    else:
        recs = [bench_scene(a.scene, a.frames, a.quick, a.span_paths, device,
                            log=say, **cam_kw)]
        if a.scene == 1:
            # the train step rides along in the default run (quick)
            g = bench_grad_step(True, device, log=say, **cam_kw)
            say(f"  grad step (quick): {g['grad_paths_per_s'] / 1e6:.3f}M "
                f"paths/s (fwd+bwd+all-reduce, first step "
                f"{g['compile_s']}s)")
            recs.insert(0, g)
    print(json.dumps(summary_line(recs[-1])))
    return recs


if __name__ == "__main__":
    main()
