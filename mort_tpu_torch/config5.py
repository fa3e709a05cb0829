"""BASELINE config #5: the full-feature scene (final_scene) through the
wavefront forward at 1920x1080, then a train step (forward, backward and
the gradient all-reduce over a mesh) on the same scene.

The port's counterpart of ``tools/config5.py`` (BASELINE.json's north
star: "1920x1080 @ 1000spp, multi-host, gradient allreduce, checkpointed
accumulation"), in two modes:

    python -m mort_tpu_torch.config5 [--spp 16] [--out chiprun_out/config5.json]
        one device (the card; ``--device cpu`` asks for the CPU): the
        1920x1080 frame at ``--spp`` samples and final_scene's own depth 40
        (``render_wavefront(max_paths_per_call=80_000_000,
        return_stats=True)``) after one warm-up render (a whole frame, or
        ``--warmup-tasks`` chunk-tasks), then ``make_train_step(meta,
        make_mesh(1))`` on a 480x270 sub-raster at 4 spp, depth 8, against a
        zero target: one warm-up step and one timed step.  Writes
        ``CONFIG5.json``'s keys, plus the card line, to ``--out``.
    python -m mort_tpu_torch.config5 --mesh
        gloo ranks on the CPU: the layer-checkpointed forward (192x108,
        4 spp, depth 8, spt 2: two layers), interrupted after its first
        layer on 8 ranks and resumed on 2, must be bit-identical to the
        uninterrupted render on 8; then the train step on the 8-mesh
        (``run_mesh(n, m)`` takes other sizes).  The JAX tool's default
        spt gives this config one layer, so its resume renders nothing.

The reference's own final_scene gradients are NaN (ROADMAP C4), so only
the loss and the image must be finite; the count of non-finite gradient
entries is printed for information.
"""

from __future__ import annotations

import argparse
import datetime
import json
import math
import os
import sys
import tempfile
import time

import numpy as np
import torch

from .device import device_line, require_cuda, synchronize
from .parallel.launch import run_ranks
from .parallel.sharding import make_mesh, make_train_step
from .render.wavefront import render_wavefront
from .scene import scenes as sc

DEFAULT_OUT = os.path.join("chiprun_out", "config5.json")
SPAN_PATHS = 80_000_000
GRAD_W, GRAD_H, GRAD_SQRT_SPP, GRAD_DEPTH = 480, 270, 2, 8
MESH_W, MESH_H, MESH_SQRT_SPP, MESH_DEPTH, MESH_SPT = 192, 108, 2, 8, 2
MESH_SEED = 7
WORKER_TIMEOUT_S = 900


def non_finite(grads) -> int:
    """Entries of the gradients that are not finite."""
    return sum(int((~torch.isfinite(g)).sum()) for g in grads.values())


def run_device(device=None, width=1920, height=1080, spp=16, depth=None,
               warmup_tasks=None, grad_width=GRAD_W, grad_height=GRAD_H,
               quick=False, log=None) -> dict:
    """The one-device mode; returns ``CONFIG5.json``'s record plus
    ``card`` and ``grad_non_finite``.  ``quick``: final_scene's reduced
    primitive counts (a CPU smoke run)."""
    device = require_cuda() if device is None else torch.device(device)
    world, cam = sc.final_scene(quick=quick)
    data, meta = world.compile()
    cam = cam.replace(image_width=width, image_height=height,
                      sqrt_spp=max(1, int(math.sqrt(spp))),
                      **({} if depth is None else {"bounce_limit": depth}))
    spp = cam.sqrt_spp ** 2
    n_paths = width * height * spp
    kw = dict(max_paths_per_call=SPAN_PATHS)
    kw_warm = kw if warmup_tasks is None else dict(
        kw, task_range=(0, int(warmup_tasks)))

    t0 = time.perf_counter()
    render_wavefront(data, meta, cam, device, seed=7, **kw_warm)
    synchronize(device)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    img, st = render_wavefront(data, meta, cam, device, seed=8,
                               return_stats=True, **kw)
    synchronize(device)
    fwd_s = time.perf_counter() - t0

    cam_g = cam.replace(image_width=grad_width, image_height=grad_height,
                        sqrt_spp=GRAD_SQRT_SPP, bounce_limit=GRAD_DEPTH)
    mesh = make_mesh(1, devices=[device])
    step = make_train_step(meta, mesh)
    target = np.zeros((grad_height, grad_width, 3), np.float32)
    t0 = time.perf_counter()
    loss, grads = step(data, cam_g, target, seed=7)
    float(loss)
    synchronize(device)
    gcompile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loss, grads = step(data, cam_g, target, seed=8)
    loss = float(loss)
    synchronize(device)
    grad_s = time.perf_counter() - t0
    g_paths = grad_width * grad_height * GRAD_SQRT_SPP ** 2

    rec = {
        "config": "BASELINE #5 (final_scene, 1920x1080, wavefront fwd + "
                  "sharded grad step), spp scaled to fit bench budget",
        "width": width, "height": height, "spp": spp,
        "depth": cam.bounce_limit,
        "forward_wall_s": round(fwd_s, 2),
        "forward_compile_s": round(compile_s, 1),
        "forward_paths_per_s": round(n_paths / fwd_s, 1),
        "lane_occupancy": round(st["useful_segments"]
                                / max(st["slots_executed"], 1), 4),
        "grad_step_wall_s": round(grad_s, 3),
        "grad_step_compile_s": round(gcompile_s, 1),
        "grad_paths_per_s": round(g_paths / grad_s, 1),
        "grad_loss": loss,
        "image_finite": bool(torch.isfinite(img).all()),
        "card": device_line(device),
        "grad_non_finite": non_finite(grads),
    }
    if log is not None:
        log(f"config5: {rec['grad_non_finite']} non-finite gradient entries "
            f"of {sum(g.numel() for g in grads.values())} (the reference's "
            f"final_scene gradients are NaN too)")
    if not (math.isfinite(rec["grad_loss"]) and rec["image_finite"]):
        raise AssertionError(f"config5: loss {rec['grad_loss']} or the image "
                             f"is not finite")
    return rec


# ---------------------------------------------------------------------------
# --mesh: gloo ranks on the CPU
# ---------------------------------------------------------------------------

def _mesh_config():
    world, cam = sc.final_scene(quick=True)
    data, meta = world.compile()
    cam = cam.replace(image_width=MESH_W, image_height=MESH_H,
                      sqrt_spp=MESH_SQRT_SPP, bounce_limit=MESH_DEPTH)
    return data, meta, cam


def _mesh_worker(a) -> None:
    """One rank: ``--stage first`` renders layer 0 (the interrupted run),
    the whole render and the train step on a ``--world`` mesh; ``--stage
    resume`` renders the remaining layers from ``first``'s framebuffer."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{a.store}", rank=a.rank,
        world_size=a.world,
        timeout=datetime.timedelta(seconds=WORKER_TIMEOUT_S))
    try:
        mesh = make_mesh(a.world, devices=["cpu"] * a.world)
        data, meta, cam = _mesh_config()
        kw = dict(seed=MESH_SEED, mesh=mesh, spt=MESH_SPT)
        out = {}
        if a.stage == "first":
            out["part"] = render_wavefront(data, meta, cam, layer_range=(0, 1),
                                           scrub_nan=False, **kw).numpy()
            out["whole"] = render_wavefront(data, meta, cam, **kw).numpy()
            step = make_train_step(meta, mesh)
            target = np.zeros((cam.image_height, cam.image_width, 3),
                              np.float32)
            loss, grads = step(data, cam, target, seed=MESH_SEED)
            out["loss"] = loss.numpy()
            out["n_leaves"] = np.int64(len(grads))
            out["non_finite"] = np.int64(non_finite(grads))
            out["all_reduce"] = np.int64(step.collectives["all_reduce"])
        else:
            part = np.load(os.path.join(a.dir, "first_rank0.npz"))["part"]
            n_chunks = -(-cam.sqrt_spp ** 2 // MESH_SPT)
            out["img"] = render_wavefront(data, meta, cam, fb=part,
                                          layer_range=(1, n_chunks),
                                          **kw).numpy()
        np.savez(os.path.join(a.dir, f"{a.stage}_rank{a.rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def _stage(d, stage, world) -> float:
    store = os.path.join(d, f"store_{stage}_{world}")
    return run_ranks(
        [[sys.executable, "-m", "mort_tpu_torch.config5", "--mesh-worker",
          "--stage", stage, "--rank", r, "--world", world, "--store", store,
          "--dir", d] for r in range(world)],
        [os.path.join(d, f"{stage}_rank{r}.log") for r in range(world)],
        WORKER_TIMEOUT_S,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_mesh(n_first=8, n_resume=2, workdir=None) -> dict:
    """The interrupted forward on ``n_first`` gloo ranks, resumed on
    ``n_resume``, against the uninterrupted render, and the train step on
    the ``n_first`` mesh; raises when the resume is not bit-identical or
    the loss is not finite."""
    with tempfile.TemporaryDirectory(dir=workdir) as d:
        fwd_s = _stage(d, "first", n_first)
        fwd_s += _stage(d, "resume", n_resume)
        first = [dict(np.load(os.path.join(d, f"first_rank{r}.npz")))
                 for r in range(n_first)]
        resumed = [np.load(os.path.join(d, f"resume_rank{r}.npz"))["img"]
                   for r in range(n_resume)]
    whole = first[0]["whole"]
    ok = all(np.array_equal(img, whole) for img in resumed) and all(
        np.array_equal(f["whole"], whole) for f in first)
    loss = float(first[0]["loss"])
    rec = {"width": MESH_W, "height": MESH_H, "spp": MESH_SQRT_SPP ** 2,
           "depth": MESH_DEPTH, "spt": MESH_SPT, "ranks": [n_first, n_resume],
           "resume_bit_identical": bool(ok), "seconds": fwd_s,
           "loss": loss, "n_leaves": int(first[0]["n_leaves"]),
           "grad_non_finite": int(first[0]["non_finite"]),
           "all_reduce": int(first[0]["all_reduce"])}
    if not ok:
        raise AssertionError("config5 --mesh: the resumed render is not "
                             "bit-identical to the uninterrupted one")
    if not math.isfinite(loss):
        raise AssertionError(f"config5 --mesh: loss {loss}")
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m mort_tpu_torch.config5",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh", action="store_true",
                    help="gloo ranks on the CPU: elastic resume + train step")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--depth", type=int, default=None,
                    help="bounce limit (default: final_scene's 40)")
    ap.add_argument("--warmup-tasks", type=int, default=None,
                    help="warm up on this many chunk-tasks (default: a "
                         "whole frame)")
    ap.add_argument("--quick", action="store_true",
                    help="final_scene's reduced primitive counts")
    ap.add_argument("--grad-width", type=int, default=GRAD_W)
    ap.add_argument("--grad-height", type=int, default=GRAD_H)
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help=f"record path (default {DEFAULT_OUT})")
    ap.add_argument("--mesh-worker", action="store_true",
                    help=argparse.SUPPRESS)
    for flag in ("--stage", "--store", "--dir"):
        ap.add_argument(flag, help=argparse.SUPPRESS)
    for flag in ("--rank", "--world"):
        ap.add_argument(flag, type=int, help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.mesh_worker:
        _mesh_worker(a)
        return {}
    if a.mesh:
        rec = run_mesh()
        n, m = rec["ranks"]
        print(f"mesh mode ok: {rec['width']}x{rec['height']} sharded forward "
              f"interrupted on {n} ranks, resumed on {m} bit-identical, "
              f"and the train step on {n}, "
              f"{rec['seconds']:.1f} s (loss {rec['loss']:.4g}, "
              f"{rec['n_leaves']} grad leaves, {rec['grad_non_finite']} "
              f"non-finite entries)")
        print(json.dumps(rec))
        return rec
    rec = run_device(a.device, a.width, a.height, a.spp, a.depth,
                     a.warmup_tasks, a.grad_width, a.grad_height, a.quick,
                     log=lambda m: print(m, file=sys.stderr, flush=True))
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec, indent=1))
    print(f"wrote {os.path.abspath(a.out)}")
    return rec


if __name__ == "__main__":
    main()
