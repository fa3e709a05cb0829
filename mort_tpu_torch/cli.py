"""Command-line interface.

The port of ``mort_tpu.cli``: renders a reference scene to PNG/NPZ
headlessly, or times repeated renders, with the per-scene camera knobs as
flags:

    python -m mort_tpu_torch.cli render 6 --width 200 --spp 64 --out cornell.png
    python -m mort_tpu_torch.cli bench 1 --frames 3

It runs on the card (``require_cuda``; no card is an error, never a silent
fall back to the CPU); ``--device cpu`` asks for the CPU, where the
closest hit takes its plain PyTorch version.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import torch


def _add_common(p):
    p.add_argument("scene", type=int, help="scene number 1-10 (mort.cu:649-689)")
    p.add_argument("--width", type=int, default=None, help="override image width")
    p.add_argument("--spp", type=int, default=None, help="override samples per pixel")
    p.add_argument("--depth", type=int, default=None, help="override bounce limit")
    p.add_argument("--seed", type=int, default=None, help="RNG seed (default 69420)")
    p.add_argument("--quick", action="store_true",
                   help="reduced primitive counts for scenes 1/8/9")
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA card; 'cpu' "
                        "runs the plain versions of the kernels)")


def _device(args) -> torch.device:
    from .device import require_cuda

    return require_cuda() if args.device is None else torch.device(
        args.device)


def _build(args):
    from .scene import scenes as sc

    if args.quick and args.scene in (1, 8, 9):
        if args.scene == 1:
            world, cam = sc.random_spheres(quick=True)
        else:
            wpix = 400 if args.scene == 9 else 800
            spp = 250 if args.scene == 9 else 1000
            depth = 4 if args.scene == 9 else 40
            world, cam = sc.final_scene(wpix, spp, depth, quick=True)
    else:
        world, cam = sc.build_scene(args.scene)

    cam = override_camera(cam, args.width, args.spp, args.depth)
    data, meta = world.compile()
    return data, meta, cam


def override_camera(cam, width=None, spp=None, depth=None):
    """``cam`` with the command line's overrides: the width (the height
    keeps the aspect), samples per pixel (floored to a square) and the
    bounce limit; None keeps the scene's."""
    overrides = {}
    if width is not None:
        overrides["image_width"] = width
        overrides["image_height"] = max(1, int(width * cam.image_height / cam.image_width))
    if spp is not None:
        overrides["sqrt_spp"] = max(1, int(math.sqrt(spp)))
    if depth is not None:
        overrides["bounce_limit"] = depth
    return cam.replace(**overrides) if overrides else cam


def _render(data, meta, cam, dev, seed):
    """One wavefront render on ``dev``, waited for; (image, stats, s)."""
    from .device import synchronize
    from .render.wavefront import render_wavefront

    t0 = time.perf_counter()
    img, stats = render_wavefront(data, meta, cam, dev, seed=seed,
                                  return_stats=True)
    synchronize(dev)
    return img, stats, time.perf_counter() - t0


def cmd_render(args):
    """Render, write the image, and return ``metrics.render_metrics`` of
    the render (with its average path length) and ``out``."""
    from .io.image import save_npz, save_png
    from .metrics import render_metrics
    from .rng import DEFAULT_SEED

    dev = _device(args)
    data, meta, cam = _build(args)
    seed = DEFAULT_SEED if args.seed is None else args.seed
    print(f"scene {args.scene}: {cam.image_width}x{cam.image_height} "
          f"@ {cam.sqrt_spp ** 2}spp depth {cam.bounce_limit} "
          f"({meta.n_spheres} spheres, {meta.n_quads} quads, "
          f"{len(meta.media)} media, {len(meta.lights)} lights)", file=sys.stderr)
    img, stats, dt = _render(data, meta, cam, dev, seed)
    n_paths = cam.image_width * cam.image_height * cam.sqrt_spp ** 2
    print(f"rendered in {dt:.2f}s ({n_paths / dt / 1e6:.2f} Mpaths/s, "
          f"incl. compile)", file=sys.stderr)
    out = args.out or f"scene{args.scene}.png"
    if out.endswith(".npz"):
        save_npz(out, img)
    else:
        save_png(out, img)
    print(out)
    m = render_metrics(cam, meta, dt,
                       avg_path_len=stats["useful_segments"] / n_paths)
    m["out"] = out
    return m


def cmd_bench(args):
    """Time ``--frames`` renders after a warm-up one (which builds the
    kernel); print and return one JSON record (the JAX package's keys)."""
    from .rng import DEFAULT_SEED

    dev = _device(args)
    data, meta, cam = _build(args)
    seed = DEFAULT_SEED if args.seed is None else args.seed
    _render(data, meta, cam, dev, seed)          # warm-up, kernel build
    times = [_render(data, meta, cam, dev, seed + i)[2]
             for i in range(args.frames)]
    dt = min(times)
    n_paths = cam.image_width * cam.image_height * cam.sqrt_spp ** 2
    rec = {
        "scene": args.scene,
        "width": cam.image_width, "height": cam.image_height,
        "spp": cam.sqrt_spp ** 2, "depth": cam.bounce_limit,
        "wall_s": dt, "paths_per_s": n_paths / dt,
    }
    print(json.dumps(rec))
    return rec


def main(argv=None):
    """Run one command; returns its record (``cmd_render``, ``cmd_bench``)."""
    ap = argparse.ArgumentParser(prog="mort-tpu-torch",
                                 description="differentiable path tracer "
                                             "(PyTorch + CUDA)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="render a scene to PNG/NPZ")
    _add_common(pr)
    pr.add_argument("--out", default=None, help="output path (.png or .npz)")

    pb = sub.add_parser("bench", help="time repeated renders of a scene")
    _add_common(pb)
    pb.add_argument("--frames", type=int, default=3)

    args = ap.parse_args(argv)
    try:
        if args.cmd == "render":
            return cmd_render(args)
        return cmd_bench(args)
    except ValueError as e:
        ap.error(str(e))


def script() -> int:
    """The ``mort-tpu-torch`` console script: ``main`` of the command line,
    exit code 0 (``main`` returns its record, which ``sys.exit`` would
    print as an error)."""
    main()
    return 0


if __name__ == "__main__":
    main()
