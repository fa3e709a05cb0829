"""Readings that the check's limits are set from, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seed0 <n>
        [--seeds 12] [--controls 3] [--units 0] [--out <file>]

For ``--seeds`` seeds (``seed0`` on), one process sets the program up
once and takes each seed's compared numbers as a run does: the program's
timed path at the cell's sizes against the plain reference (the lower
readings).  On the first ``--controls`` seeds it reads the control, the
reference put in the program's place and computed in bfloat16, the
nearest precision below the configuration's float32, and for the fit
cell a planted fault, half the pixels left out and the mean taken over
the rest (the upper readings).  ``--units`` sets the frames a seed checks
(0: the traffic's ``check_frames``).  The benchmark's own runs do not run
this; PERF.md gives its readings beside each limit.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def frames(ctx, loop, seeds, controls, units):
    import torch
    from benchmark.harness import check, window as win

    st = loop.setup(ctx)
    n = units or int(ctx.traffic["check_frames"])
    got = []
    for s in seeds:
        ctx.seed = s
        pix = loop.setup_pixels(ctx)
        fs = win.unit_seeds(s, "frames")[:n]
        px = []
        for f in fs:
            img = st["render"](st["data"], st["meta"], st["cam"], ctx.device,
                               seed=f)
            px.append(img.cpu().numpy().reshape(-1, 3)[pix].copy())
        got.append((s, pix, fs, px))
    del st
    torch.cuda.empty_cache()
    out = []
    for i, (s, pix, fs, px) in enumerate(got):
        ctx.seed = s
        row = {"seed": s, "program": {}, "control": {}}
        off, ctl = [], []
        for f, p in zip(fs, px):
            ref = loop.reference_pixels(ctx, f, pix)
            off.append(check.pixels_off(p, ref))
            if i < controls:
                low = loop.reference_pixels(ctx, f, pix, torch.bfloat16)
                ctl.append(check.pixels_off(low, ref))
        row["program"]["px_off"] = float(_cat(off).mean())
        if ctl:
            row["control"]["px_off"] = float(_cat(ctl).mean())
        out.append(row)
        print(json.dumps(row), flush=True)
    return out


def _cat(xs):
    import numpy as np
    return np.concatenate(xs)


def preview(ctx, loop, seeds, controls, units):
    import torch
    from benchmark.harness import check

    st = loop.setup(ctx)
    n = int(ctx.traffic["frames_per_move"]) + 5
    got = []
    for s in seeds:
        ctx.seed = s
        pix = loop.setup_pixels(ctx)
        log, times = [], []
        stream = loop.commands(ctx, "commands")
        frame = loop.run_view(ctx, st, loop.counted(stream, n, log, times))
        got.append((s, pix, log, frame.reshape(-1, 3)[pix].copy()))
    seed = st["seed"]
    del st
    torch.cuda.empty_cache()
    out = []
    for i, (s, pix, log, px) in enumerate(got):
        ctx.seed = s
        ref = loop.reference_frame(ctx, log, pix, seed)
        row = {"seed": s, "program": {
            "px_off": float(check.pixels_off(px, ref).mean())},
            "control": {}}
        if i < controls:
            low = loop.reference_frame(ctx, log, pix, seed, torch.bfloat16)
            row["control"]["px_off"] = float(
                check.pixels_off(low, ref).mean())
        out.append(row)
        print(json.dumps(row), flush=True)
    return out


def fit(ctx, loop, seeds, controls, units):
    import torch

    st = loop.setup(ctx)
    lr = float(ctx.traffic["lr"])
    out = []
    for i, s in enumerate(seeds):
        ctx.seed = s
        w = loop.fresh_steps(ctx, st)
        ref = loop.reference_steps(ctx, w["seeds"])
        row = {"seed": s,
               "program": loop.gaps(loop.program_numbers(w, lr), ref),
               "control": {}, "half_batch": {}}
        if i < controls:
            low = loop.reference_steps(ctx, w["seeds"], torch.bfloat16)
            row["control"] = loop.gaps(low, ref)
            half = loop.reference_steps(ctx, w["seeds"], pixel_share=0.5)
            row["half_batch"] = loop.gaps(half, ref)
        out.append(row)
        print(json.dumps(row), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed0", type=int, required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--units", type=int, default=0)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)

    import torch
    from benchmark.harness import cells
    from benchmark.harness.window import Context

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    man = cells.manifest()
    cell = cells.workload(man, a.workload)
    cfg = cells.config(cell["config"])
    traffic = cells.traffic(cell["traffic"])
    device = torch.device("cuda", 0)
    ctx = Context(cell=cell, cfg=cfg, traffic=traffic, seed=a.seed0,
                  seconds=0.0, trace=False, device=device,
                  cam=cells.camera_fields(cfg, traffic.get("camera")),
                  limits=cells.limits(cell["name"]))
    loop = cells.loop(traffic["loop"])
    seeds = [a.seed0 + 7919 * i for i in range(a.seeds)]
    t0 = time.perf_counter()
    rows = {"frames": frames, "preview": preview, "fit": fit}[
        traffic["loop"]](ctx, loop, seeds, a.controls, a.units)
    summary = {"workload": a.workload, "seconds": time.perf_counter() - t0,
               "card": torch.cuda.get_device_name(device), "rows": rows}
    for key in ("program", "control", "half_batch"):
        vals = {}
        for r in rows:
            for k, v in r.get(key, {}).items():
                vals.setdefault(k, []).append(v)
        summary[key] = {k: {"max": max(v), "min": min(v), "n": len(v)}
                        for k, v in vals.items()}
    text = json.dumps(summary)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(text + "\n")
    print(json.dumps({k: summary[k] for k in ("workload", "seconds", "card",
                                              "program", "control",
                                              "half_batch")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
