"""Readings that a mesh fit cell's limits are set from, on the cards.

    python3 benchmark/calibrate_mesh.py --workload <cell> --seed0 <n>
        [--seeds 12] [--controls 3] [--out <file>]

``calibrate.py``'s readings for a cell of ``loops/fit_mesh.py``: one
process sets the mesh up once (rank 0 here, the other ranks its
processes, one a card) and takes each seed's three set-up steps again on
every rank through the same step objects (``fit_mesh.fresh``); once the
ranks have exited, the plain reference's whole-image steps follow each
seed's, as a run's check does (the lower readings).  On the first
``--controls`` seeds it reads the control, the reference computed in
bfloat16, the nearest precision below the configuration's float32, and a
planted fault, the last rank's block of pixels left out of the sums (a
quarter of the image on four ranks) (the upper readings).  The
benchmark's own runs do not run this; PERF.md gives its readings beside
each limit.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed0", type=int, required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)

    import torch
    from benchmark.harness import cells
    from benchmark.harness.window import Context
    from benchmark.loops import fit, fit_mesh

    man = cells.manifest()
    cell = cells.workload(man, a.workload)
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"the cell asks for {cell['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    cfg = cells.config(cell["config"])
    traffic = cells.traffic(cell["traffic"])
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    ctx = Context(cell=cell, cfg=cfg, traffic=traffic, seed=a.seed0,
                  seconds=0.0, trace=False, device=device,
                  cam=cells.camera_fields(cfg, traffic.get("camera")),
                  limits=cells.limits(cell["name"]))
    seeds = [a.seed0 + 7919 * i for i in range(a.seeds)]
    lr = float(traffic["lr"])
    t0 = time.perf_counter()
    st = fit_mesh.setup(ctx)
    runs = [fit_mesh.fresh(ctx, st, s) for s in seeds]
    fit_mesh.stop(ctx, st)
    del st
    torch.cuda.empty_cache()
    t_program = time.perf_counter() - t0
    n = int(cell["chips"])
    rows = []
    for i, (s, w) in enumerate(zip(seeds, runs)):
        ctx.seed = s
        t1 = time.perf_counter()
        ref = fit_mesh.reference_steps(ctx, w["seeds"])
        row = {"seed": s, "reference_s": time.perf_counter() - t1,
               "program": fit.gaps(fit.program_numbers(w, lr), ref),
               "control": {}, "block_dropped": {}}
        if i < a.controls:
            low = fit_mesh.reference_steps(ctx, w["seeds"], torch.bfloat16)
            row["control"] = fit.gaps(low, ref)
            dropped = fit_mesh.reference_steps(ctx, w["seeds"], blocks=n,
                                               drop=n - 1)
            row["block_dropped"] = fit.gaps(dropped, ref)
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"workload": a.workload, "program_s": t_program,
               "seconds": time.perf_counter() - t0,
               "card": torch.cuda.get_device_name(device), "rows": rows}
    for key in ("program", "control", "block_dropped"):
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
    print(json.dumps({k: summary[k] for k in (
        "workload", "program_s", "seconds", "card", "program", "control",
        "block_dropped")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
