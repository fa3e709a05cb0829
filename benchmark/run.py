"""One run of one cell of the benchmark of ``mort_tpu_torch``.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

Loads the cell's configuration and traffic (``BENCHMARK.json`` names
them; ``benchmark/harness/cells.py`` finds their files), sets up the
program (its compile of the scene's description, its warm-up), runs the
window of whole units, reads the peak device memory, frees the program
and checks its output against the plain reference.  ``--trace
1`` adds one profiled slice and prints the per-layer metrics in place of
the end-to-end ones.  The last line of standard output is one JSON
object; the compared numbers and their limits are the last lines of
standard error.  Without as many CUDA cards as the cell asks for, or
with JAX or the JAX package loaded, it prints no result and exits with
another code than 0.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# build and kernel caches at fixed paths inside the checkout
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("USE_FLAX", "0")

FORBIDDEN = ("jax", "jaxlib", "flax", "mort_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def per_layer(man: dict, cell: str, reported: set, obs: dict) -> dict:
    """The per-layer metrics of ``cell`` that its readers find."""
    from benchmark.harness import cells

    out = {}
    for m in man["per_layer"]:
        mine = (cell in m["workloads"] if "workloads" in m
                else m["moves"] in reported)
        if not mine:
            continue
        v = cells.metric_reader(m["name"]).read(obs)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def main(argv=None, device=None, limits=None, camera=None) -> int:
    """One run; returns the exit code.  ``device``, ``limits`` and
    ``camera`` (overrides of the camera's fields) are for the harness's
    own tests, which drive a run on the CPU at a small size
    (``device="cpu"`` skips the look for a card)."""
    args = parse(argv)
    from benchmark.harness import cells, check
    from benchmark.harness.window import Context

    man = cells.manifest()
    cell = cells.workload(man, args.workload)
    cfg = cells.config(cell["config"])
    traffic = cells.traffic(cell["traffic"])

    import torch

    t_imports = time.perf_counter()
    if device is None:
        if not torch.cuda.is_available():
            print("no CUDA device: torch.cuda.is_available() is False",
                  file=sys.stderr)
            return 3
        if torch.cuda.device_count() < int(cell["chips"]):
            print(f"the cell asks for {cell['chips']} cards, "
                  f"{torch.cuda.device_count()} visible", file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    else:
        device = torch.device(device)
    gpu = device.type == "cuda"

    t_device = time.perf_counter()
    ctx = Context(cell=cell, cfg=cfg, traffic=traffic, seed=args.seed,
                  seconds=args.seconds, trace=bool(args.trace),
                  device=device,
                  cam=cells.camera_fields(cfg, {**traffic.get("camera", {}),
                                                **(camera or {})}),
                  limits=limits or cells.limits(cell["name"]))
    loop = cells.loop(traffic["loop"])
    if gpu:
        torch.cuda.reset_peak_memory_stats(device)
    st = loop.setup(ctx)
    setup_s = time.perf_counter() - T_START
    parts = {"imports": t_imports - T_START, "device": t_device - t_imports,
             "program": setup_s - (t_device - T_START)}
    parts.update(st.get("parts", {}))
    w = loop.window(ctx, st)
    peak = torch.cuda.max_memory_allocated(device) if gpu else 0
    obs = loop.traced(ctx, st, w) if args.trace else None
    del st
    gc.collect()
    if gpu:
        torch.cuda.empty_cache()

    numbers, failed = loop.compare(ctx, w)
    correct, lines = check.judge(ctx.limits, numbers)

    reported = set(w["metrics"]) | {"setup_s"}
    if args.trace:
        metrics = per_layer(man, cell["name"], reported, obs)
    else:
        metrics = {k: {"value": float(v), "unit": u}
                   for k, (v, u) in w["metrics"].items()}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    dev = {"platform": "gpu" if gpu else device.type,
           "kind": torch.cuda.get_device_name(device) if gpu else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(w["units"]),
              "failed": int(failed), "metrics": metrics, "device": dev}
    if args.trace:
        dev["busy_s"] = obs["busy_s"]
        dev["window_s"] = obs["window_s"]
        result["breakdown"] = {"device_ops": obs["device_ops"],
                               "idle_gaps": obs["idle_gaps"]}

    found = forbidden_modules()
    if found:
        print("loaded in the run's process: " + ", ".join(found),
              file=sys.stderr)
        return 4
    result["checks"] = {
        k: {"value": v, "limit": float(ctx.limits["numbers"][k]["limit"])}
        for k, v in numbers.items()}
    print("setup_s parts: " + ", ".join(f"{k} {v:.3f}"
                                        for k, v in parts.items()),
          file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


def bytecode_cache():
    """Keep the compiled bytecode of every module the run imports in a
    fixed directory of the checkout, so that only a checkout's first run
    compiles the sources: an environment that forbids writing bytecode
    (``PYTHONDONTWRITEBYTECODE``) otherwise has every process compile
    torch's two thousand modules again, seconds of set-up that swing with
    the host's load."""
    sys.pycache_prefix = str(ROOT / "build" / "pycache")
    sys.dont_write_bytecode = False


if __name__ == "__main__":
    bytecode_cache()
    sys.exit(main())
