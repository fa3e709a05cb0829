"""A closed loop of train steps over a mesh of ranks, one process a device.

The step is ``make_train_step(meta, make_mesh(n))`` on a process group of n
ranks (NCCL over n cards; gloo over CPU processes): each rank renders its
contiguous block of the pixels, and the loss and the ten gradients are
summed over the ranks in one flat all-reduce a step.  Per rank the step,
its update and what is checked are ``loops/fit.py``'s.

Rank 0 runs in the run's own process on the first device.  ``setup``
starts ranks 1 .. n-1 as processes of this module (``python -m
benchmark.loops.fit_mesh --rank r --spec <json>``) on a TCP store on
localhost, and every rank runs the three set-up steps.  Before each later
step rank 0 sends one command, an int64 pair on a side gloo group, so
nothing extra enters a card's timeline: a window step, a traced step, the
set-up steps again from another run seed (``fresh``, for a calibration),
or stop, on which each worker sends rank 0 its counters (taken before any
traced step) and exits.  A window step's command goes out one step ahead
and rank 0 does not wait for it (``_post``): a worker finds it there when
its step before ends, so the side group's round trip lies on no rank's
path from one step to the next, and the ranks meet only in the step's
all-reduce.  The one step so sent past the window's end runs after it,
uncounted.  Rank 0 checks its workers before each command, and the
process group's timeout (the traffic's ``timeout_s``) bounds a collective
that a dead rank never joins.  The workers have exited and the group is
gone when the window ends (or the traced steps, with ``--trace 1``).

The window's rate is every rank's paths over rank 0's window wall.  The
check follows rank 0's three set-up steps with the plain reference's
whole-image steps (``fit.reference_steps``, on rank 0's card) once the
workers are gone.  ``reference_steps`` splits the reference's pixels into
the ranks' blocks, for a calibration's planted fault: one block left out.
"""

from __future__ import annotations

import argparse
import datetime
import faulthandler
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import check, window as win  # noqa: E402
from benchmark.harness.cells import paths_per_unit  # noqa: E402
from benchmark.harness.profiling import profiled  # noqa: E402
from benchmark.loops import fit  # noqa: E402
from benchmark.reference import tracer  # noqa: E402

LOG_DIR = ROOT / "build" / "fit_mesh"
# the commands rank 0 sends before a step
STOP, STEP, TRACE, FRESH = 0, 1, 2, 3


def layout(ctx, n: int):
    """(backend, one device a rank): NCCL over the first n cards, gloo
    over CPU processes."""
    if ctx.device.type == "cuda":
        return "nccl", [f"cuda:{r}" for r in range(n)]
    return "gloo", ["cpu"] * n


def worker_command(rank: int, spec: dict) -> list:
    """The argv of worker ``rank``."""
    return [sys.executable, "-m", "benchmark.loops.fit_mesh", "--rank",
            str(rank), "--spec", json.dumps(spec)]


def _threads(ctx) -> int:
    """Each rank's intra-op threads: one on cards, as torchrun gives each
    process of a multi-process launch (OMP_NUM_THREADS=1), so that four
    ranks' pools do not contend for the host's cores around each step's
    small host ops; over CPU ranks, whose steps are CPU work, the run's
    own count."""
    return 1 if ctx.device.type == "cuda" else torch.get_num_threads()


def _timeout(ctx) -> datetime.timedelta:
    return datetime.timedelta(seconds=float(ctx.traffic["timeout_s"]))


def _rank_state(ctx, devices: list) -> dict:
    """This rank's step over the mesh of ``devices`` and the three set-up
    steps, as ``fit.setup`` runs them on one device."""
    import mort_tpu_torch as mt
    from mort_tpu_torch.parallel.sharding import make_mesh, make_train_step

    mesh = make_mesh(len(devices), devices=devices)
    data, meta = ctx.program_scene()
    data = data.to(ctx.device)
    st = {"step": make_train_step(meta, mesh, use_kernel=True),
          "data": data, "cam": mt.camera_from_numpy(ctx.cam),
          "target": torch.from_numpy(fit.target_image(ctx)).to(ctx.device),
          "meta": meta, "losses": [],
          "seeds": win.unit_seeds(ctx.seed, "steps"),
          "lr": float(ctx.traffic["lr"]), "theta": [fit._host(data)]}
    t0 = time.perf_counter()
    for k in range(fit.SETUP_STEPS):
        fit.unit(st, k)
        if k == 0:
            st["parts"] = {"first_step": time.perf_counter() - t0}
        if k in (0, fit.SETUP_STEPS - 1):
            st["theta"].append(fit._host(st["data"]))
    st["parts"]["next_steps"] = time.perf_counter() - t0 - \
        st["parts"]["first_step"]
    if ctx.trace:
        # the traced steps' scene, made before the window so that no rank
        # compiles it while the others wait in a collective
        data0, _ = ctx.program_scene()
        st["data0"] = data0.to(ctx.device)
    return st


def _trace_state(ctx, st) -> dict:
    return {"step": st["step"], "cam": st["cam"], "target": st["target"],
            "losses": [], "lr": st["lr"],
            "seeds": win.unit_seeds(ctx.seed, "trace",
                                    int(ctx.traffic["trace_steps"]))}


# ---------------------------------------------------------------------------
# rank 0
# ---------------------------------------------------------------------------

def setup(ctx):
    n = int(ctx.cell["chips"])
    backend, devices = layout(ctx, n)
    store = dist.TCPStore("127.0.0.1", 0, n, is_master=True,
                          timeout=_timeout(ctx), wait_for_workers=False)
    spec = {"world": n, "port": store.port, "backend": backend,
            "devices": devices, "cell": ctx.cell, "cfg": ctx.cfg,
            "traffic": ctx.traffic, "cam": ctx.cam, "seed": ctx.seed,
            "trace": ctx.trace, "threads": _threads(ctx)}
    logs = LOG_DIR / str(os.getpid())
    logs.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPYCACHEPREFIX=str(ROOT / "build" /
                                                     "pycache"))
    env.pop("PYTHONDONTWRITEBYTECODE", None)
    mesh = {"procs": [], "logs": [], "side": None, "store": store,
            "posted": [], "threads": torch.get_num_threads()}
    torch.set_num_threads(spec["threads"])
    try:
        for r in range(1, n):
            log = logs / f"rank{r}.log"
            with open(log, "w") as f:
                mesh["procs"].append(subprocess.Popen(
                    worker_command(r, spec), cwd=ROOT, env=env, stdout=f,
                    stderr=subprocess.STDOUT))
            mesh["logs"].append(log)
        dist.init_process_group(backend, store=store, rank=0, world_size=n,
                                timeout=_timeout(ctx))
        mesh["side"] = dist.new_group(backend="gloo", timeout=_timeout(ctx))
        st = _rank_state(ctx, devices)
    except BaseException:
        _abort(mesh)
        raise
    st["mesh"] = mesh
    return st


def _tail(path, n=3000) -> str:
    try:
        return Path(path).read_text(errors="replace")[-n:]
    except OSError:
        return ""


def _check_workers(mesh):
    for r, (p, log) in enumerate(zip(mesh["procs"], mesh["logs"]), 1):
        if p.poll() is not None:
            raise RuntimeError(f"rank {r} exited {p.returncode}:\n"
                               f"{_tail(log)}")


def _send(mesh, op: int, arg: int = 0):
    """One command to every worker, once each is seen alive."""
    _flush(mesh)
    _check_workers(mesh)
    dist.broadcast(torch.tensor([op, arg], dtype=torch.int64), src=0,
                   group=mesh["side"])


def _post(mesh, op: int):
    """One command to every worker, once each is seen alive, without
    waiting for it to arrive; the commands posted before the last two are
    waited for (long arrived, since a worker takes one a step)."""
    _check_workers(mesh)
    cmd = torch.tensor([op, 0], dtype=torch.int64)
    mesh["posted"].append((cmd, dist.broadcast(cmd, src=0,
                                               group=mesh["side"],
                                               async_op=True)))
    while len(mesh["posted"]) > 2:
        mesh["posted"].pop(0)[1].wait()


def _flush(mesh):
    """Wait for every posted command."""
    while mesh["posted"]:
        mesh["posted"].pop(0)[1].wait()


def _stop(ctx, mesh) -> list:
    """Stop the workers; returns every rank's counters (rank 0's first),
    once the process group is destroyed and each worker has exited."""
    from mort_tpu_torch import metrics

    _send(mesh, STOP)
    got = [None] * (len(mesh["procs"]) + 1)
    dist.gather_object(metrics.counters(), got, dst=0, group=mesh["side"])
    # every rank tears its group down at once: NCCL's teardown waits for
    # the other ranks'
    dist.destroy_process_group()
    t_end = time.perf_counter() + float(ctx.traffic["timeout_s"])
    for r, (p, log) in enumerate(zip(mesh["procs"], mesh["logs"]), 1):
        try:
            p.wait(timeout=max(t_end - time.perf_counter(), 0.0))
        except subprocess.TimeoutExpired:
            # its threads' stacks into its log (``worker``'s faulthandler)
            p.send_signal(signal.SIGUSR1)
            time.sleep(2)
            raise RuntimeError(f"rank {r} still running after stop:\n"
                               f"{_tail(log)}") from None
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} exited {p.returncode}:\n"
                               f"{_tail(log)}")
    mesh["procs"] = []
    torch.set_num_threads(mesh["threads"])
    return got


def _abort(mesh):
    """Kill every worker still running and drop the process group."""
    for p in mesh["procs"]:
        if p.poll() is None:
            p.kill()
            p.wait(timeout=60)
    mesh["procs"] = []
    mesh["posted"] = []
    torch.set_num_threads(mesh["threads"])
    if dist.is_initialized():
        dist.destroy_process_group()


def _guarded(st, fn):
    """``fn()``; on any failure the workers are killed and the group
    dropped before the failure goes on."""
    try:
        return fn()
    except BaseException:
        _abort(st["mesh"])
        raise


def window(ctx, st):
    mesh = st["mesh"]

    def unit(k):
        # the command of the step after this one
        _post(mesh, STEP)
        fit.unit(st, fit.SETUP_STEPS + k)

    def run():
        _post(mesh, STEP)
        w = win.run_units(unit, ctx.seconds)
        # the step whose command went out in the window's last unit
        fit.unit(st, fit.SETUP_STEPS + w["units"])
        _flush(mesh)
        if not ctx.trace:
            _stop(ctx, mesh)
        return w

    w = _guarded(st, run)
    n = w["units"]
    return {"units": n, "wall": w["wall"],
            "setup_losses": st["losses"][:fit.SETUP_STEPS],
            "theta": st["theta"], "seeds": st["seeds"][:fit.SETUP_STEPS],
            "metrics": {"grad_paths_per_s": (
                n * paths_per_unit(ctx.cam) / w["wall"], "paths/s")}}


def traced(ctx, st, w):
    """``trace_steps`` steps on every rank, rank 0's profiled, each from
    the scene as set-up received it in a new ``SceneData``; then every
    rank's counters (``rank_counters``, rank 0's first)."""
    sub = _trace_state(ctx, st)

    def steps():
        for k in range(len(sub["seeds"])):
            _send(st["mesh"], TRACE)
            sub["data"] = st["data0"].replace()
            fit.unit(sub, k)

    def run():
        obs = profiled(steps, ctx.device)
        obs.update(steps=len(sub["seeds"]),
                   rank_counters=_stop(ctx, st["mesh"]))
        return obs

    return _guarded(st, run)


def fresh(ctx, st, seed: int) -> dict:
    """The three set-up steps again on every rank from the inputs of run
    seed ``seed`` (``fit.fresh_steps``): what a calibration compares."""
    def run():
        _send(st["mesh"], FRESH, seed)
        ctx.seed = seed
        return fit.fresh_steps(ctx, st)
    return _guarded(st, run)


def stop(ctx, st) -> list:
    """Stop the workers outside a window (a calibration's end)."""
    return _guarded(st, lambda: _stop(ctx, st["mesh"]))


# ---------------------------------------------------------------------------
# the check
# ---------------------------------------------------------------------------

def reference_steps(ctx, seeds, dtype=torch.float32, blocks=1, drop=None):
    """``fit.reference_steps`` (losses, first gradient, change after the
    steps) with the image's pixels split into ``blocks`` contiguous blocks,
    as the ranks split them, traced one after another; a step's loss and
    gradients are the blocks' sums.  ``drop``: a block left out of the sums
    (a planted fault: one rank's pixels missing).  One block and no
    ``drop`` is ``fit.reference_steps`` itself."""
    if blocks == 1 and drop is None:
        return fit.reference_steps(ctx, seeds, dtype)
    dev = ctx.device
    cam = tracer.make_cam(ctx.cam, dev, dtype)
    spp = cam.sqrt_spp ** 2
    n_pix = cam.W * cam.H
    per = -(-n_pix // blocks)
    target = torch.from_numpy(fit.target_image(ctx).reshape(-1, 3)).to(
        dev, dtype)
    scale = 2.0 / (n_pix * 3)
    lr = float(ctx.traffic["lr"])
    leaves = dict(ctx.leaves)
    theta0 = {k: np.asarray(ctx.leaves[k], np.float32) for k in fit.LEAVES}
    losses, grads = [], []
    for seed in seeds:
        s = tracer.make_scene(leaves, ctx.meta, dev, dtype,
                              requires_grad=True)
        sq = 0.0
        for b in range(blocks):
            if b == drop:
                continue
            pix = torch.arange(b * per, min((b + 1) * per, n_pix),
                               device=dev)
            with torch.no_grad():
                img = torch.zeros((pix.shape[0], 3), dtype=dtype, device=dev)
                for smp in range(spp):
                    img = img + tracer.trace(s, cam, seed, pix,
                                             torch.full_like(pix, smp))
                diff = img * (1.0 / spp) - target[pix]
                sq += float(torch.sum(diff.float() ** 2))
                cot = diff * scale * (1.0 / spp)
            for smp in range(spp):
                for b0 in range(0, pix.shape[0], 1 << 16):
                    p = pix[b0:b0 + (1 << 16)]
                    L = tracer.trace(s, cam, seed, p,
                                     torch.full_like(p, smp),
                                     differentiable=True)
                    torch.autograd.backward(L, cot[b0:b0 + (1 << 16)])
        losses.append(sq / (n_pix * 3))
        g = {k: (s.t[k].grad if s.t[k].grad is not None
                 else torch.zeros_like(s.t[k])) for k in fit.LEAVES}
        grads.append({k: v.float().cpu().numpy() for k, v in g.items()})
        with torch.no_grad():
            leaves.update({k: (s.t[k] - lr * g[k]).float().cpu().numpy()
                           for k in fit.LEAVES})
    change = {k: leaves[k].astype(np.float64) - theta0[k] for k in fit.LEAVES}
    return losses, grads[0], change


def compare(ctx, w):
    ref = fit.reference_steps(ctx, w["seeds"])
    numbers = fit.gaps(fit.program_numbers(w, float(ctx.traffic["lr"])), ref)
    ok, _ = check.judge(ctx.limits, numbers)
    return numbers, 0 if ok else fit.SETUP_STEPS


# ---------------------------------------------------------------------------
# ranks 1 .. n-1
# ---------------------------------------------------------------------------

def worker(rank: int, spec: dict) -> int:
    """One worker rank: its set-up steps, then rank 0's commands until
    stop."""
    from benchmark.harness.window import Context
    from mort_tpu_torch import metrics

    faulthandler.register(signal.SIGUSR1, all_threads=True)
    torch.set_num_threads(int(spec["threads"]))
    device = torch.device(spec["devices"][rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    ctx = Context(cell=spec["cell"], cfg=spec["cfg"],
                  traffic=spec["traffic"], seed=int(spec["seed"]),
                  seconds=0.0, trace=bool(spec["trace"]), device=device,
                  cam=spec["cam"], limits={})
    store = dist.TCPStore("127.0.0.1", int(spec["port"]), spec["world"],
                          is_master=False, timeout=_timeout(ctx))
    dist.init_process_group(spec["backend"], store=store, rank=rank,
                            world_size=spec["world"], timeout=_timeout(ctx))
    side = dist.new_group(backend="gloo", timeout=_timeout(ctx))
    st = _rank_state(ctx, spec["devices"])
    k = fit.SETUP_STEPS
    sub, counters = None, None
    cmd = torch.zeros(2, dtype=torch.int64)
    while True:
        dist.broadcast(cmd, src=0, group=side)
        op, arg = (int(x) for x in cmd)
        if op == STEP:
            fit.unit(st, k)
            k += 1
        elif op == TRACE:
            if sub is None:
                counters = metrics.counters()
                sub = _trace_state(ctx, st)
            sub["data"] = st["data0"].replace()
            fit.unit(sub, len(sub["losses"]))
        elif op == FRESH:
            ctx.seed = arg
            fit.fresh_steps(ctx, st)
        else:
            break
    dist.gather_object(counters if counters is not None
                       else metrics.counters(), None, dst=0, group=side)
    dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one worker rank of the loop")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--spec", required=True)
    a = ap.parse_args(argv)
    return worker(a.rank, json.loads(a.spec))


if __name__ == "__main__":
    sys.exit(main())
