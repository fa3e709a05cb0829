"""The data-parallel fit of mort's scene 1 over gloo ranks on the CPU.

``make_train_step(meta, make_mesh(n))`` for n = 1, 2 and 4 ranks, each a
process of this file (``python tests/test_torch_mesh_fit.py --rank r
--world n ...``, which imports neither jax nor the conftest), runs three
SGD steps of the benchmark's ``mort_scene1_mesh4`` configuration at 64x36,
4 spp, depth 4, as its loop runs them (``benchmark/loops/fit.py``'s
``unit``).  Rank 0's steps are held against the plain reference's
whole-image steps (``benchmark/reference/tracer.py`` through
``fit.gaps``) under the cell's own limits, every rank against rank 0, and
the grouped worlds' all-reduce against its counters.  The one rank runs
without a process group: the one-device path, which records no
all-reduce.  Also: the step's timing events around its all-reduce on a
stand-in card, and the readers of the mesh cell's per-layer metrics.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from stand_in_capture import stand_in  # noqa: E402,F401
from benchmark.harness import cells, check  # noqa: E402
from benchmark.harness import window as win  # noqa: E402
from benchmark.harness.window import Context  # noqa: E402
from benchmark.loops import fit  # noqa: E402
from mort_tpu_torch import metrics  # noqa: E402
from mort_tpu_torch.parallel import sharding  # noqa: E402
from mort_tpu_torch.parallel.launch import run_ranks  # noqa: E402

CELL = "mort_scene1.fit.mesh4"
CAMERA = {"image_width": 64, "image_height": 36, "samples_per_pixel": 4,
          "bounce_limit": 4}
SEED = 2147483711
WORKER_TIMEOUT_S = 240


def context(seed=SEED, device="cpu") -> Context:
    cell = cells.workload(cells.manifest(), CELL)
    cfg = cells.config(cell["config"])
    tr = cells.traffic(cell["traffic"])
    return Context(cell=cell, cfg=cfg, traffic=tr, seed=seed, seconds=0.0,
                   trace=False, device=torch.device(device),
                   cam=cells.camera_fields(cfg, {**tr["camera"], **CAMERA}),
                   limits=cells.limits(CELL))


# ---------------------------------------------------------------------------
# the worker: one rank
# ---------------------------------------------------------------------------

def _worker(args) -> None:
    torch.set_num_threads(1)
    grouped = args.world > 1
    if grouped:
        dist.init_process_group(
            "gloo", init_method=f"file://{args.store}", rank=args.rank,
            world_size=args.world, timeout=datetime.timedelta(seconds=120))
    try:
        _worker_body(args)
    finally:
        if grouped:
            dist.destroy_process_group()


def _forbid_host_waits() -> None:
    """From here on, a wait of the host for the card other than the step's
    own read of its loss raises (the capture, which waits, is over)."""
    def refused(*a, **kw):
        raise AssertionError("the train step waited for the card")
    torch.cuda.synchronize = refused
    torch.cuda.Event.synchronize = refused
    torch.cuda.Event.wait = refused
    torch.cuda.Stream.synchronize = refused


def _worker_body(args) -> None:
    import mort_tpu_torch as mt

    ctx = context(device=args.device)
    devices = [args.device] * args.world
    mesh = sharding.make_mesh(args.world, devices=devices)
    data, meta = ctx.program_scene()
    data = data.to(ctx.device)
    st = {"step": sharding.make_train_step(meta, mesh, use_kernel=True),
          "data": data, "cam": mt.camera_from_numpy(ctx.cam),
          "target": torch.from_numpy(fit.target_image(ctx)).to(ctx.device),
          "losses": [], "seeds": [int(s) for s in args.seeds.split(",")],
          "lr": float(ctx.traffic["lr"])}
    theta = [fit._host(data)]
    per_step = []
    for k in range(args.steps):
        if k == 1 and ctx.device.type == "cuda":
            _forbid_host_waits()
        fit.unit(st, k)
        per_step.append(st["step"].collectives["all_reduce"])
        if k in (0, fit.SETUP_STEPS - 1):
            theta.append(fit._host(st["data"]))
    np.savez(os.path.join(args.out, f"rank{args.rank}.npz"),
             **{f"theta{i}_{k}": v for i, th in enumerate(theta)
                for k, v in th.items()})
    with open(os.path.join(args.out, f"rank{args.rank}.json"), "w") as f:
        json.dump({"losses": st["losses"], "counters": metrics.counters(),
                   "per_step": per_step,
                   "grads_reduced": mesh.collectives["grads"],
                   "groups": len(mesh.groups)}, f)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def _run_world(n, out, seeds, device="cpu", steps=fit.SETUP_STEPS):
    """Start the n ranks of one world, wait for them and read each rank's
    results: (json, theta list of three leaf dicts)."""
    out.mkdir(parents=True, exist_ok=True)
    run_ranks(
        [[sys.executable, os.path.abspath(__file__), "--rank", r, "--world",
          n, "--store", out / "store", "--out", out, "--device", device,
          "--steps", steps, "--seeds", ",".join(map(str, seeds))]
         for r in range(n)],
        [out / f"rank{r}.log" for r in range(n)], WORKER_TIMEOUT_S)
    ranks = []
    for r in range(n):
        with open(out / f"rank{r}.json") as f:
            res = json.load(f)
        z = np.load(out / f"rank{r}.npz")
        res["theta"] = [{k: z[f"theta{i}_{k}"] for k in fit.LEAVES}
                        for i in range(3)]
        ranks.append(res)
    return ranks


@pytest.fixture(scope="module")
def reference():
    """The reference's whole-image three steps at the test's size."""
    torch.set_num_threads(max(1, min(4, torch.get_num_threads())))
    ctx = context()
    seeds = [int(s) for s in win.unit_seeds(SEED, "steps")[:3]]
    return seeds, fit.reference_steps(ctx, seeds)


def _bucket_bytes() -> int:
    data, _ = context().program_scene()
    return 4 * (1 + sum(getattr(data, k).numel()
                        for k in sharding._DIFF_FIELDS))


@pytest.mark.parametrize("n", [1, 2, 4])
def test_mesh_fit_matches_the_reference(n, reference, tmp_path):
    seeds, ref = reference
    ranks = _run_world(n, tmp_path, seeds)
    r0 = ranks[0]
    w = {"setup_losses": r0["losses"], "theta": r0["theta"]}
    numbers = fit.gaps(fit.program_numbers(w, 1.0), ref)
    ok, lines = check.judge(cells.limits(CELL), numbers)
    assert ok, lines
    # every rank holds the same scene after every step
    for res in ranks[1:]:
        assert res["losses"] == r0["losses"]
        for th, th0 in zip(res["theta"], r0["theta"]):
            for k in fit.LEAVES:
                np.testing.assert_array_equal(th[k], th0[k], err_msg=k)
    for res in ranks:
        c = res["counters"]
        assert "train.all_reduce_device_ns" not in c       # no card
        if n == 1:
            assert res["groups"] == 0 and res["grads_reduced"] == 0
            assert res["per_step"] == [0] * 3
            assert "train.all_reduce_bytes" not in c
        else:
            assert res["groups"] == 1 and res["grads_reduced"] == 3
            assert res["per_step"] == [1] * 3
            assert c["train.all_reduce_bytes"] == 3 * _bucket_bytes()


def test_split_reference_equals_the_whole_image(reference):
    """The mesh cell's reference with its pixels in the ranks' blocks gives
    the whole-image reference up to float32 association; the last of four
    blocks left out of the sums (the calibration's planted fault) fails
    the limits."""
    from benchmark.loops import fit_mesh

    seeds, ref = reference
    ctx = context()
    split = fit_mesh.reference_steps(ctx, seeds, blocks=2)
    numbers = fit.gaps(split, ref)
    assert max(numbers.values()) < 1e-5, numbers
    dropped = fit_mesh.reference_steps(ctx, seeds, blocks=4, drop=3)
    ok, lines = check.judge(cells.limits(CELL), fit.gaps(dropped, ref))
    assert not ok, lines


# ---------------------------------------------------------------------------
# the all-reduce's timing events, on a stand-in card
# ---------------------------------------------------------------------------

class _Event:
    """A stand-in timing event: ``ms`` at its record, ``query`` done."""

    def __init__(self, ms, done):
        self.ms, self.done, self.records = ms, done, 0

    def record(self, stream=None):
        self.records += 1

    def query(self):
        return self.done

    def elapsed_time(self, end):
        return end.ms - self.ms


@pytest.mark.parametrize("done", [True, False])
def test_all_reduce_events_read_with_the_replay(monkeypatch, tmp_path, done,
                                                stand_in):
    """On the graph route of a grouped mesh (a one-rank gloo group, a
    stand-in capture and stand-in events) each replayed step's all-reduce
    is bracketed by two events, read at the next call's entry with the
    replay's stamps: its device time and a count, or, not done, one unread
    each; the eager first step's all-reduce is not timed.  Every step adds
    its bucket's bytes."""
    events = (_Event(1.0, done), _Event(1.5, done))
    stand_in.stamps = lambda: (_Event(0.0, True), _Event(4.0, True))
    monkeypatch.setattr(sharding, "_all_reduce_events",
                        lambda mesh, device: events if mesh.groups else None)
    metrics.reset_spans()
    ctx = context()
    data, meta = ctx.program_scene()
    cam = cells.camera_fields(ctx.cfg, {"image_width": 4, "image_height": 3,
                                        "samples_per_pixel": 1,
                                        "bounce_limit": 2})
    import mort_tpu_torch as mt
    cam = mt.camera_from_numpy(cam)
    target = np.full((3, 4, 3), 0.5, np.float32)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 's'}",
                            rank=0, world_size=1)
    try:
        mesh = sharding.make_mesh(1, devices=["cpu"])
        step = sharding.make_train_step(meta, mesh, use_kernel=True)
        for k in range(4):
            step(data, cam, target, 7 + k)
    finally:
        dist.destroy_process_group()
    c = metrics.counters()
    metrics.reset_spans()
    # steps 2 and 3 replayed and timed (step 1 is the eager first), their
    # all-reduces read by steps 3 and 4
    assert events[0].records == events[1].records == 3
    assert c["train.all_reduce_bytes"] == 4 * _bucket_bytes()
    if done:
        assert c["train.all_reduce_device_ns"] == 2 * 500_000
        assert c["train.all_reduce_device_count"] == 2
        assert c["train.step_device_ns"] == 2 * 4_000_000
        assert "train.all_reduce_device_unread" not in c
    else:
        assert c["train.all_reduce_device_unread"] == 2
        assert c["train.step_device_unread"] == 2
        assert "train.all_reduce_device_ns" not in c


def test_one_device_step_makes_no_events(monkeypatch):
    made = []
    real = sharding._all_reduce_events
    monkeypatch.setattr(sharding, "_all_reduce_events",
                        lambda *a: made.append(real(*a)) or made[-1])
    _, meta = context().program_scene()
    sharding.make_train_step(meta, device="cpu")
    sharding.make_train_step(meta, sharding.make_mesh(1, devices=["cpu"]))
    assert made == [None, None]


# ---------------------------------------------------------------------------
# the readers of the mesh cell's per-layer metrics
# ---------------------------------------------------------------------------

RANK0 = {"train.step_device_ns": 900, "train.step_period_ns": 1000,
         "train.all_reduce_device_ns": 30_000_000,
         "train.all_reduce_device_count": 10}
OTHERS = [{"train.step_device_ns": 850, "train.all_reduce_device_count": 10},
          {"train.step_device_ns": 950, "train.all_reduce_device_count": 10},
          {"train.step_device_ns": 870, "train.all_reduce_device_count": 10}]
EXPECTED = {
    # 30 ms over 10 reads
    "mesh.all_reduce_ms.fit": 3.0,
    # (95 - 85) ns a step over rank 0's 100-ns period
    "mesh.rank_skew.fit": 10.0,
    "mesh.outside_graph.fit": 10.0,
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_mesh_reader_on_planted_counters(name, monkeypatch):
    assert name in {m["name"] for m in cells.manifest()["per_layer"]}
    reader = cells.metric_reader(name)
    monkeypatch.setattr(metrics, "counters", lambda: {})
    assert reader.read({}) is None
    assert reader.read({"rank_counters": [{}, {}]}) is None
    monkeypatch.setattr(metrics, "counters", lambda: dict(RANK0))
    got = reader.read({"rank_counters": [dict(RANK0)] + OTHERS})
    assert got == pytest.approx(EXPECTED[name], rel=1e-12)


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    for flag in ("--rank", "--world", "--steps"):
        parser.add_argument(flag, type=int, required=True)
    for flag in ("--store", "--out", "--device", "--seeds"):
        parser.add_argument(flag, required=True)
    _worker(parser.parse_args())
