"""The mesh fit cell (``loops/fit_mesh.py``) on four gloo ranks of the CPU:
a sound run is correct, a run with one rank's pixels left out of the
gradient sum or checked against the bfloat16 control is not, and a rank
that dies fails the run instead of hanging it.  Each run drives
``run.main`` at a small size (the card's look skipped); its workers are
processes, as on the cards."""

import json
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.harness import cells, check
from benchmark.loops import fit, fit_mesh

CELL = "mort_scene1.fit.mesh4"
SMALL = dict(image_width=16, image_height=9, samples_per_pixel=4)
TIMEOUT_S = 30


def drive(capsys, seconds="0.5", trace="0"):
    torch.set_num_threads(2)
    rc = run.main(["--workload", CELL, "--seed", "2147483693", "--seconds",
                   seconds, "--trace", trace], device="cpu", camera=SMALL)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


@pytest.fixture
def short_timeout(monkeypatch):
    real = cells.traffic

    def traffic(name):
        return dict(real(name), timeout_s=TIMEOUT_S)
    monkeypatch.setattr(cells, "traffic", traffic)


def _wrapped_workers(monkeypatch, tmp_path, body):
    """Workers started through a script that runs ``body`` (with ``rank``,
    ``sharding`` and ``fit_mesh`` defined) before the worker's own main."""
    script = tmp_path / "worker.py"
    script.write_text(
        f"import sys\nsys.path.insert(0, {str(cells.ROOT)!r})\n"
        "from mort_tpu_torch.parallel import sharding\n"
        "from benchmark.loops import fit_mesh\n"
        "rank = int(sys.argv[sys.argv.index('--rank') + 1])\n"
        + textwrap.dedent(body)
        + "sys.exit(fit_mesh.main(sys.argv[1:]))\n")

    def command(rank, spec):
        return [sys.executable, str(script), "--rank", str(rank), "--spec",
                json.dumps(spec)]
    monkeypatch.setattr(fit_mesh, "worker_command", command)


def test_a_sound_mesh_run_is_correct(capsys, short_timeout):
    res = drive(capsys)
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert res["attempted"] >= 1 and res["device"]["count"] == 4
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"grad_paths_per_s", "setup_s"}


def test_a_traced_mesh_run_gathers_every_rank(capsys, short_timeout,
                                              monkeypatch):
    got = {}
    real = fit_mesh.traced

    def traced(ctx, st, w):
        obs = real(ctx, st, w)
        got.update(obs)
        return obs
    monkeypatch.setattr(fit_mesh, "traced", traced)
    from mort_tpu_torch import metrics
    metrics.reset_spans()
    res = drive(capsys, trace="1")
    assert res["correct"], res["checks"]
    assert len(got["rank_counters"]) == 4 and got["steps"] == 2
    for c in got["rank_counters"]:
        # the set-up and window steps' buckets, no traced step's
        assert c["train.all_reduce_bytes"] == \
            got["rank_counters"][0]["train.all_reduce_bytes"] > 0


def test_one_rank_left_out_of_the_sum_fails(capsys, monkeypatch, tmp_path,
                                            short_timeout):
    """Rank 3's bucket zeroed before the all-reduce: its quarter of the
    pixels is missing from the loss and the gradients."""
    _wrapped_workers(monkeypatch, tmp_path, """
        if rank == 3:
            real = sharding._all_reduce

            def dropped(mesh, t, what):
                t.zero_()
                return real(mesh, t, what)
            sharding._all_reduce = dropped
        """)
    res = drive(capsys)
    assert not res["correct"], res["checks"]


def test_the_control_fails_the_limits():
    torch.set_num_threads(2)
    cell = cells.workload(cells.manifest(), CELL)
    cfg = cells.config(cell["config"])
    tr = cells.traffic(cell["traffic"])
    from benchmark.harness.window import Context
    ctx = Context(cell=cell, cfg=cfg, traffic=tr, seed=2147483701,
                  seconds=0.0, trace=False, device=torch.device("cpu"),
                  cam=cells.camera_fields(cfg, {**tr["camera"], **SMALL}),
                  limits=cells.limits(CELL))
    seeds = [11, 12, 13]
    ref = fit.reference_steps(ctx, seeds)
    low = fit_mesh.reference_steps(ctx, seeds, torch.bfloat16)
    ok, lines = check.judge(ctx.limits, fit.gaps(low, ref))
    assert not ok, lines


def test_mesh_config_is_scene1():
    """``mort_scene1_mesh4`` compiles to ``mort_scene1``'s primitives in
    the program and in the reference, and keeps its camera."""
    mesh, one = cells.config("mort_scene1_mesh4"), cells.config("mort_scene1")
    assert (mesh["builder"], mesh["scene"], mesh["camera"]) == \
        (one["builder"], one["scene"], one["camera"])
    (lm, mm), (lo, mo) = cells.scene(mesh), cells.scene(one)
    assert mm == mo and set(lm) == set(lo)
    for k in lo:
        if k != "images":
            np.testing.assert_array_equal(lm[k], lo[k], err_msg=k)
    (dm, pm), (do, po) = cells.program_scene(mesh), cells.program_scene(one)
    assert (pm.n_spheres, pm.n_quads) == (po.n_spheres, po.n_quads)
    for k in fit.LEAVES:
        assert torch.equal(getattr(dm, k), getattr(do, k)), k


def test_a_dead_rank_fails_the_run(capsys, monkeypatch, tmp_path,
                                   short_timeout):
    """Rank 2 exits in its first window step: the run raises well within
    the group's timeout, and every worker is gone after it."""
    _wrapped_workers(monkeypatch, tmp_path, """
        if rank == 2:
            import os
            from benchmark.loops import fit
            real_unit = fit.unit
            done = []

            def unit(st, k):
                done.append(k)
                if len(done) > fit.SETUP_STEPS:
                    os._exit(9)
                return real_unit(st, k)
            fit.unit = unit
        """)
    started = {}
    real_setup = fit_mesh.setup

    def setup(ctx):
        st = real_setup(ctx)
        started.update(t=time.perf_counter(), procs=list(st["mesh"]["procs"]))
        return st
    monkeypatch.setattr(fit_mesh, "setup", setup)
    torch.set_num_threads(2)
    with pytest.raises(RuntimeError):
        run.main(["--workload", CELL, "--seed", "2147483693", "--seconds",
                  "60", "--trace", "0"], device="cpu", camera=SMALL)
    assert time.perf_counter() - started["t"] < TIMEOUT_S
    assert all(p.poll() is not None for p in started["procs"])
    import torch.distributed as dist
    assert not dist.is_initialized()


def test_window_commands_go_out_one_step_ahead(monkeypatch):
    """A window step's command is posted before rank 0's step before it
    runs, and rank 0 waits only for commands two posts old; one step runs
    past the window for the command its last unit sent."""
    log = []

    class Work:
        def __init__(self, op):
            self.op = op

        def wait(self):
            log.append(("wait", self.op))

    def broadcast(t, src, group, async_op=False):
        assert async_op and src == 0 and group == "side"
        log.append(("post", int(t[0])))
        return Work(int(t[0]))
    monkeypatch.setattr(fit_mesh.dist, "broadcast", broadcast)
    monkeypatch.setattr(fit_mesh.fit, "unit",
                        lambda st, k: log.append(("step", k)))
    monkeypatch.setattr(fit_mesh, "_stop",
                        lambda ctx, mesh: log.append(("stop",)))
    ticks = iter(range(1000))
    monkeypatch.setattr(fit_mesh.win.time, "perf_counter",
                        lambda: float(next(ticks)))

    class Ctx:
        seconds, trace = 5.0, False
        cam = {"image_width": 4, "image_height": 2, "sqrt_spp": 1}
    st = {"mesh": {"procs": [], "logs": [], "side": "side", "posted": []},
          "losses": [], "theta": [], "seeds": []}
    w = fit_mesh.window(Ctx, st)
    n, s, STEP = w["units"], fit.SETUP_STEPS, fit_mesh.STEP
    assert n >= 2
    steps = [e for e in log if e[0] == "step"]
    assert steps == [("step", s + k) for k in range(n + 1)]
    # every step's command was posted before rank 0's step before it
    for k in range(n + 1):
        posts = [i for i, e in enumerate(log) if e[0] == "post"]
        assert posts[k] < log.index(("step", s + k)) and \
            (k == 0 or posts[k] < log.index(("step", s + k - 1)))
    assert sum(e == ("post", STEP) for e in log) == n + 1
    # all waited for before stop
    assert sum(e[0] == "wait" for e in log) == n + 1
    assert log[-1] == ("stop",) and st["mesh"]["posted"] == []


def test_card_ranks_take_one_thread():
    """Ranks on cards take one intra-op thread each, as torchrun's
    processes do; CPU ranks keep the run's count."""
    class Ctx:
        device = torch.device("cuda", 0)
    assert fit_mesh._threads(Ctx) == 1
    Ctx.device = torch.device("cpu")
    assert fit_mesh._threads(Ctx) == torch.get_num_threads()
