"""The program's spans and counters (``mort_tpu_torch.metrics``) on the CPU.

- with a stand-in clock: nesting, self time, path keys, the root's
  sequence number, and one stack a thread;
- under ``torch.profiler`` the spans are the profiler's ranges, nested as
  called, in ``metrics.trace``'s ``trace.json``, and the totals and
  counters stay as they were;
- a CPU ``render_wavefront``, ``view`` and train step: span counts against
  ``graph_count`` and ``step_graph_count``, and on the graph route with
  the stand-in capture (``stand_in_capture``) whose replays return
  stand-in timing events, the device-time and period counters of the
  rounds and the steps;
- the six per-layer readers of ``benchmark/metrics`` that read the spans:
  None on empty totals, the expected value on planted ones.
"""

import io
import json
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from stand_in_capture import stand_in  # noqa: F401

from benchmark.harness import cells
from mort_tpu_torch import metrics
from mort_tpu_torch.interactive import view
from mort_tpu_torch.parallel import sharding
from mort_tpu_torch.parallel.sharding import make_train_step
from mort_tpu_torch.render import wavefront as twf
from mort_tpu_torch.scene import scenes as tsc

SEED = 11


class _Clock:
    """A stand-in for the spans' clock: ``now`` ns until moved."""

    def __init__(self):
        self.now = 0

    def __call__(self):
        return self.now


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    monkeypatch.setattr(metrics, "_clock", c)
    metrics.reset_spans()
    yield c
    metrics.reset_spans()


@pytest.fixture
def fresh():
    """Empty totals and counters before and after the test."""
    metrics.reset_spans()
    yield
    metrics.reset_spans()


def test_nesting_self_time_and_paths(clock):
    with metrics.span("a") as a:
        clock.now = 10
        with metrics.span("b") as b1:
            clock.now = 15
        clock.now = 20
        with metrics.span("b") as b2:
            with metrics.span("c") as c:
                clock.now = 30
            clock.now = 32
        clock.now = 40
    with metrics.span("a") as a2:
        clock.now = 41
    t = metrics.span_totals()
    assert set(t) == {"a", "a/b", "a/b/c"}
    assert t["a"] == (2, 41, 41 - 5 - 12)
    assert t["a/b"] == (2, 5 + 12, 5 + 12 - 10)
    assert t["a/b/c"] == (1, 10, 10)
    assert (a.start, a.end, c.start, c.end) == (0, 40, 20, 30)
    assert b1.parent is a and c.parent is b2 and a.parent is None
    assert c.path == "a/b/c" and b2.path == "a/b"
    assert a.root == b1.root == b2.root == c.root != a2.root
    assert metrics.total_of(t, "b") == (2, 17, 7)
    assert metrics.total_of(t, "c", under="a") == (1, 10, 10)
    assert metrics.total_of(t, "c", under="x") == (0, 0, 0)


def test_counters_and_reset(clock):
    metrics.count("x.n")
    metrics.count("x.n", 4)
    metrics.count("x.ns", 250)
    with metrics.span("x.s"):
        pass
    assert metrics.counters() == {"x.n": 5, "x.ns": 250}
    copy = metrics.counters()
    copy["x.n"] = 0
    assert metrics.counters()["x.n"] == 5
    metrics.reset_spans()
    assert metrics.counters() == {} and metrics.span_totals() == {}


def test_spanned_decorator(clock):
    @metrics.spanned("d.call")
    def f(x):
        """Doubles."""
        clock.now += 7
        return 2 * x

    assert f(3) == 6 and f.__doc__ == "Doubles." and f.__name__ == "f"
    assert metrics.span_totals()["d.call"] == (1, 7, 7)


def test_each_thread_has_its_own_stack(fresh):
    """Threads that open spans at once nest each under its own: the
    paths are one thread's, and no update is lost."""
    n_threads, n_spans = 8, 300
    barrier = threading.Barrier(n_threads)

    def work():
        barrier.wait(timeout=60)
        for _ in range(n_spans):
            with metrics.span("t.outer"):
                with metrics.span("t.inner"):
                    metrics.count("t.n")

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(th.is_alive() for th in threads)
    t = metrics.span_totals()
    assert set(t) == {"t.outer", "t.outer/t.inner"}
    assert t["t.outer"].count == t["t.outer/t.inner"].count \
        == n_threads * n_spans
    assert metrics.counters() == {"t.n": n_threads * n_spans}


def _ranges(prof):
    """(name, start, end) of the profiler's host events named as spans."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("p.")]


def test_spans_under_the_profiler_are_its_ranges(fresh):
    with metrics.span("p.before"):
        pass
    before = metrics.span_totals()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with metrics.span("p.outer"):
            with metrics.span("p.inner"):
                torch.ones(8).sum()
            metrics.count("p.n", 3)
    assert metrics.span_totals() == before
    assert metrics.counters() == {}
    got = {name: (s, e) for name, s, e in _ranges(prof)}
    assert set(got) == {"p.outer", "p.inner"}
    (o0, o1), (i0, i1) = got["p.outer"], got["p.inner"]
    assert o0 <= i0 < i1 <= o1
    # after the profiler the spans count again
    with metrics.span("p.before"):
        pass
    assert metrics.span_totals()["p.before"].count == 2


def test_trace_writes_the_spans(fresh, tmp_path):
    with metrics.trace(str(tmp_path)):
        with metrics.span("p.outer"):
            with metrics.span("p.inner"):
                torch.ones(8).sum()
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("name", "")
             .startswith("p.")}
    assert set(spans) == {"p.outer", "p.inner"}
    o, i = spans["p.outer"], spans["p.inner"]
    assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"]
    assert metrics.span_totals() == {}


# ---------------------------------------------------------------------------
# the program's spans on the CPU
# ---------------------------------------------------------------------------

def _scene7(width=16):
    world, cam = tsc.build_scene(7)
    data, meta = world.compile()
    cam = cam.replace(image_width=width, image_height=width, sqrt_spp=2,
                      bounce_limit=4)
    return data, meta, cam


def _graph_counts(fn):
    before = dict(twf.graph_count)
    out = fn()
    return out, {k: twf.graph_count[k] - before[k] for k in before}


def test_render_wavefront_spans_agree_with_graph_count(fresh):
    data, meta, cam = _scene7()
    for calls in (1, 2):
        metrics.reset_spans()

        def render():
            for _ in range(calls):
                twf.render_wavefront(data, meta, cam, "cpu", seed=SEED,
                                     pool=256, window=2, spt=1,
                                     max_paths_per_call=300)
        _, moved = _graph_counts(render)
        t = metrics.span_totals()
        assert moved["spans"] > calls
        assert t["wavefront.call"].count == calls
        assert t["wavefront.call/wavefront.operands"].count == calls
        assert t["wavefront.call/wavefront.span"].count == moved["spans"]
        reads = metrics.total_of(t, "wavefront.read")
        assert reads.count == moved["rounds"] + moved["spans"]
        for name in ("wavefront.start", "wavefront.drain"):
            assert metrics.total_of(t, name).count == moved["spans"]
        # the CPU replays nothing: no launch, no device time
        assert metrics.total_of(t, "wavefront.launch").count == 0
        assert metrics.counters() == {}


class _Stamp:
    """A stand-in timing event: ``elapsed_time`` from ``start`` to
    ``end`` in ms, ``query`` whether the replay is done."""

    def __init__(self, ms=0.0, done=True):
        self.ms, self.done = ms, done

    def elapsed_time(self, end):
        return end.ms - self.ms

    def query(self):
        return self.done


def _stamps(clock, device_ms, done=True):
    """A replay's stand-in timing events: they move the clock on by 1 ms
    and are ``device_ms`` apart."""
    def stamps():
        clock.now += 1_000_000
        return _Stamp(0.0, done), _Stamp(device_ms, done)
    return stamps


def test_replayed_rounds_count_device_time_and_period(clock, stand_in):
    """On the graph route (a stand-in capture) each replay is one
    "wavefront.launch" and, after the read that follows it, adds its
    device time and its period (read end to read end) to the counters;
    the key's eager round with its capture is a span of its own."""
    stand_in.stamps = _stamps(clock, 0.25)
    data, meta, cam = _scene7()
    for k in range(2):
        metrics.reset_spans()
        _, moved = _graph_counts(lambda: twf.render_wavefront(
            data, meta, cam, "cpu", seed=SEED + k, pool=256, window=2, spt=1,
            max_paths_per_call=300))
        t = metrics.span_totals()
        # the first call: the eager round and its capture,
        # "wavefront.warm" and not timed; every later round a replay
        warm = metrics.total_of(t, "wavefront.warm").count
        timed = metrics.total_of(t, "wavefront.launch").count
        assert warm == (1, 0)[k]
        assert timed == moved["replays"] > 0
        assert moved["rounds"] == timed + warm
        c = metrics.counters()
        assert c["wavefront.round_device_ns"] == timed * 250_000
        assert c["wavefront.round_period_ns"] == timed * 1_000_000
    assert metrics.total_of(t, "wavefront.copy_in").count == moved["spans"]


@pytest.mark.parametrize("preview_spt", [None, 1])
def test_view_spans_a_frame_each(fresh, preview_spt):
    data, meta, cam = _scene7(width=8)
    events = [("frame",), ("key", "w"), ("frame",), ("mouse", 3.0, -2.0),
              ("frame",), ("frame",)]
    log = io.StringIO()
    _, moved = _graph_counts(lambda: view(
        data, meta, cam, events, seed=SEED, log=log, device="cpu",
        preview_spt=preview_spt))
    t = metrics.span_totals()
    assert t["viewer.call"].count == 1
    frame = "viewer.call/viewer.frame"
    assert t[frame].count == 4
    for name in ("wavefront.call", "viewer.copy_out", "viewer.finish"):
        assert t[f"{frame}/{name}"].count == 4
    assert metrics.total_of(t, "wavefront.read").count == \
        moved["rounds"] + moved["spans"]
    lines = log.getvalue().splitlines()
    assert len(lines) == 4
    for line in lines:
        assert line.startswith("Avg. time per frame: ")
        assert line.endswith(" ms")
        float(line[len("Avg. time per frame: "):-3])


def _step_scene():
    world, cam = tsc.build_scene(7)
    data, meta = world.compile()
    cam = cam.replace(image_width=6, image_height=6, sqrt_spp=1,
                      bounce_limit=3)
    return data, meta, cam, np.full((6, 6, 3), 0.5, np.float32)


def test_train_steps_span_a_step_each(fresh):
    data, meta, cam, target = _step_scene()
    step = make_train_step(meta, device="cpu")
    before = dict(sharding.step_graph_count)
    for k in range(3):
        step(data if k < 2 else data.replace(), cam, target, SEED + k)
    moved = {k: sharding.step_graph_count[k] - before[k] for k in before}
    t = metrics.span_totals()
    assert t["train.step"].count == moved["steps"] == 3
    assert t["train.step/train.prep"].count == 3
    # the first call and the third (a new SceneData) miss
    assert metrics.counters() == {"train.prep_miss": 2}
    assert metrics.total_of(t, "train.launch").count == 0


@pytest.mark.parametrize("done", [True, False])
def test_replayed_steps_count_device_time_and_period(clock, stand_in,
                                                     done):
    """On the graph route (a stand-in capture) each call reads the last
    replay's timing events on entry: its device time and the period from
    that call's start to its own, or, not yet done, one unread."""
    stand_in.stamps = _stamps(clock, 2.5, done)
    data, meta, cam, target = _step_scene()
    step = make_train_step(meta, device="cpu")
    for k in range(4):
        clock.now += 10_000_000
        step(data, cam, target, SEED + k)
    t = metrics.span_totals()
    assert t["train.step"].count == 4
    assert t["train.step/train.eager"].count == 1
    assert t["train.step/train.launch"].count == 3
    assert t["train.step/train.copy_in"].count == 3
    assert t["train.step/train.out"].count == 3
    c = metrics.counters()
    assert c["train.prep_miss"] == 1
    if done:
        # the replays of calls 2 and 3, read by calls 3 and 4
        assert c["train.step_device_ns"] == 2 * 2_500_000
        assert c["train.step_period_ns"] == 2 * 11_000_000
        assert "train.step_device_unread" not in c
    else:
        assert c["train.step_device_unread"] == 2
        assert "train.step_device_ns" not in c


# ---------------------------------------------------------------------------
# the readers of the spans in benchmark/metrics
# ---------------------------------------------------------------------------

def _total(count, ms, self_ms=None):
    return metrics.SpanTotal(count, int(ms * 1e6),
                             int((ms if self_ms is None else self_ms) * 1e6))


PLANTED = {
    "wavefront.call": _total(4, 100.0),
    "wavefront.call/wavefront.span/wavefront.read": _total(30, 60.0),
    "wavefront.call/wavefront.span/wavefront.launch": _total(26, 13.0),
    "wavefront.call/wavefront.span/wavefront.warm": _total(2, 12.0, 5.0),
    "wavefront.call/wavefront.span/wavefront.warm/graphs.capture":
        _total(1, 7.0),
    "viewer.frame": _total(3, 90.0),
    "viewer.frame/wavefront.call": _total(3, 75.0),
    "viewer.frame/wavefront.call/wavefront.span/wavefront.read":
        _total(9, 30.0),
    "train.step": _total(5, 1050.0),
    "train.step/train.eager": _total(1, 800.0),
    "train.step/graphs.capture": _total(1, 200.0),
    "train.step/train.launch": _total(4, 2.0),
}
COUNTERS = {"wavefront.round_device_ns": 750, "wavefront.round_period_ns":
            1000, "train.step_device_ns": 900, "train.step_period_ns": 1200}
EXPECTED = {
    # 26 launches in 13 ms; 100 - 100 * 750 / 1000
    "wavefront.launch_ms.frames": 0.5,
    "wavefront.round_gap.frames": 25.0,
    # the calls' 175 ms less 90 ms of reads and 12 ms of warm rounds (the
    # capture among them), over 7
    "wavefront.call_host_ms.preview": (175.0 - 90.0 - 12.0) / 7,
    # the frames' 90 ms less their calls' 75 ms, over 3
    "viewer.host_ms.preview": 5.0,
    # the steps' 1050 ms less the eager step and capture, over 5
    "train.host_ms.fit": 10.0,
    "train.outside_graph.fit": 25.0,
}


def test_the_readers_are_in_the_benchmark():
    names = {m["name"] for m in cells.manifest()["per_layer"]}
    assert set(EXPECTED) <= names


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_none_on_empty_totals(name, fresh):
    assert cells.metric_reader(name).read({}) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_planted_totals(name, monkeypatch):
    monkeypatch.setattr(metrics, "span_totals", lambda: dict(PLANTED))
    monkeypatch.setattr(metrics, "counters", lambda: dict(COUNTERS))
    got = cells.metric_reader(name).read({})
    assert got == pytest.approx(EXPECTED[name], rel=1e-12)


# ---------------------------------------------------------------------------
# the operator tools' idle time by innermost span
# ---------------------------------------------------------------------------

class _Event:
    def __init__(self, name, start, end, device=False, annotation=False):
        self._name, self._s, self._d = name, start, end - start
        self._dev, self._ann = device, annotation

    def name(self):
        return self._name

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self._dev else DeviceType.CPU

    def is_user_annotation(self):
        return self._ann


class _Prof:
    def __init__(self, events):
        results = type("R", (), {"events": lambda _self: events})()
        self.profiler = type("P", (), {"kineto_results": results})()


def test_idle_by_span_cuts_gaps_at_the_innermost_span():
    """Device gaps [10, 20), [30, 60), [70, 75) and [100, 105) against
    spans a [0, 100) > b [25, 50) > c [40, 45), the runtime's own events and
    a device-side range ignored; the gap past every span is outside."""
    from mort_tpu_torch.profile_wavefront import OUTSIDE, idle_by_span

    events = [
        _Event("a.x", 0, 100), _Event("b.y", 25, 50), _Event("c.z", 40, 45),
        _Event("cudaGraphLaunch", 30, 60), _Event("aten::mul", 70, 75),
        _Event("k", 0, 10, device=True), _Event("k", 20, 30, device=True),
        _Event("k", 60, 70, device=True), _Event("k", 75, 100, device=True),
        _Event("k", 105, 110, device=True),
        _Event("b.y", 0, 110, device=True, annotation=True),
    ]
    by_span, long = idle_by_span(_Prof(events), long_ns=9)
    ns = {k: round(v * 1e9) for k, v in by_span.items()}
    assert ns == {"a.x": 10 + 10 + 5, "b.y": 10 + 5, "c.z": 5, OUTSIDE: 5}
    assert [(s, n) for s, n, _ in long] == [(10, 10), (30, 30)]
    assert long[1][2] == {"b.y": 15, "c.z": 5, "a.x": 10}
