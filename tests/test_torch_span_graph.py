"""The wavefront span as one captured round kept by key: what the CPU can
hold.

On a card ``_span_core`` keeps one program a graph key across spans and
calls (``graphs.KeptProgram``): the key's first round runs eagerly and is
captured into a CUDA graph, and every later round of every span of the
key replays it (the counterpart of the JAX package's
``jax.jit(_wavefront_span)`` and its cache).  The capture itself needs the
card (``test_torch_cuda.py`` holds the graph route against the eager route
there); on the CPU these tests hold what the capture rests on:

- the round schedule (rounds and useful segments) against the JAX
  package's at the same pool, window and spt;
- the fixed-shape deposit (one ``index_add_`` over every lane, the
  non-depositing ones into drop rows past the image) bit-equal to the
  deposit of the depositing lanes alone (``nonzero``);
- layer-aligned resume bit-equal;
- no host read and no tensor made from host data inside a round of a
  kept key (the seed and the span's end device scalars), which a capture
  would refuse, nor in the span's start;
- with the stand-in capture (``stand_in_capture``) whose replay runs the
  key's round: one capture a key, a replay for every later round of every
  span and call; a second call of the key with the seed, the task range,
  ``fb``, the camera and the scene changed gives the eager route's bits;
  progressive resume bit-equal.

``test_torch_kept_programs.py`` holds what the three captured programs
share: the CPU never captures, a new key recaptures, results stay fresh,
in-place updates are read, a failure drops the key, and the stand-in
route against the JAX package.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from conftest import assert_images_close
from stand_in_capture import stand_in  # noqa: F401

from mort_tpu.render import wavefront as jwf
from mort_tpu.scene import scenes as jsc
from mort_tpu_torch.render import wavefront as twf
from mort_tpu_torch.render.graphs import cloned
from mort_tpu_torch.render.vec import V3
from mort_tpu_torch.scene import scenes as tsc

# test_golden.py's config (48 px, 4 spp) at test_torch_render_final.py's
# depth 4
WIDTH = 48
SQRT_SPP = 2
DEPTH = 4
POOL, WINDOW, SPT = 1024, 3, 4
SEED = 5
# Useful segments of the two packages may differ by a few: two float32
# implementations (XLA's fused transcendentals against torch's) end a few
# paths a bounce apart, as the image rule allows some pixels to differ.
# Measured at this config over seeds 5-7: 3-4 of ~12,200 (scene 1), 1-6 of
# ~27,800 (scene 6), 1-15 of ~26,100 (scene 9); the rounds were equal on
# every one.
USEFUL_RTOL = 1e-3


def _small(cam):
    h = max(1, int(WIDTH * cam.image_height / cam.image_width))
    return cam.replace(image_width=WIDTH, image_height=h, sqrt_spp=SQRT_SPP,
                       bounce_limit=DEPTH)


@pytest.mark.parametrize("idx", [1, 6, 9])
def test_schedule_matches_jax(idx, monkeypatch):
    """The port's rounds equal the JAX package's at the same pool, window
    and spt, and its useful segments agree within USEFUL_RTOL; the images
    pass the image rule.  The port renders fallback textures inline (the
    JAX package's deferred mode is not ported, ROADMAP A), so the JAX
    package's gate for that mode is turned off here: its deferred lanes
    stall and change the schedule (scene 9: 15 rounds against 12)."""
    monkeypatch.setattr(jwf, "_defer_tex_ok", lambda data, meta: False)
    jworld, jcam = jsc.build_scene(idx)
    jdata, jmeta = jworld.compile()
    want, jstats = jwf.render_wavefront(
        jdata, jmeta, _small(jcam), seed=SEED, pool=POOL, window=WINDOW,
        spt=SPT, use_pallas=False, return_stats=True)
    world, cam = tsc.build_scene(idx)
    data, meta = world.compile()
    got, stats = twf.render_wavefront(
        data, meta, _small(cam), "cpu", seed=SEED, pool=POOL, window=WINDOW,
        spt=SPT, return_stats=True)
    assert stats["iterations"] == jstats["iterations"]
    assert stats["slots_executed"] == jstats["slots_executed"]
    assert abs(stats["useful_segments"] - jstats["useful_segments"]) \
        <= USEFUL_RTOL * jstats["useful_segments"]
    assert_images_close(got.numpy(), np.asarray(want),
                        msg=f"scene {idx} port vs jax")


def _nonzero_deposit(fb, pend, pixel, Lsum, inv_spp):
    """The deposit before the span was captured: only the depositing lanes,
    selected on the host."""
    lanes = pend.nonzero().squeeze(1)
    fb.index_add_(0, pixel[lanes], Lsum.to_rows()[lanes] * inv_spp)


@pytest.mark.parametrize("P,per,frac", [(64, 5, 0.5), (1024, 37, 0.3),
                                        (4096, 1000, 0.9), (300, 1, 1.0),
                                        (256, 64, 0.0)])
def test_fixed_shape_deposit_equals_nonzero(P, per, frac):
    """One index_add_ over every lane, the non-depositing ones into their
    own drop rows, gives the image rows bit for bit what the depositing
    lanes alone give, with many lanes on one pixel, and leaves the image
    rows' earlier sums in place."""
    g = np.random.RandomState(P + per)
    pend = torch.from_numpy(g.uniform(size=P) < frac)
    pixel = torch.from_numpy(g.randint(0, per, P).astype(np.int64))
    Lsum = V3(*(torch.from_numpy(g.standard_exponential(P)
                                 .astype(np.float32) * 3) for _ in range(3)))
    start = torch.from_numpy(g.uniform(0, 2, (per, 3)).astype(np.float32))
    inv_spp = float(np.float32(1.0 / 9))
    want = start.clone()
    _nonzero_deposit(want, pend, pixel, Lsum, inv_spp)
    fbx = torch.zeros((per + P, 3), dtype=torch.float32)
    fbx[:per] = start
    twf._deposit(fbx, pend, pixel, Lsum, inv_spp,
                 torch.arange(per, per + P))
    assert torch.equal(fbx[:per].view(torch.int32), want.view(torch.int32))
    if frac == 0.0:
        assert torch.equal(fbx[:per], start)


def test_layer_range_resume_bit_equal():
    """Layer-aligned spans resumed through ``fb`` give the uninterrupted
    render's bits, over spans cut short by ``max_paths_per_call``."""
    world, cam = tsc.build_scene(6)
    data, meta = world.compile()
    cam = cam.replace(image_width=24, image_height=24, sqrt_spp=4,
                      bounce_limit=6)
    kw = dict(seed=SEED, pool=1024, window=2, spt=4, scrub_nan=False,
              max_paths_per_call=1600)
    full = twf.render_wavefront(data, meta, cam, "cpu", layer_range=(0, 4),
                                **kw)
    part = twf.render_wavefront(data, meta, cam, "cpu", layer_range=(0, 1),
                                **kw)
    resumed = twf.render_wavefront(data, meta, cam, "cpu", fb=part,
                                   layer_range=(1, 4), **kw)
    assert torch.equal(resumed.view(torch.int32), full.view(torch.int32))


class HostRead(AssertionError):
    pass


# aten ops that read a tensor on the host, make a tensor from host data, or
# pick their output's shape from the data: each is a sync or a pageable copy
# on a card, which a CUDA graph capture refuses
_HOST_OPS = {"_local_scalar_dense", "lift_fresh", "lift_fresh_copy",
             "nonzero", "masked_select", "_unique", "_unique2",
             "unique_dim", "unique_consecutive", "item"}
_BOOL_INDEX_OPS = {"index", "index_put", "index_put_", "_index_put_impl_"}
_HOST_METHODS = {torch.Tensor.tolist, torch.Tensor.numpy, torch.Tensor.cpu,
                 torch.Tensor.item, torch.Tensor.__bool__,
                 torch.Tensor.__int__, torch.Tensor.__float__,
                 torch.Tensor.__index__}


class _NoHostDispatch(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if name in _HOST_OPS:
            raise HostRead(f"{func} in a round")
        if name in _BOOL_INDEX_OPS:
            for ix in args[1] if len(args) > 1 else ():
                if isinstance(ix, torch.Tensor) and ix.dtype in (
                        torch.bool, torch.uint8):
                    raise HostRead(f"{func} with a mask in a round")
        if name in ("_to_copy", "copy_"):
            devs = {a.device for a in args if isinstance(a, torch.Tensor)}
            if "device" in kwargs:
                devs.add(torch.device(kwargs["device"]))
            if len(devs) > 1:
                raise HostRead(f"{func} across devices in a round")
        return func(*args, **kwargs)


class _NoHostFunction(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in _HOST_METHODS or func in (torch.tensor, torch.as_tensor,
                                             torch.from_numpy):
            raise HostRead(f"{getattr(func, '__name__', func)} in a round")
        return func(*args, **(kwargs or {}))


def _no_host_reads(fn):
    with _NoHostFunction(), _NoHostDispatch():
        fn()


@pytest.mark.parametrize("snippet", [
    lambda x: x.nonzero(), lambda x: bool(x.any()), lambda x: x[x > 1],
    lambda x: torch.tensor(255.0), lambda x: int(x.sum()),
    lambda x: x.tolist(), lambda x: torch.as_tensor(3)])
def test_host_read_detector_catches(snippet):
    """The detector below is not vacuous: each of these raises in it."""
    x = torch.arange(6)
    with pytest.raises(HostRead):
        _no_host_reads(lambda: snippet(x))


def _span_round(idx, task_end):
    """The round of a kept key (``_make_round`` over static clones of the
    call's operands) and its state, filled for the span [0, task_end)."""
    world, cam = tsc.build_scene(idx)
    data, meta = world.compile()
    cam = _small(cam)
    if idx == 1:
        cam = cam.replace(defocus_angle=torch.tensor(0.6))
    WH = cam.image_width * cam.image_height
    fb = torch.zeros((WH, 3))
    ops = cloned(twf.span_operands(data, meta, cam, "none"))
    round_, state = twf._make_round(
        ops, meta, pool=256, window=2, spt=4, use_kernel=False,
        no_defocus=bool(cam.defocus_angle <= 0), per=WH, n_shards=1,
        shard_id=0)
    _no_host_reads(lambda: twf._start_span(state, fb, SEED, 0, task_end))
    return round_, state


@pytest.mark.parametrize("idx", [1, 6, 9])
def test_round_makes_no_host_read(idx):
    """After the first (eager) round, a round of a kept key reads nothing
    on the host, makes no tensor from host data and picks no shape from
    the data: all a capture needs.  The seed and the span's end are int64
    device scalars, filled (with the rest of the span's start) without a
    host read.  Scene 1 with a defocus (its lens draws), scene 6 (quads, a
    light), scene 9 (media, image and noise textures)."""
    round_, state = _span_round(idx, task_end=2000)
    for name in ("seed", "total"):
        assert state[name].dtype == torch.int64 and state[name].dim() == 0
    assert int(state["seed"]) == SEED and int(state["total"]) == 2000
    round_()
    for _ in range(2):
        _no_host_reads(round_)
    assert int(state["useful"]) > 0 and bool(state["go"])


def _counted(fn):
    """``fn()`` and the spans' graph counts it added."""
    before = dict(twf.graph_count)
    res = fn()
    return res, {k: twf.graph_count[k] - before[k] for k in before}


def _eager(monkeypatch, fn):
    """``fn()`` with every span on the eager route (``_span_core``'s
    private ``eager``)."""
    with monkeypatch.context() as m:
        m.setattr(twf, "_span_core",
                  functools.partial(twf._span_core, eager=True))
        return fn()


def _same(a, b):
    """Bit-equal float32 tensors (raw int32 views, NaNs included)."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_graph_route_loop_with_a_stand_in_capture(stand_in, monkeypatch):
    """The graph route's loop on the CPU, with a stand-in for the capture
    whose replay runs the round: the key's first round eager, one capture
    a key (not a span), every later round of every span a replay, and the
    image, rounds and useful segments of the eager route bit for bit, over
    spans cut short by ``max_paths_per_call``."""
    world, cam = tsc.build_scene(7)
    data, meta = world.compile()
    cam = cam.replace(image_width=20, image_height=20, sqrt_spp=3,
                      bounce_limit=5)
    kw = dict(seed=SEED, pool=1024, window=2, spt=4,
              max_paths_per_call=2400, return_stats=True)

    def render():
        return twf.render_wavefront(data, meta, cam, "cpu", **kw)
    want, want_stats = _eager(monkeypatch, render)
    (got, stats), moved = _counted(render)
    assert _same(got, want)
    assert stats == want_stats
    assert moved["spans"] > 1
    assert moved["captures"] == len(stand_in.bodies) == 1
    assert moved["replays"] == moved["rounds"] - 1 > 0
    assert moved["recaptures"] == 0


def _scene1(width=24, sqrt_spp=2):
    """Scene 1 (spheres, a defocus, moving spheres) small, depth 5."""
    world, cam = tsc.build_scene(1)
    data, meta = world.compile()
    h = max(1, int(width * cam.image_height / cam.image_width))
    cam = cam.replace(image_width=width, image_height=h, sqrt_spp=sqrt_spp,
                      bounce_limit=5)
    return data, meta, cam


def test_kept_key_takes_each_calls_values(stand_in, monkeypatch):
    """Two calls of one key with the seed, the task range, ``fb``, the
    camera's ``lookfrom`` (its static fields the same) and one sphere's
    centre changed between them: each call gives the eager route's bits
    and stats, from one capture over both calls; the second call runs no
    eager round (every round a replay) and keeps the key."""
    data, meta, cam = _scene1()
    WH = cam.image_width * cam.image_height
    g = np.random.RandomState(3)
    centre = data.sph_center.clone()
    centre[3] += torch.tensor([0.05, -0.1, 0.2])
    calls = [
        dict(data=data, cam=cam, seed=SEED, task_range=None, fb=None),
        dict(data=dataclasses.replace(data, sph_center=centre),
             cam=cam.replace(lookfrom=cam.lookfrom + torch.tensor(
                 [0.3, -0.2, 0.1])),
             seed=SEED + 1, task_range=(37, 37 + 3 * WH // 2),
             fb=g.uniform(0, 1, (WH, 3)).astype(np.float32))]
    captured = 0
    for k, c in enumerate(calls):
        def render(c=c):
            return twf.render_wavefront(
                c["data"], meta, c["cam"], "cpu", seed=c["seed"],
                task_range=c["task_range"], fb=c["fb"], pool=256, window=2,
                spt=2, max_paths_per_call=600, scrub_nan=False,
                return_stats=True)
        want, want_stats = _eager(monkeypatch, render)
        (got, stats), moved = _counted(render)
        assert _same(got, want), f"call {k}"
        assert stats == want_stats, f"call {k}"
        assert moved["spans"] > 1 and moved["recaptures"] == 0
        captured += moved["captures"]
        if k:
            assert moved["captures"] == 0
            assert moved["replays"] == moved["rounds"] > 0
    assert captured == len(stand_in.bodies) == 1


@pytest.mark.parametrize("sharded", [False, True])
def test_layer_aligned_call_captures_once(stand_in, monkeypatch, sharded):
    """A layer-aligned call of four spans (or the same through a one-CPU
    mesh, whose spans are always layer-aligned) captures once and replays
    every round after its first; a second call of the key, at another
    seed, captures nothing.  Both give the eager route's bits."""
    from mort_tpu_torch.parallel.sharding import make_mesh

    data, meta, cam = _scene1(sqrt_spp=2)
    kw = (dict(mesh=make_mesh(1, devices=["cpu"])) if sharded
          else dict(layer_range=(0, 4)))
    for k, seed in enumerate((SEED, SEED + 7)):
        def render(seed=seed):
            return twf.render_wavefront(data, meta, cam, "cpu", seed=seed,
                                        pool=1024, window=2, spt=1,
                                        return_stats=True, **kw)
        want, want_stats = _eager(monkeypatch, render)
        (got, stats), moved = _counted(render)
        assert _same(got, want) and stats == want_stats
        assert moved["spans"] == 4 and moved["recaptures"] == 0
        assert moved["captures"] == (1, 0)[k]
        assert moved["replays"] == moved["rounds"] - (1, 0)[k] > 0


def test_stand_in_progressive_resume_bit_equal(stand_in, monkeypatch,
                                               tmp_path):
    """``render_progressive_wavefront`` on the stand-in graph route: one
    capture over every layer of every step and call; interrupted after a
    step, checkpointed and resumed, the framebuffer is the uninterrupted
    render's, which is the eager route's, bit for bit."""
    from mort_tpu_torch.render.progressive import (
        load_state, render_progressive_wavefront,
    )

    world, cam = tsc.build_scene(6)
    data, meta = world.compile()
    cam = cam.replace(image_width=24, image_height=24, sqrt_spp=3,
                      bounce_limit=6)
    kw = dict(seed=SEED, spt=3, pool=1024, window=2, device="cpu")

    def full():
        return render_progressive_wavefront(data, meta, cam, **kw).fb

    class Interrupted(BaseException):
        pass

    def stop(state):
        raise Interrupted

    want = _eager(monkeypatch, full)
    got, moved = _counted(full)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert moved["captures"] == 1 and moved["spans"] == 3
    ckpt = str(tmp_path / "prog.npz")
    with pytest.raises(Interrupted):
        render_progressive_wavefront(data, meta, cam, checkpoint_path=ckpt,
                                     on_step=stop, **kw)
    resumed, moved = _counted(lambda: render_progressive_wavefront(
        data, meta, cam, state=load_state(ckpt), **kw).fb)
    assert np.array_equal(resumed.view(np.int32), want.view(np.int32))
    assert moved["captures"] == 0 and moved["replays"] == moved["rounds"]
    assert len(stand_in.bodies) == 1
