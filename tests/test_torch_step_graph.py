"""The train step as one captured device program: what the CPU can hold.

On a card ``make_train_step`` runs the first step of a graph key eagerly,
captures the step (forward, loss, ``torch.autograd.grad``) into a CUDA
graph and replays it for every later step (the counterpart of the JAX
package's ``jax.jit`` at mort_tpu/parallel/sharding.py:164).  The capture
itself needs the card (``test_torch_cuda.py`` holds the graph route against
the eager route there); on the CPU these tests hold what the capture rests
on:

- the step body makes no host read and no tensor from host data on its
  static operands, which a capture would refuse, on the kernel route
  (the closest-hit Function; its plain versions, which are kernels on a
  card, exempt by name) and on the ``intersect_best`` route;
- the graph route's call loop with a stand-in for the capture whose replay
  runs the body: one capture a key, a replay for every later call, a
  recapture for a new key only, the eager route's results bit for bit,
  fresh results;
- the stand-in graph route against the JAX package's step.
"""

import contextlib
import dataclasses
import weakref

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _disable_current_modes

from test_torch_span_graph import HostRead, _no_host_reads

from mort_tpu.parallel.sharding import (
    make_mesh, make_train_step as j_make_train_step,
)
from mort_tpu.render.renderer import render as j_render
from mort_tpu.scene import scenes as jsc
from mort_tpu_torch.camera import camera_from_numpy
from mort_tpu_torch.parallel import sharding
from mort_tpu_torch.parallel.sharding import _DIFF_FIELDS, make_train_step
from mort_tpu_torch.render import closest_hit as ch
from mort_tpu_torch.scene import scenes as tsc
from mort_tpu_torch.scene.build import scene_from_numpy

SEED = 11


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@pytest.fixture(scope="module")
def cornell():
    """test_torch_train_step.py's Cornell box (12x12, 4 spp, depth 6) in
    both packages, and its target: the JAX package's image times 0.9."""
    jworld, jcam = jsc.cornell_box()
    jdata, jmeta = jworld.compile()
    jcam = jcam.replace(image_width=12, image_height=12, sqrt_spp=2,
                        bounce_limit=6)
    target = np.asarray(j_render(jdata, jmeta, jcam)) * 0.9
    data, meta = scene_from_numpy(_fields(jdata), _fields(jmeta))
    return (jdata, jmeta, jcam), (data, meta, camera_from_numpy(
        _fields(jcam))), target


def _scene(idx):
    """Scene 1 at 48 px with a defocus, or scene 9 at 48 px, depth 4, both
    at 4 spp; a target of 0.5 grey."""
    world, cam = tsc.build_scene(idx)
    data, meta = world.compile()
    h = max(1, int(48 * cam.image_height / cam.image_width))
    cam = cam.replace(image_width=48, image_height=h, sqrt_spp=2,
                      bounce_limit=6 if idx == 1 else 4)
    if idx == 1:
        cam = cam.replace(defocus_angle=torch.tensor(0.6))
    return data, meta, cam, np.full((h, 48, 3), 0.5, np.float32)


class _Graph:
    def reset(self):
        pass


class _StandIn:
    """What ``render.graphs.capture`` returns, without a card: the capture
    records nothing and keeps the body (``bodies``) and a weak reference to
    the graph (``graphs``), and each replay runs the body."""

    def __init__(self):
        self.bodies = []
        self.graphs = []

    def __call__(self, fn, dev):
        counts = sharding.step_graph_count
        counts["captures"] += 1
        self.bodies.append(fn)
        graph = _Graph()
        self.graphs.append(weakref.ref(graph))

        def replay():
            fn()
            counts["replays"] += 1
        return graph, replay


@pytest.fixture
def stand_in(monkeypatch):
    """The graph route on the CPU: ``_graph_route`` true unless eager, the
    capture the stand-in."""
    capture = _StandIn()
    monkeypatch.setattr(sharding, "_graph_route", lambda dev, eager: not eager)
    monkeypatch.setattr(sharding, "_capture", capture)
    return capture


@contextlib.contextmanager
def _host_reads_allowed():
    with _disable_current_modes(), torch._C.DisableTorchFunction():
        yield


def _kernel_exempt(monkeypatch):
    """On a card the closest hit and its backward are kernels; their plain
    versions pick shapes from the data (``nonzero``), so exactly these two
    calls run outside the detector."""
    for name in ("closest_hit_reference", "closest_hit_bwd_reference"):
        plain = getattr(ch, name)

        def exempt(*args, _plain=plain, **kw):
            with _host_reads_allowed():
                return _plain(*args, **kw)
        monkeypatch.setattr(ch, name, exempt)


def _delta(before):
    return {k: sharding.step_graph_count[k] - before[k] for k in before}


def _assert_same(got, want, msg=""):
    (g_loss, g_grads), (w_loss, w_grads) = got, want
    assert torch.equal(g_loss.view(torch.int32), w_loss.view(torch.int32)), \
        msg
    assert set(g_grads) == set(w_grads) == set(_DIFF_FIELDS)
    for k in _DIFF_FIELDS:
        assert torch.equal(g_grads[k].view(torch.int32),
                           w_grads[k].view(torch.int32)), f"{msg} {k}"


@pytest.mark.parametrize("case,use_kernel", [
    ("cornell", True), ("cornell", False), ("scene1", True),
    ("scene1", False), ("scene9", True), ("scene9", False)])
def test_step_body_makes_no_host_read(case, use_kernel, cornell, stand_in,
                                      monkeypatch):
    """The replayed body (forward, loss, ``torch.autograd.grad``) reads
    nothing on the host and makes no tensor from host data, on the kernel
    route and on the ``intersect_best`` route, on the Cornell box (quads,
    axis-aligned and boxed), scene 1 with a defocus (its lens draws) and
    scene 9 (media, image and noise textures, "none"'s box and aaq
    tables)."""
    if case == "cornell":
        _j, (data, meta, cam), target = cornell
    else:
        data, meta, cam, target = _scene(1 if case == "scene1" else 9)
    _kernel_exempt(monkeypatch)
    step = make_train_step(meta, device="cpu", use_kernel=use_kernel)
    step(data, cam, target, SEED)            # eager, then the capture
    assert len(stand_in.bodies) == 1
    _no_host_reads(stand_in.bodies[0])
    loss, grads = step(data, cam, target, SEED + 1)      # a replay
    assert len(stand_in.bodies) == 1
    assert bool(torch.isfinite(loss))
    if case != "scene9":      # final_scene's gradients hold NaN (ROADMAP C4)
        assert all(bool(torch.isfinite(g).all()) for g in grads.values())


@pytest.mark.parametrize("name", ["closest_hit_reference",
                                  "closest_hit_bwd_reference"])
def test_exemption_is_not_vacuous(name, cornell, stand_in, monkeypatch):
    """Under the exemption of the two plain versions, a ``nonzero`` just
    outside one of them still raises in the replayed body: in the forward
    and in the backward, which autograd runs inside the detector too."""
    _j, (data, meta, cam), target = cornell
    _kernel_exempt(monkeypatch)
    step = make_train_step(meta, device="cpu", use_kernel=True)
    step(data, cam, target, SEED)
    _no_host_reads(stand_in.bodies[0])
    exempt = getattr(ch, name)

    def with_a_host_read(*args, **kw):
        rays = next(a for a in args if isinstance(a, torch.Tensor))
        rays.reshape(-1).nonzero()
        return exempt(*args, **kw)

    monkeypatch.setattr(ch, name, with_a_host_read)
    with pytest.raises(HostRead):
        _no_host_reads(stand_in.bodies[0])


def test_graph_route_call_loop(cornell, stand_in):
    """The graph route's calls with the stand-in capture, each against the
    eager route (``_eager=True``) on the same operands, bit for bit: the
    first call runs eagerly and captures; a new seed, or a new ``data`` or
    ``cam`` object of the same key, replays with no recapture; a new
    ``image_width``, ``sqrt_spp`` or ``bounce_limit``, or an axis-aligned
    quad moved off its axes, captures once more; a step's results stay as
    they were after the next step (they are not the graph's outputs)."""
    _j, (data, meta, cam), target = cornell
    step = make_train_step(meta, device="cpu", use_kernel=True)
    eager = make_train_step(meta, device="cpu", use_kernel=True,
                            _eager=True)
    kept = []

    def call(d, c, t, seed, captures, replays, msg):
        before = dict(sharding.step_graph_count)
        got = step(d, c, t, seed)
        moved = _delta(before)
        assert moved["steps"] == 1, msg
        assert (moved["captures"], moved["replays"]) == (captures,
                                                         replays), msg
        assert moved["recaptures"] == (captures if kept else 0), msg
        _assert_same(got, eager(d, c, t, seed), msg)
        for k, (res, copy) in enumerate(kept):
            _assert_same(res, copy, f"step {k} after {msg}")
        kept.append((got, (got[0].clone(), {k: g.clone()
                                            for k, g in got[1].items()})))

    call(data, cam, target, SEED, 1, 0, "the first call")
    call(data, cam, target, SEED + 1, 0, 1, "a new seed")
    call(data.replace(), cam, target, SEED + 1, 0, 1, "a new data object")
    call(data.replace(tex_color=data.tex_color * 0.9), cam, target, SEED,
         0, 1, "new scene values")
    call(data, cam.replace(lookfrom=cam.lookfrom + 0.05), target, SEED, 0, 1,
         "new camera values")
    call(data, cam, target * 0.5, SEED, 0, 1, "a new target")
    for name, c, t in (
            ("image_width", cam.replace(image_width=10), target[:, :10]),
            ("sqrt_spp", cam.replace(sqrt_spp=1), target),
            ("bounce_limit", cam.replace(bounce_limit=4), target)):
        call(data, c, t, SEED, 1, 0, f"a new {name}")
        call(data, c, t, SEED + 2, 0, 1, f"a new {name}, again")
    # the normal's axis of the first axis-aligned quad: u tilts off its axis
    groups = ch.aaq_groups_of(meta)
    cls = sorted(groups)[0]
    row = groups[cls][0]
    u = data.quad_u.clone()
    u[row, 3 - cls // 3 - cls % 3] += 1e-3
    off = data.replace(quad_u=u)
    call(off, cam, target, SEED, 1, 0, "a quad off its axes")
    assert step.prep_cache["val"][4] == (row,)
    call(off, cam, target, SEED + 3, 0, 1, "a quad off its axes, again")
    assert len(stand_in.bodies) == 5


def test_stand_in_graph_route_matches_jax(cornell, stand_in):
    """The stand-in graph route's step (a replay) against the JAX package's
    ``make_train_step(meta, make_mesh(1))``, by test_torch_train_step.py's
    tolerances; both on their default CPU route (the XLA intersector in
    JAX, ``intersect_best`` in the port)."""
    (jdata, jmeta, jcam), (data, meta, cam), target = cornell
    step = make_train_step(meta, device="cpu")
    step(data, cam, target, SEED + 5)
    before = dict(sharding.step_graph_count)
    loss, grads = step(data, cam, target, SEED)
    assert _delta(before)["replays"] == 1
    j_loss, j_grads = j_make_train_step(jmeta, make_mesh(1))(
        jdata, jcam, target, SEED)
    j_grads = {k: np.asarray(v) for k, v in j_grads.items()}
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-4)
    scale = max(np.abs(g).max() for g in j_grads.values())
    assert scale > 0
    for k in _DIFF_FIELDS:
        np.testing.assert_allclose(grads[k].numpy(), j_grads[k], rtol=1e-3,
                                   atol=1e-5 * scale, err_msg=k)


def test_step_is_freed_when_dropped(cornell, stand_in):
    """A step function lives in no reference cycle: dropping the last
    reference frees it, and its graph, at once.  In a cycle it would wait
    for the cyclic collector, which may run in the middle of another
    capture, where destroying a graph invalidates that capture."""
    _j, (data, meta, cam), target = cornell
    step = make_train_step(meta, device="cpu", use_kernel=True)
    step(data, cam, target, SEED)
    ref = weakref.ref(step)
    assert stand_in.graphs[0]() is not None
    del step
    assert ref() is None
    assert stand_in.graphs[0]() is None
