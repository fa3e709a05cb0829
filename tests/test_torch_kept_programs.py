"""What the port's three captured device programs share, on the CPU.

The wavefront round (``wavefront._span_core``), the lockstep units
(``renderer.radiance_batches``: ``render``, ``render_progressive``,
``render_sharded``) and the train step (``make_train_step``) are each a
``render.graphs.KeptProgram``: kept by graph key, every call copied into
its statics, each unit eager on its key's first run and captured after
it, replayed after that, the key dropped on a failure.  Each property
below is one test with a case a program, on the stand-in capture
(``stand_in_capture``) whose replay runs the unit:

- the CPU never captures;
- a new key captures anew and counts a recapture, the same key again
  replays, every call bit-equal to the eager route;
- a result stays as it was after the next call;
- a leaf of the scene updated in place between two calls is read;
- a failed capture or replay, or a replay's fault at the next read,
  drops the key: the next call builds and captures anew, and the old
  graphs are reset;
- the stand-in graph route against the JAX package.
"""

import contextlib
import dataclasses
import functools

import numpy as np
import pytest
import torch

from conftest import assert_images_close
from stand_in_capture import Planted, stand_in  # noqa: F401
from test_torch_step_graph import cornell  # noqa: F401  (a fixture)

from mort_tpu.parallel.sharding import (
    make_mesh as j_make_mesh, make_train_step as j_make_train_step,
    render_sharded as j_render_sharded,
)
from mort_tpu.render import wavefront as jwf
from mort_tpu.render.progressive import (
    render_progressive as j_render_progressive,
)
from mort_tpu.render.renderer import render as j_render
from mort_tpu.scene import scenes as jsc
from mort_tpu_torch.camera import camera_from_numpy
from mort_tpu_torch.parallel import sharding
from mort_tpu_torch.parallel.sharding import (
    _DIFF_FIELDS, make_mesh, make_train_step, render_sharded,
)
from mort_tpu_torch.render import closest_hit as ch
from mort_tpu_torch.render import graphs, integrator
from mort_tpu_torch.render import wavefront as twf
from mort_tpu_torch.render.progressive import render_progressive
from mort_tpu_torch.render.renderer import radiance_batches, render
from mort_tpu_torch.scene import scenes as tsc
from mort_tpu_torch.scene.build import scene_from_numpy

SEED = 11
PROGRAMS = ("wavefront", "lockstep", "step")
COUNTS = {"wavefront": twf.graph_count,
          "lockstep": integrator.lockstep_graph_count,
          "step": sharding.step_graph_count}
# units a key captures: "round"; "start" and "bounce"; "step"
UNITS = {"wavefront": 1, "lockstep": 2, "step": 1}


def _moved(counts, fn):
    """``fn()`` and what it added to ``counts``."""
    before = dict(counts)
    out = fn()
    return out, {k: counts[k] - before[k] for k in before}


def _same(got, want):
    """Bit-equal lists of tensors (float32 compared as raw int32, NaNs
    included)."""
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        if a.shape != b.shape or not torch.equal(a, b):
            return False
    return True


def _cornell():
    """The Cornell box at 12x12, 4 spp, depth 6 (quads, axis-aligned and
    boxed, a light), its quad rows its own tensors."""
    world, cam = tsc.cornell_box()
    data, meta = world.compile()
    cam = cam.replace(image_width=12, image_height=12, sqrt_spp=2,
                      bounce_limit=6)
    return data.replace(quad_Q=data.quad_Q.clone()), meta, cam


def _scene1(width=24, sqrt_spp=2):
    """Scene 1 (spheres, a defocus, moving spheres) small, depth 5."""
    world, cam = tsc.build_scene(1)
    data, meta = world.compile()
    h = max(1, int(width * cam.image_height / cam.image_width))
    cam = cam.replace(image_width=width, image_height=h, sqrt_spp=sqrt_spp,
                      bounce_limit=5)
    return data, meta, cam


def _target(cam, grey=0.45):
    return np.full((cam.image_height, cam.image_width, 3), grey, np.float32)


def _stats(stats):
    return torch.tensor([stats["iterations"], stats["useful_segments"],
                         stats["slots_executed"]])


def _caller(program, meta):
    """A function of (data, cam, seed, eager, **kw) that calls ``program``
    on the CPU and returns its result as a list of tensors: the
    wavefront's image and stats, the lockstep ``render``'s image, the
    train step's loss and gradients (``kw`` goes to ``render_wavefront``
    or ``render``; the step's ``target`` defaults to a grey one, one
    object an image size)."""
    if program == "wavefront":
        def call(data, cam, seed, eager, **kw):
            kw = {"pool": 1024, "window": 2, "spt": 2, **kw}
            with _eager_spans(eager):
                img, stats = twf.render_wavefront(
                    data, meta, cam, "cpu", seed=seed, return_stats=True,
                    **kw)
            return [img, _stats(stats)]
    elif program == "lockstep":
        def call(data, cam, seed, eager, **kw):
            kw = {"ray_batch": 50, "use_kernel": True, **kw}
            return [render(data, meta, cam, seed, device="cpu",
                           _eager=eager, **kw)]
    else:
        # one step function a route, one target an image size: a train
        # loop passes the same objects every step
        steps = {eager: make_train_step(meta, device="cpu", use_kernel=True,
                                        _eager=eager)
                 for eager in (False, True)}
        targets = {}

        def call(data, cam, seed, eager, target=None):
            if target is None:
                size = (cam.image_width, cam.image_height)
                target = targets.setdefault(size, _target(cam))
            loss, grads = steps[eager](data, cam, target, seed)
            return [loss] + [grads[k] for k in _DIFF_FIELDS]
    return call


@contextlib.contextmanager
def _eager_spans(eager):
    """Every wavefront span on the eager route (``_span_core``'s private
    ``eager``) while ``eager``."""
    real = twf._span_core
    if eager:
        twf._span_core = functools.partial(real, eager=True)
    try:
        yield
    finally:
        twf._span_core = real


def _scene(program):
    """Each program's scene: scene 1 for the wavefront, the Cornell box for
    the lockstep and the step."""
    return _scene1() if program == "wavefront" else _cornell()


# ---------------------------------------------------------------------------
# the CPU never captures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("program", PROGRAMS)
def test_cpu_route_never_captures(program, monkeypatch):
    """The CPU runs every unit eagerly: no capture and no replay.  The
    wavefront reads the loop condition once a round (and the last one)
    and the useful count once a span; the lockstep reads ``alive.any()``
    once a bounce run and once more where a sample's lanes all ended
    before the depth; the step counts its steps."""

    def refuse(fn, dev, counts):
        raise AssertionError("the CPU captured")

    monkeypatch.setattr(graphs, "capture", refuse)
    counts = COUNTS[program]
    if program == "wavefront":
        world, cam = tsc.build_scene(5)
        data, meta = world.compile()
        cam = cam.replace(image_width=16, image_height=16, sqrt_spp=2,
                          bounce_limit=3)
        (_, stats), moved = _moved(counts, lambda: twf.render_wavefront(
            data, meta, cam, "cpu", seed=SEED, pool=1024, spt=1,
            layer_range=(0, 4), return_stats=True))
        assert moved["spans"] == 4
        assert moved["rounds"] == stats["iterations"]
        assert moved["syncs"] == stats["iterations"] + 2 * moved["spans"]
    elif program == "lockstep":
        data, meta, cam = _cornell()
        _, moved = _moved(counts, lambda: render(data, meta, cam, SEED,
                                                 device="cpu"))
        assert 0 < moved["bounces"] <= moved["syncs"]
        assert moved["syncs"] <= moved["bounces"] + cam.sqrt_spp ** 2
    else:
        data, meta, cam = _cornell()
        call = _caller(program, meta)
        _, moved = _moved(counts, lambda: [call(data, cam, SEED + k, False)
                                           for k in range(2)])
        assert moved["steps"] == 2
    assert moved["captures"] == moved["replays"] == 0
    assert moved["recaptures"] == 0 and moved["capture_s"] == 0.0


# ---------------------------------------------------------------------------
# a new key recaptures
# ---------------------------------------------------------------------------

def _quad_off_axis(data, meta):
    """``data`` with its first axis-aligned quad's u tilted off its axis,
    and that quad's row."""
    groups = ch.aaq_groups_of(meta)
    cls = sorted(groups)[0]
    row = groups[cls][0]
    u = data.quad_u.clone()
    u[row, 3 - cls // 3 - cls % 3] += 1e-3
    return data.replace(quad_u=u), row


def _wavefront_calls(field):
    """A change of one field of the wavefront's key (the pool, the chunk
    size, the accel mode): the base, the change and the change again."""
    data, meta, cam = _scene1()
    other = {"pool": 2048, "spt": 4, "accel": "bvh"}[field]
    base = {"pool": 1024, "spt": 2, "accel": "none"}
    changed = dict(base, **{field: other})
    return meta, [
        ("the base", lambda: (data, cam, SEED, base), 1),
        (f"a new {field}", lambda: (data, cam, SEED, changed), 1),
        (f"a new {field}, again", lambda: (data, cam, SEED, changed), 0)]


def _lockstep_calls():
    """``render``'s calls: a new seed, a new ``data`` object, new scene
    values of the same shapes, the same tensors changed in place and new
    camera values replay (each from the new values, not stale tables: the
    new scene values and the in-place change give another image than the
    first call's); a new ``image_width``, ``ray_batch`` or route, or an
    axis-aligned quad moved off its axes, captures both units once
    more."""
    data, meta, cam = _cornell()
    off, _ = _quad_off_axis(data, meta)
    batch64 = {"ray_batch": 64}

    def in_place():
        data.quad_Q.add_(0.05)
        return data, cam, SEED, {}
    return meta, [
        ("the first call", lambda: (data, cam, SEED, {}), 1),
        ("a new seed", lambda: (data, cam, SEED + 1, {}), 0),
        ("a new data object", lambda: (data.replace(), cam, SEED, {}), 0),
        ("new scene values", lambda: (data.replace(
            tex_color=data.tex_color * 0.7), cam, SEED, {}), 0, "differs"),
        ("the tensors changed in place", in_place, 0, "differs"),
        ("new camera values", lambda: (data, cam.replace(
            lookfrom=cam.lookfrom + 0.5), SEED, {}), 0),
        ("a new image_width", lambda: (data, cam.replace(image_width=10),
                                       SEED, {}), 1),
        ("the image_width back", lambda: (data, cam, SEED, {}), 1),
        ("a new ray_batch", lambda: (data, cam, SEED, batch64), 1),
        ("a quad off its axes", lambda: (off, cam, SEED, batch64), 1),
        ("a quad off its axes, again", lambda: (off, cam, SEED + 2,
                                                batch64), 0),
        ("the intersect_best route", lambda: (off, cam, SEED, dict(
            batch64, use_kernel=False)), 1)]


def _step_calls():
    """The train step's calls: a new seed, a new ``data`` or ``cam`` object
    of the same key, new scene or camera values, a new target of the same
    size replay; a new
    ``image_width``, ``sqrt_spp`` or ``bounce_limit``, or an axis-aligned
    quad moved off its axes, captures once more."""
    data, meta, cam = _cornell()
    off, _ = _quad_off_axis(data, meta)
    calls = [
        ("the first call", lambda: (data, cam, SEED, {}), 1),
        ("a new seed", lambda: (data, cam, SEED + 1, {}), 0),
        ("a new data object", lambda: (data.replace(), cam, SEED + 1, {}),
         0),
        ("new scene values", lambda: (data.replace(
            tex_color=data.tex_color * 0.9), cam, SEED, {}), 0),
        ("new camera values", lambda: (data, cam.replace(
            lookfrom=cam.lookfrom + 0.05), SEED, {}), 0),
        ("a new target", lambda: (data, cam, SEED, {
            "target": _target(cam, 0.45 * 0.5)}), 0, "differs")]
    for name, c in (("image_width", cam.replace(image_width=10)),
                    ("sqrt_spp", cam.replace(sqrt_spp=1)),
                    ("bounce_limit", cam.replace(bounce_limit=4))):
        calls += [(f"a new {name}", lambda c=c: (data, c, SEED, {}), 1),
                  (f"a new {name}, again", lambda c=c: (data, c, SEED + 2,
                                                        {}), 0)]
    calls += [("a quad off its axes", lambda: (off, cam, SEED, {}), 1),
              ("a quad off its axes, again", lambda: (off, cam, SEED + 3,
                                                      {}), 0)]
    return meta, calls


@pytest.mark.parametrize("case", ["wavefront-pool", "wavefront-spt",
                                  "wavefront-accel", "lockstep", "step"])
def test_new_key_recaptures(case, stand_in):
    """A sequence of calls of one program on the stand-in graph route,
    each bit-equal to the eager route on the same operands: a call that
    changes a field of the key drops the kept program, captures every
    unit anew and counts a recapture; a call of the kept key replays and
    captures nothing.  Replays: the wavefront's every round but a
    capturing call's first, the lockstep's some on every call (a bounce
    after "start" was captured), the step's one on each call that does not
    capture and none on one that does.  Every earlier result stays as it
    was after each later call, across recaptures (which reset the graphs
    it came from)."""
    program, _, field = case.partition("-")
    meta, calls = (_wavefront_calls(field) if program == "wavefront"
                   else _lockstep_calls() if program == "lockstep"
                   else _step_calls())
    call = _caller(program, meta)
    units = UNITS[program]
    kept = []
    for k, (msg, args, captures, *differs) in enumerate(calls):
        data, cam, seed, kw = args()
        got, moved = _moved(COUNTS[program],
                            lambda: call(data, cam, seed, False, **kw))
        assert moved["captures"] == units * captures, msg
        assert moved["recaptures"] == (captures if k else 0), msg
        if program == "wavefront":
            assert moved["replays"] == moved["rounds"] - captures > 0, msg
        elif program == "lockstep":
            assert moved["replays"] > 0, msg
        else:
            assert moved["steps"] == 1, msg
            assert moved["replays"] == 1 - captures, msg
        assert _same(got, call(data, cam, seed, True, **kw)), msg
        for j, (res, copy) in enumerate(kept):
            assert _same(res, copy), f"call {j} after {msg}"
        if differs:
            assert not _same(got, kept[0][1]), msg
        kept.append((got, [t.clone() for t in got]))
    assert len(stand_in.bodies) == units * sum(c[2] for c in calls)


# ---------------------------------------------------------------------------
# results stay fresh; in-place updates are read
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("program", PROGRAMS)
def test_results_are_fresh(program, stand_in):
    """A replayed call's result is new tensors: the last call's result
    stays as it was after the next call."""
    data, meta, cam = _scene(program)
    if program == "lockstep":
        pix = torch.arange(144, dtype=torch.int64)

        def call(seed):
            return [radiance_batches(data, meta, cam, seed, pix, 50)]
    else:
        call = functools.partial(_caller(program, meta), data, cam,
                                 eager=False)
    call(SEED)
    first = call(SEED + 1)
    kept = [t.clone() for t in first]
    second, moved = _moved(COUNTS[program], lambda: call(SEED + 2))
    assert moved["replays"] > 0 and moved["captures"] == 0
    assert len(stand_in.bodies) == UNITS[program]
    assert _same(first, kept) and not _same(first, second)


@pytest.mark.parametrize("program", PROGRAMS)
def test_in_place_update_is_read(program, stand_in):
    """A leaf of the scene updated in place between two calls of one key
    (as ``torch.optim`` updates its parameters) gives the result of a call
    on fresh objects with the new values, bit for bit: the second call
    copies the caller's tensors into the statics, whatever their
    identity."""
    data, meta, cam = _scene(program)
    data = data.replace(tex_color=data.tex_color.clone(),
                        mat_albedo=data.mat_albedo.clone())
    call = _caller(program, meta)
    before = call(data, cam, SEED, False)
    data.tex_color.mul_(0.8)
    data.mat_albedo.mul_(0.9)
    got, moved = _moved(COUNTS[program],
                        lambda: call(data, cam, SEED, False))
    assert moved["captures"] == 0 and moved["replays"] > 0
    fresh = dataclasses.replace(data, tex_color=data.tex_color.clone(),
                                mat_albedo=data.mat_albedo.clone())
    want = call(fresh, cam.replace(), SEED, True)
    assert not _same(want, before)
    assert _same(got, want)


# ---------------------------------------------------------------------------
# a failure drops the key
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("program", PROGRAMS)
@pytest.mark.parametrize("phase", ["capture", "replay", "read"])
def test_failure_drops_the_key(program, phase, stand_in):
    """A capture or a replay that fails, or a device fault of a replay that
    surfaces at the caller's next read or copy of a tensor after it (the
    loop condition, ``alive.any()``, the step's result clones), raises out
    of the call and drops the key: the graphs captured before it are
    reset, and the next call of the same key builds anew (no recapture
    counted), runs every unit eagerly and captures it again, bit-equal to
    the eager route.  The lockstep's failed capture is its second unit's,
    "bounce", after "start" was captured."""
    data, meta, cam = _scene(program)
    call = _caller(program, meta)
    if phase != "capture":
        call(data, cam, SEED, False)
    stand_in.fail(phase, skip=int(program == "lockstep"
                                  and phase == "capture"))
    with pytest.raises(Planted), stand_in.reads():
        call(data, cam, SEED + 1, False)
    made = [ref() for ref in stand_in.graphs]
    assert all(g is None or g.resets == 1 for g in made)
    got, moved = _moved(COUNTS[program],
                        lambda: call(data, cam, SEED + 1, False))
    assert moved["captures"] == UNITS[program]
    assert moved["recaptures"] == 0
    assert _same(got, call(data, cam, SEED + 1, True))


# ---------------------------------------------------------------------------
# the stand-in graph route against the JAX package
# ---------------------------------------------------------------------------

def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@pytest.fixture(scope="module")
def three_spheres(three_sphere_scene):
    """conftest's three-sphere scene (32x18, 4 spp, a defocus) at depth 6 in
    both packages."""
    jdata, jmeta, jcam = three_sphere_scene
    jcam = jcam.replace(bounce_limit=6)
    data, meta = scene_from_numpy(_fields(jdata), _fields(jmeta))
    return (jdata, jmeta, jcam), (data, meta, camera_from_numpy(
        _fields(jcam)))


def _wavefront_matches_jax():
    """A render of several spans (one capture, replays for every later
    round) against the JAX package's ``render_wavefront`` at scene 1's
    golden width, depth 4, at the same pool, window and spt."""

    def small(cam):
        h = max(1, int(48 * cam.image_height / cam.image_width))
        return cam.replace(image_width=48, image_height=h, sqrt_spp=2,
                           bounce_limit=4)
    world, cam = tsc.build_scene(1)
    data, meta = world.compile()
    jworld, jcam = jsc.build_scene(1)
    jdata, jmeta = jworld.compile()
    kw = dict(seed=5, pool=1024, window=3, spt=4)
    want = jwf.render_wavefront(jdata, jmeta, small(jcam), use_pallas=False,
                                **kw)
    (got, stats), moved = _moved(twf.graph_count, lambda: twf.render_wavefront(
        data, meta, small(cam), "cpu", max_paths_per_call=3000,
        return_stats=True, **kw))
    assert moved["spans"] > 1 and moved["captures"] == 1
    assert moved["replays"] == moved["rounds"] - 1 > 0
    return got.numpy(), np.asarray(want)


def _lockstep_matches_jax(entry, request):
    """``render``, ``render_progressive`` in steps of 3 and 1 samples, or
    ``render_sharded`` over a one-CPU-device mesh (replays after the first
    call's start and bounce) against the JAX package's."""
    (jdata, jmeta, jcam), (data, meta, cam) = request.getfixturevalue(
        "three_spheres")
    if entry == "render":
        got = render(data, meta, cam, SEED, device="cpu").numpy()
        want = j_render(jdata, jmeta, jcam, seed=SEED)
    elif entry == "render_progressive":
        got = render_progressive(data, meta, cam, SEED, samples_per_step=3,
                                 device="cpu").fb
        want = j_render_progressive(jdata, jmeta, jcam, seed=SEED,
                                    samples_per_step=3).fb
    else:
        got = render_sharded(data, meta, cam, make_mesh(1, devices=["cpu"]),
                             SEED)
        want = j_render_sharded(jdata, jmeta, jcam, j_make_mesh(1),
                                seed=SEED)
    assert integrator.lockstep_graph_count["replays"] > 0
    assert np.isfinite(got).all()
    return got, np.asarray(want)


def _step_matches_jax(request):
    """The stand-in graph route's step (a replay) against the JAX package's
    ``make_train_step(meta, make_mesh(1))``, by test_torch_train_step.py's
    tolerances; both on their default CPU route (the XLA intersector in
    JAX, ``intersect_best`` in the port)."""
    (jdata, jmeta, jcam), (data, meta, cam), target = \
        request.getfixturevalue("cornell")
    step = make_train_step(meta, device="cpu")
    step(data, cam, target, SEED + 5)
    (loss, grads), moved = _moved(sharding.step_graph_count,
                                  lambda: step(data, cam, target, SEED))
    assert moved["replays"] == 1
    j_loss, j_grads = j_make_train_step(jmeta, j_make_mesh(1))(
        jdata, jcam, target, SEED)
    j_grads = {k: np.asarray(v) for k, v in j_grads.items()}
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-4)
    scale = max(np.abs(g).max() for g in j_grads.values())
    assert scale > 0
    for k in _DIFF_FIELDS:
        np.testing.assert_allclose(grads[k].numpy(), j_grads[k], rtol=1e-3,
                                   atol=1e-5 * scale, err_msg=k)


@pytest.mark.parametrize("case", ["wavefront", "render", "render_progressive",
                                  "render_sharded", "step"])
def test_stand_in_graph_route_matches_jax(case, stand_in, request):
    """Each program on the stand-in graph route against the JAX package:
    the images by the image rule, the step's loss and gradients by the
    train step's tolerances."""
    if case == "step":
        _step_matches_jax(request)
        assert len(stand_in.bodies) == 1
        return
    if case == "wavefront":
        got, want = _wavefront_matches_jax()
    else:
        got, want = _lockstep_matches_jax(case, request)
        assert len(stand_in.bodies) == 2
    assert_images_close(got, want, msg=f"stand-in {case} vs jax")
