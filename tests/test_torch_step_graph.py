"""The train step as one captured device program: what the CPU can hold.

On a card ``make_train_step`` runs the first step of a graph key eagerly,
captures the step (forward, loss, ``torch.autograd.grad``) into a CUDA
graph and replays it for every later step (``graphs.KeptProgram``, the
counterpart of the JAX package's ``jax.jit`` at
mort_tpu/parallel/sharding.py:164).  The capture
itself needs the card (``test_torch_cuda.py`` holds the graph route against
the eager route there); on the CPU these tests hold what the capture rests
on:

- the step body makes no host read and no tensor from host data on its
  static operands, which a capture would refuse, on the kernel route
  (the closest-hit Function; its plain versions, which are kernels on a
  card, exempt by name) and on the ``intersect_best`` route;
- with the stand-in capture (``stand_in_capture``) whose replay runs the
  body: an axis-aligned quad off its axes enters the key; the step
  function frees its graph when dropped.

``test_torch_kept_programs.py`` holds what the three captured programs
share: the CPU never captures, a new key recaptures (a new seed, ``data``
or ``cam`` object replays), results stay fresh, a leaf updated in place
is read, a failure drops the key, and the stand-in route against the JAX
package's step.
"""

import contextlib
import dataclasses
import weakref

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _disable_current_modes

from stand_in_capture import stand_in  # noqa: F401
from test_torch_span_graph import HostRead, _no_host_reads

from mort_tpu.render.renderer import render as j_render
from mort_tpu.scene import scenes as jsc
from mort_tpu_torch.camera import camera_from_numpy
from mort_tpu_torch.parallel.sharding import make_train_step
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


def test_quad_off_its_axes_enters_the_key(cornell, stand_in):
    """An axis-aligned quad moved off its axes is found by ``_prep`` (the
    step's operands carry its row) and captures the step once more; the
    same scene again replays."""
    _j, (data, meta, cam), target = cornell
    step = make_train_step(meta, device="cpu", use_kernel=True)
    step(data, cam, target, SEED)
    assert step.prep_cache["val"][4] == ()
    groups = ch.aaq_groups_of(meta)
    cls = sorted(groups)[0]
    row = groups[cls][0]
    u = data.quad_u.clone()
    u[row, 3 - cls // 3 - cls % 3] += 1e-3
    off = data.replace(quad_u=u)
    step(off, cam, target, SEED)
    assert step.prep_cache["val"][4] == (row,)
    assert len(stand_in.bodies) == 2
    step(off, cam, target, SEED + 1)
    assert len(stand_in.bodies) == 2


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
