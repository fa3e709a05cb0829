"""The lockstep forward as captured device programs: what the CPU can hold.

On a card ``render``, ``render_progressive`` and ``render_sharded`` run
through ``renderer.radiance_batches``, which captures one sample's start
and one bounce into CUDA graphs on a key's first call and replays them (the
counterparts of the JAX package's jitted ``_render_flat``, progressive
``_step`` and ``_sharded_radiance``).  The capture needs the card
(``test_torch_cuda.py`` holds the graph route against the eager route
there); on the CPU these tests hold what it rests on:

- "start" and "bounce" make no host read and no tensor from host data on
  their static operands, on the kernel route (the closest-hit Function;
  its plain version, a kernel on a card, exempt by name) and on the
  ``intersect_best`` route;
- a tensor bounce index gives the int's bits in ``finalize_and_shade``,
  ``media_pass`` and ``intersect_best``;
- the graph route's loop with the stand-in capture
  (``stand_in_capture``) whose replay runs the unit: the eager route's
  images, bounces, host reads and closest-hit calls; no capture inside a
  capture.

``test_torch_kept_programs.py`` holds what the three captured programs
share: the CPU never captures, a new key recaptures (and a new scene of
the same shapes, or the same tensors changed in place, renders from fresh
tables), results stay fresh, a failure drops the key, and the stand-in
route against the JAX package.
"""

import numpy as np
import pytest
import torch

from stand_in_capture import stand_in  # noqa: F401
from test_torch_span_graph import _no_host_reads
from test_torch_step_graph import _kernel_exempt

from mort_tpu_torch.camera import derive_basis, get_rays_soa
from mort_tpu_torch.parallel import sharding
from mort_tpu_torch.parallel.sharding import make_mesh, render_sharded
from mort_tpu_torch.render import closest_hit as ch
from mort_tpu_torch.render import integrator, progressive
from mort_tpu_torch.render.graphs import tensors
from mort_tpu_torch.render.hitshade import finalize_and_shade
from mort_tpu_torch.render.intersect import (
    T_MIN, intersect_best, media_pass, quad_frames,
)
from mort_tpu_torch.render.progressive import render_progressive
from mort_tpu_torch.render.renderer import render
from mort_tpu_torch.scene import scenes as tsc

SEED = 11
COUNTS = integrator.lockstep_graph_count


def _scene(case, width=16):
    """The Cornell box at 12x12, 4 spp, depth 6; scene 1 with a defocus
    (and its moving spheres) at ``width`` px, depth 6; or scene 9 at
    ``width`` px, depth 4; 4 spp."""
    if case == "cornell":
        world, cam = tsc.cornell_box()
        cam = cam.replace(image_width=12, image_height=12, sqrt_spp=2,
                          bounce_limit=6)
        return (*world.compile(), cam)
    world, cam = tsc.build_scene(1 if case == "scene1" else 9)
    h = max(1, int(width * cam.image_height / cam.image_width))
    cam = cam.replace(image_width=width, image_height=h, sqrt_spp=2,
                      bounce_limit=6 if case == "scene1" else 4)
    if case == "scene1":
        cam = cam.replace(defocus_angle=torch.tensor(0.6))
    return (*world.compile(), cam)


@pytest.fixture
def hits(monkeypatch):
    """Counts the closest-hit calls: the kernel's plain version (the
    launches' counterpart on the CPU) and ``intersect_best``."""
    n = {"calls": 0}
    for mod, name in ((ch, "closest_hit_reference"),
                      (integrator, "intersect_best")):
        fn = getattr(mod, name)

        def counted(*args, _fn=fn, **kw):
            n["calls"] += 1
            return _fn(*args, **kw)
        monkeypatch.setattr(mod, name, counted)
    return n


def _same(a, b):
    """Bit-equal tensors (float32 compared as raw int32, NaNs included)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


def _moved(before, hits=None, calls=None):
    moved = {k: COUNTS[k] - before[k] for k in before}
    if hits is not None:
        moved["hits"] = hits["calls"] - calls
    return moved


@pytest.mark.parametrize("case,use_kernel", [
    ("cornell", True), ("cornell", False), ("scene1", True),
    ("scene1", False), ("scene9", True), ("scene9", False)])
def test_units_make_no_host_read(case, use_kernel, stand_in, monkeypatch):
    """The captured units, "start" then "bounce", read nothing on the host
    and make no tensor from host data, on the kernel route and on the
    ``intersect_best`` route: the Cornell box (quads, axis-aligned and
    boxed, a light), scene 1 with a defocus (its lens draws, moving
    spheres) and scene 9 (media, image and noise textures, "none"'s box
    and aaq tables)."""
    data, meta, cam = _scene(case)
    _kernel_exempt(monkeypatch)
    img = render(data, meta, cam, SEED, device="cpu", use_kernel=use_kernel)
    assert [b.func.__name__ for b in stand_in.bodies] == [
        "start_sample", "bounce_once"]
    for body in stand_in.bodies:
        _no_host_reads(body)
    assert bool(torch.isfinite(img).all())


@pytest.fixture(scope="module")
def scene9_hits():
    """Scene 9's camera rays at 24 px (576 rays, 4 samples) and their
    closest hits (the "none" kernel's plain version): the operands of one
    bounce."""
    data, meta, cam = _scene("scene9", width=24)
    qf = quad_frames(data)
    prep = integrator.prepack(data, meta, qf, True, "none")
    R = cam.image_width * cam.image_height
    pix = torch.arange(R, dtype=torch.int64)
    sample = torch.arange(R, dtype=torch.int64) % 4
    ro, rd, tme = get_rays_soa(cam, derive_basis(cam), SEED, pix, sample)
    hit = ch.closest_hit(prep.packed, ro, rd, tme)
    return data, meta, qf, prep, pix, sample, ro, rd, tme, hit


@pytest.mark.parametrize("bounce", range(4))
@pytest.mark.parametrize("fn", ["finalize_and_shade", "media_pass",
                                "intersect_best"])
def test_tensor_bounce_gives_the_int_bits(scene9_hits, fn, bounce):
    """Each function that draws Philox with the bounce as a counter word,
    on scene 9 (media, a light, dielectric, metal, textures), gives the
    same bits with the bounce an int (the eager route) and a 0-d int64
    tensor (the captured "bounce")."""
    data, meta, qf, prep, pix, sample, ro, rd, tme, hit = scene9_hits
    bt, bk, bi, row_t = hit

    def call(b):
        if fn == "finalize_and_shade":
            return finalize_and_shade(data, meta, qf, prep.table,
                                      prep.mat_cols, ro, rd, tme, bt, bk, bi,
                                      SEED, pix, sample, b, row_t=row_t)
        if fn == "media_pass":
            return media_pass(data, meta, qf, ro, rd, SEED, pix, sample, b,
                              T_MIN, bt, bk, bi)
        return intersect_best(data, meta, qf, ro.to_rows(), rd.to_rows(),
                              tme, SEED, pix, sample, b)

    want = tensors(call(bounce))
    got = tensors(call(torch.tensor(bounce, dtype=torch.int64)))
    assert len(got) == len(want) > 0
    assert all(_same(g, w) for g, w in zip(got, want))
    if fn == "media_pass" and bounce:
        # the draws differ from bounce to bounce
        assert not _same(tensors(call(0))[0], want[0])


def _entries(monkeypatch, batch):
    """The three callers on the CPU at ``batch`` pixels a batch (a short
    tail batch on a 12x12 image): (entry, differentiable) -> a function of
    (data, meta, cam, eager) returning the image as numpy."""
    monkeypatch.setattr(progressive, "_pick_ray_batch", lambda m, n: batch)
    monkeypatch.setattr(sharding, "_pick_ray_batch", lambda m, n: batch)
    mesh = make_mesh(1, devices=["cpu"])

    def lock(data, meta, cam, eager):
        return render(data, meta, cam, SEED, ray_batch=batch, device="cpu",
                      _eager=eager).numpy()

    def prog(data, meta, cam, eager):
        return render_progressive(data, meta, cam, SEED, samples_per_step=3,
                                  device="cpu", _eager=eager).fb

    def shard(differentiable):
        return lambda data, meta, cam, eager: render_sharded(
            data, meta, cam, mesh, SEED, differentiable=differentiable,
            _eager=eager)

    return {"render": lock, "render_progressive": prog,
            "render_sharded": shard(False),
            "render_sharded_differentiable": shard(True)}


@pytest.mark.parametrize("entry", ["render", "render_progressive",
                                   "render_sharded",
                                   "render_sharded_differentiable"])
def test_graph_route_equals_eager(entry, stand_in, hits, monkeypatch):
    """Each caller on the stand-in graph route against its eager route
    (``_eager=True``) on the Cornell box at 12x12 in batches of 50 pixels
    (a tail of 44 padded on the graph route): the image bit for bit, the
    same bounces, host reads and closest-hit calls; two captures, and a
    replay for every start and bounce after the first of each.
    ``render_progressive`` runs steps of 3 and 1 samples (one key);
    ``render_sharded(differentiable=True)`` runs every bounce with no
    read."""
    data, meta, cam = _scene("cornell")
    fn = _entries(monkeypatch, 50)[entry]
    runs = []
    for eager in (False, True):
        before, calls = dict(COUNTS), hits["calls"]
        img = fn(data, meta, cam, eager)
        runs.append((img, _moved(before, hits, calls)))
    (g_img, g), (e_img, e) = runs
    assert g_img.dtype == np.float32 and g_img.shape == (12, 12, 3)
    assert np.array_equal(g_img.view(np.int32), e_img.view(np.int32))
    assert (g["bounces"], g["syncs"], g["hits"]) == (e["bounces"], e["syncs"],
                                                     e["hits"])
    assert e["captures"] == e["replays"] == 0
    assert g["captures"] == 2 and g["recaptures"] == 0
    starts = 3 * cam.sqrt_spp ** 2
    assert g["replays"] == starts + g["hits"] - 2
    if entry == "render_sharded_differentiable":
        assert g["hits"] == starts * cam.bounce_limit
        assert g["bounces"] == g["syncs"] == 0
    else:
        assert g["syncs"] >= g["bounces"] == g["hits"] > starts


def test_call_inside_a_capture_stays_eager(stand_in, monkeypatch):
    """A call made while a stream is capturing (``make_train_step``'s
    capture reaches ``radiance_for_pixels``) starts no capture of its own
    and replays nothing."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    data, meta, cam = _scene("cornell")
    before = dict(COUNTS)
    got = render(data, meta, cam, SEED, device="cpu")
    moved = _moved(before)
    assert moved["captures"] == moved["replays"] == 0
    assert not stand_in.bodies
    assert _same(got, render(data, meta, cam, SEED, device="cpu",
                             _eager=True))
