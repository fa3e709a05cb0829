"""Pixel sharding over several devices, and the differentiable train step.

The port of ``mort_tpu.parallel.sharding``.  The JAX package runs one
process over a mesh of devices; the port is SPMD, one process a device
(``parallel.mesh``: ``make_mesh`` and the counted collective
``_all_reduce``).

* **Data parallelism over pixels**: each rank renders its own pixels.  The
  forward pass runs no collective until the final gather of the
  framebuffer: rays are independent, and the counter-based RNG keys every
  draw by the global pixel id, so any mesh size renders the same samples.
* **Scene replication**: every rank holds the whole ``SceneData``.
* **Gradient all-reduce**: the train step sums its loss and the ten scene
  gradients over the ranks in one flat bucket, one ``all_reduce`` a mesh
  axis (the inner "ici" axis first, then "dcn").
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from .. import metrics
from ..camera import Camera
from ..device import require_cuda
from ..rng import DEFAULT_SEED
from ..scene.build import SceneData, SceneMeta
from ..render import closest_hit as ch
from ..render import graphs
from ..render.intersect import quad_frames
from ..render.renderer import (
    _pick_ray_batch, radiance_batches, radiance_for_pixels,
)
from .mesh import (  # noqa: F401  (make_mesh: this module's API)
    Mesh, _all_reduce, _all_reduce_events, _padded_pixels, check_mesh,
    make_mesh,
)


def render_sharded(data: SceneData, meta: SceneMeta, cam: Camera, mesh: Mesh,
                   seed=DEFAULT_SEED, chunk=512, differentiable=False,
                   _eager=False):
    """Render with pixels sharded over ``mesh``; returns the [H, W, 3]
    numpy image (row 0 = bottom) on every rank.

    Rank r renders the r-th contiguous block of the padded pixel ids
    (``_padded_pixels``) through the lockstep ``radiance_batches``, in
    batches of ``_pick_ray_batch``; one all-reduce of a zero-filled image
    (each pixel comes from one rank) gathers the blocks, after the
    replays, outside the graphs (gloo cannot be captured).  On a card the
    block replays the lockstep's CUDA graphs, the counterpart of the JAX
    package's jitted ``_sharded_radiance``; ``differentiable`` runs every
    bounce (the image is detached either way).  ``_eager`` (private to the
    card tests and chip_smoke.py) takes the eager route."""
    device = check_mesh(mesh)
    W, H = cam.image_width, cam.image_height
    n, sid = mesh.size, mesh.rank
    pix, WH = _padded_pixels(W, H, n)
    per = len(pix) // n
    pix = torch.from_numpy(pix[sid * per:(sid + 1) * per]).to(device,
                                                                torch.int64)
    data, cam = data.to(device), cam.to(device)
    with torch.set_grad_enabled(differentiable):
        block = radiance_batches(data, meta, cam, int(seed), pix,
                                 min(_pick_ray_batch(meta, per), per),
                                 chunk=chunk, differentiable=differentiable,
                                 eager=_eager)
    fb = torch.zeros((n * per, 3), dtype=torch.float32, device=device)
    fb[sid * per:(sid + 1) * per] = block.detach()
    _all_reduce(mesh, fb, "gather")
    fb = fb[:WH].cpu().numpy()
    fb[np.isnan(fb)] = 0.0
    return fb.reshape(H, W, 3)


# ---------------------------------------------------------------------------
# Differentiable train step (scene-parameter optimisation)
# ---------------------------------------------------------------------------

# The differentiable scene leaves (the JAX package's names, so gradients
# compare key by key).
_DIFF_FIELDS = ("sph_center", "sph_cvec", "sph_radius", "quad_Q", "quad_u",
                "quad_v", "mat_albedo", "mat_fuzz", "mat_ior", "tex_color")


# What the train steps did since import (or since a caller reset them):
# steps run, CUDA graphs captured, captures that replaced the graph of
# another key, steps replayed from a graph and seconds spent capturing.
step_graph_count = {"steps": 0, "captures": 0, "recaptures": 0,
                    "replays": 0, "capture_s": 0.0}


def _extract_diff(data: SceneData) -> dict:
    return {f: getattr(data, f) for f in _DIFF_FIELDS}


def _merge_diff(data: SceneData, diff: dict) -> SceneData:
    return data.replace(**diff)


def make_train_step(meta: SceneMeta, mesh: Mesh | None = None, device=None,
                    chunk=512, use_kernel=None, accel=None, _eager=False):
    """Build ``run(data, cam, target_img, seed) -> (loss, grads)``: the MSE
    of ``radiance_for_pixels(differentiable=True)`` over all pixels against
    ``target_img`` ([H, W, 3], row 0 = bottom), and its gradient with
    respect to each of ``_DIFF_FIELDS`` (a dict of tensors on the device).

    ``mesh``: None renders every pixel on ``device`` (None is the card,
    ``require_cuda``; pass ``"cpu"`` for the plain versions).  With a mesh,
    rank r renders the r-th contiguous block of the padded pixel ids
    (``_padded_pixels``; the target is padded with its last row) on the
    mesh's device, its loss is its block's mean squared error divided by
    the mesh size (the JAX package's mean over the padded pixels), and the
    loss and the gradients are summed over the ranks in one flat bucket:
    one ``all_reduce`` a mesh axis a step (``run.collectives``, the counts
    of the last step).  ``make_mesh(1)`` gives ``mesh=None``'s step bit for
    bit.  ``use_kernel`` and ``accel``: as in
    ``renderer.radiance_for_pixels`` (None: the kernel on a card,
    ``intersect_best`` on the CPU).

    On a card the step (forward, loss and ``torch.autograd.grad``) is the
    unit "step" of the step's own ``render.graphs.KeptProgram``, the
    counterpart of the JAX package's ``jax.jit``
    (mort_tpu/parallel/sharding.py:164): the key's first call runs it
    eagerly and captures it (the capture's seconds belong to the first
    call, as a jit compiles on its first call), every later call replays;
    a failure of the step's use of its key drops the key.
    The seed is an operand (an int64 device scalar), so one capture serves
    every seed.  The key: the layout of the operands (the camera's static
    fields, the shapes of the scene's tensors and the axis-aligned quads
    that left their axes, ``closest_hit.aaq_off_axis``, one host read each
    time the caller's ``data`` object changes); ``meta``, the mesh, the
    device, ``chunk``, ``use_kernel`` and ``accel`` are the step's own.
    Results are fresh tensors, never the graph's outputs, so a caller may
    keep a step's gradients across the next.  The CPU always runs eagerly;
    so does ``_eager=True`` (private: the card tests and chip_smoke.py
    compare the two routes with it).  The gradient
    all-reduce runs after the replay, outside the graph (gloo cannot be
    captured).  ``step_graph_count`` counts steps, captures, recaptures,
    replays and capture seconds.

    Spans: a call is "train.step"; in it "train.prep" (``_prep``; a miss
    adds to the counter "train.prep_miss"), "train.copy_in" (the copy into
    a kept key's static operands), "train.launch" (the replay),
    "train.out" (the result clones), "train.eager" (the key's eager first
    step, beside its "graphs.capture") and "train.all_reduce".  Each replay stamps its
    device time (``graphs.capture``); the next call reads it on entry, if
    the replay is done, into the counter "train.step_device_ns", and the
    host's time from the replayed call's start to its own into
    "train.step_period_ns"; a replay not yet done when the next call
    starts is not waited for but counted in "train.step_device_unread".
    With a mesh that has process groups, each step adds its bucket's bytes
    to "train.all_reduce_bytes"; on a card a replayed step's all-reduce is
    also bracketed by two timing events (``_all_reduce_events``: the
    collective and its wait for the slowest rank), which the next call
    reads with the replay's stamps once the all-reduce's end is done:
    "train.all_reduce_device_ns" and the count of such reads
    "train.all_reduce_device_count" (so the step's reads and the
    all-reduce's come in pairs; one not yet done counts in both
    "train.step_device_unread" and "train.all_reduce_device_unread").
    """
    if mesh is None:
        device = require_cuda() if device is None else torch.device(device)
        n, sid = 1, 0
    else:
        device = check_mesh(mesh, device)
        n, sid = mesh.size, mesh.rank
    if use_kernel is None:
        use_kernel = device.type == "cuda"
    # "none" packs the axis-aligned quads apart from those off their axes
    aaq_split = use_kernel and (
        accel or ch.auto_accel(meta.n_spheres + meta.n_quads)) == "none"

    # The step's operands live on the device across calls, keyed on the
    # identity of the caller's objects: a training loop passes the same
    # scene, camera and target every step.  The keys are held strongly: an
    # id() alone can be reused by the next object after a collection (a
    # stale scene under finite-difference probing, in the JAX package).
    prep_cache = {}
    program = graphs.KeptProgram(step_graph_count, copy_in="train.copy_in",
                                 eager="train.eager", launch="train.launch")

    def _prep(data, cam, target_img):
        """The device operands of the caller's objects (data, cam, target
        block, pixel ids, the aaq rows off their axes), kept while they
        are the last call's.  A miss (the counter "train.prep_miss") makes
        again only what changed: the camera's operands on its object, the
        target block and the pixel ids on the target's object and the
        image's size.  A fit that passes a new scene each step so copies
        nothing from the host: a pageable upload of the pixel ids would
        wait for the card."""
        key = prep_cache.get("key")
        hit = (key is not None and key[0] is data and key[1] is cam
               and key[2] is target_img)
        if not hit:
            metrics.count("train.prep_miss")
            old = prep_cache.get("val")
            size = (cam.image_width, cam.image_height)
            if key is not None and key[1] is cam:
                cam_dev = old[1]
            else:
                cam_dev = cam.to(device)
            if (key is not None and key[2] is target_img
                    and prep_cache["size"] == size):
                target, pix = old[2], old[3]
            else:
                pix, WH = _padded_pixels(*size, n)
                per = len(pix) // n
                target = torch.as_tensor(
                    np.asarray(target_img, np.float32).reshape(-1, 3)
                    if not isinstance(target_img, torch.Tensor)
                    else target_img.reshape(-1, 3)).to(device, torch.float32)
                target = torch.cat(
                    [target, target[-1:].expand(n * per - WH, 3)])
                block = slice(sid * per, (sid + 1) * per)
                target = target[block]
                pix = torch.from_numpy(pix[block]).to(device, torch.int64)
            data_dev = data.to(device)
            off_axis = None
            if aaq_split:
                with torch.no_grad():
                    off_axis = ch.aaq_off_axis(meta, ch.quad_records(
                        data_dev, quad_frames(data_dev)))
            prep_cache.update(key=(data, cam, target_img), size=size,
                              val=(data_dev, cam_dev, target, pix, off_axis))
        return prep_cache["val"]

    def _body(data, leaves, cam, target, pix, seed, off_axis):
        img = radiance_for_pixels(_merge_diff(data, leaves), meta, cam, seed,
                                  pix, chunk=chunk, differentiable=True,
                                  use_kernel=use_kernel, accel=accel,
                                  off_axis=off_axis)
        loss = torch.mean((img - target) ** 2)
        if n > 1:
            loss = loss / n
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True, materialize_grads=True)
        return loss.detach(), list(grads)

    def _build(statics):
        data, cam, target, pix, off_axis = statics
        leaves = {k: v.requires_grad_()
                  for k, v in _extract_diff(data).items()}
        seed = torch.zeros((), dtype=torch.int64, device=device)
        out = {}

        def step():
            out["loss"], out["grads"] = _body(data, leaves, cam, target, pix,
                                              seed, off_axis)
            return out["loss"], out["grads"]
        return (seed, out), {"step": step}

    collectives = Counter()
    # the last replayed call's timing events, start and whether its
    # all-reduce was timed, until the next call
    last_replay = []
    reduce_events = _all_reduce_events(mesh, device)

    def _read_last_replay(start_ns):
        """The counters of the last call's replay (and of its all-reduce),
        if it is done."""
        if not last_replay:
            return
        stamps, t0, timed = last_replay.pop()
        if (reduce_events if timed else stamps)[1].query():
            metrics.count("train.step_device_ns",
                          metrics.elapsed_ns(*stamps))
            metrics.count("train.step_period_ns", start_ns - t0)
            if timed:
                metrics.count("train.all_reduce_device_ns",
                              metrics.elapsed_ns(*reduce_events))
                metrics.count("train.all_reduce_device_count")
        else:
            metrics.count("train.step_device_unread")
            if timed:
                metrics.count("train.all_reduce_device_unread")

    def run(data: SceneData, cam: Camera, target_img, seed=DEFAULT_SEED):
        with metrics.span("train.step") as step:
            step_graph_count["steps"] += 1
            _read_last_replay(step.start)
            with metrics.span("train.prep"):
                ops = _prep(data, cam, target_img)
            stamps = None
            if graphs.graph_route(device, _eager):
                with program.entered(graphs.layout(ops), ops, _build,
                                     device) as (seed_s, out):
                    seed_s.fill_(int(seed) & 0xFFFFFFFF)
                    first, stamps = program.run("step")
                    if first is None:
                        with metrics.span("train.out"):
                            first = (out["loss"].clone(),
                                     [g.clone() for g in out["grads"]])
                loss, grads = first
            else:
                data_dev, cam_dev, target, pix, off_axis = ops
                leaves = {k: v.detach().requires_grad_()
                          for k, v in _extract_diff(data_dev).items()}
                loss, grads = _body(data_dev, leaves, cam_dev, target, pix,
                                    int(seed), off_axis)
            collectives.clear()
            timed = False
            if mesh is not None and mesh.groups:
                timed = reduce_events is not None and stamps is not None
                with metrics.span("train.all_reduce"):
                    if timed:
                        reduce_events[0].record()
                    bucket = torch.cat([loss.reshape(1)]
                                       + [g.reshape(-1) for g in grads])
                    metrics.count("train.all_reduce_bytes",
                                  bucket.numel() * bucket.element_size())
                    collectives["all_reduce"] = _all_reduce(mesh, bucket,
                                                            "grads")
                    loss = bucket[0]
                    parts = bucket[1:].split([g.numel() for g in grads])
                    grads = [p.reshape(g.shape)
                             for p, g in zip(parts, grads)]
                    if timed:
                        reduce_events[1].record()
            if stamps is not None:
                last_replay.append((stamps, step.start, timed))
            return loss, dict(zip(_DIFF_FIELDS, grads))

    # attributes, not names ``run`` reads: a function that refers to
    # itself lives in a reference cycle, and a captured graph it holds would
    # be freed by the cyclic collector at any time, a capture included
    run.prep_cache = prep_cache
    run.collectives = collectives
    return run
