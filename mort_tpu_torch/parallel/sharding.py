"""Pixel sharding over several devices, and the differentiable train step.

The port of ``mort_tpu.parallel.sharding``.  The JAX package runs one
process over a mesh of devices; the port is SPMD: one process a device,
on ``torch.distributed``'s default process group, which the caller
initialises first (NCCL across cards, gloo on the CPU or for several ranks
that share one card), as the JAX caller runs ``jax.distributed.initialize``.
``make_mesh(1)`` needs no process group.

* **Data parallelism over pixels**: each rank renders its own pixels.  The
  forward pass runs no collective until the final gather of the
  framebuffer: rays are independent, and the counter-based RNG keys every
  draw by the global pixel id, so any mesh size renders the same samples.
* **Scene replication**: every rank holds the whole ``SceneData``.
* **Gradient all-reduce**: the train step sums its loss and the ten scene
  gradients over the ranks in one flat bucket, one ``all_reduce`` a mesh
  axis (the inner "ici" axis first, then "dcn").

Every collective of this package goes through ``_all_reduce``, which
counts it, so an entry point can report the collectives it ran.
"""

from __future__ import annotations

import functools
import os
import socket
from collections import Counter
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from .. import metrics
from ..camera import Camera
from ..device import require_cuda
from ..rng import DEFAULT_SEED
from ..scene.build import SceneData, SceneMeta
from ..render import closest_hit as ch
from ..render.graphs import (
    capture, cloned, graph_route as _graph_route, tensors,
)
from ..render.intersect import quad_frames
from ..render.renderer import (
    _pick_ray_batch, radiance_batches, radiance_for_pixels,
)


@dataclass(eq=False)
class Mesh:
    """This rank's view of the device mesh.

    ``axis_names`` ``("rays",)`` or ``("dcn", "ici")`` and ``shape`` (one
    size an axis) as in the JAX package; the shard id is the rank,
    outer-major (rank = dcn index * chips + ici index).  ``groups`` holds
    one process group an axis, outer first (None is the default group), and
    is empty without a process group: then the mesh has one rank and runs
    no collective."""
    axis_names: tuple
    shape: tuple
    rank: int
    device: torch.device
    groups: tuple = ()
    collectives: Counter = field(default_factory=Counter)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))


def make_mesh(n_devices=None, devices=None, shape=None) -> Mesh:
    """Device mesh for pixel sharding, one rank a device.

    1-D: ``make_mesh(n)`` -> a "rays" axis over the n ranks of the default
    process group (n defaults to its world size); ``make_mesh(1)`` needs no
    process group.  2-D: ``make_mesh(shape=(hosts, chips))`` -> the ("dcn",
    "ici") mesh: rank r is host r // chips, chip r % chips, so every "ici"
    row must lie on one host (torchrun numbers a node's ranks
    contiguously); raises otherwise.

    ``devices``: one ``torch.device`` a rank, indexed by rank (two ranks
    may share a card: ``["cuda:0", "cuda:0"]`` on a gloo group).  The
    default is ``cuda:{LOCAL_RANK}``; it raises where no card is visible,
    so the CPU is taken only when asked (``devices=["cpu"] * n``)."""
    if shape is not None and n_devices is not None:
        raise ValueError("pass n_devices or shape, not both")
    grouped = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
    rank = dist.get_rank() if grouped else 0
    if shape is not None:
        shape = tuple(int(s) for s in shape)
        if len(shape) != 2:
            raise ValueError(f"shape must be (hosts, chips), got {shape}")
        n = shape[0] * shape[1]
    else:
        n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(
            f"a mesh of {n} devices needs a process group of {n} ranks, "
            f"one a device; have {world}"
            + ("" if grouped else " (no process group is initialised)"))
    if devices is None:
        require_cuda()
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    else:
        if len(devices) < n:
            raise ValueError(f"{len(devices)} devices for a mesh of {n}")
        device = torch.device(devices[rank])
    if device.type == "cuda":
        # NCCL and all_gather_object act on the current card
        torch.cuda.set_device(device)
    if shape is None:
        return Mesh(("rays",), (n,), rank, device, (None,) if grouped else ())
    hosts, chips = shape
    groups = ()
    if grouped:
        # every rank creates every group, in the same order
        rows = [dist.new_group([h * chips + c for c in range(chips)])
                for h in range(hosts)]
        cols = [dist.new_group([h * chips + c for h in range(hosts)])
                for c in range(chips)]
        groups = (cols[rank % chips], rows[rank // chips])
        names = [None] * world
        dist.all_gather_object(names, socket.gethostname())
        for h in range(hosts):
            row = set(names[h * chips:(h + 1) * chips])
            if len(row) != 1:
                raise ValueError(
                    f"an 'ici' row spans hosts {sorted(row)}; use "
                    f"shape=(hosts, ranks a host) so each row maps to one "
                    f"host's cards")
    return Mesh(("dcn", "ici"), shape, rank, device, groups)


def mesh_axes(mesh: Mesh) -> tuple:
    """The mesh's data-parallel axis names as a flat tuple (outer-major):
    the pixel axis is sharded over every one of them."""
    return tuple(mesh.axis_names)


def check_mesh(mesh, device=None) -> torch.device:
    """``mesh``'s device; raises if ``mesh`` is not a ``Mesh`` or
    ``device`` names another device."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a Mesh (make_mesh), got "
                        f"{type(mesh).__name__}")
    if device is not None and torch.device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's device "
                         f"{mesh.device} on rank {mesh.rank}")
    return mesh.device


def _all_reduce(mesh: Mesh, t: torch.Tensor, what: str) -> int:
    """Sum ``t`` in place over every rank of ``mesh``: over the inner axis
    first, then the outer.  Counts each call in ``mesh.collectives[what]``
    and returns the number run (0 without a process group)."""
    for g in reversed(mesh.groups):
        dist.all_reduce(t, group=g)
        mesh.collectives[what] += 1
    return len(mesh.groups)


def _padded_pixels(W, H, n_shards):
    WH = W * H
    per = -(-WH // n_shards)
    pix = np.minimum(np.arange(n_shards * per, dtype=np.int32), WH - 1)
    return pix, WH


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

# the step's capture, counted in ``step_graph_count`` (a test puts a
# stand-in here)
_capture = functools.partial(capture, counts=step_graph_count)


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

    On a card the step (forward, loss and ``torch.autograd.grad``) is one
    captured device program, the counterpart of the JAX package's
    ``jax.jit`` (mort_tpu/parallel/sharding.py:164): the first call of a
    graph key runs the step eagerly on static copies of its operands,
    which builds or loads the kernel library and does torch's lazy
    initialisation and gives the call's result, then captures it into a
    CUDA graph (``render.graphs.capture``: its seconds belong to the first
    call, as a jit compiles on its first call); every later call of the
    key copies the caller's values into the static operands and replays
    the graph.  The seed is an operand (an int64 device scalar), so one
    capture serves every seed.  The key: the camera's static fields, the
    shapes of the scene's tensors and the axis-aligned quads that left
    their axes (``closest_hit.aaq_off_axis``, one host read each time the
    caller's ``data`` object changes); ``meta``, the mesh, the device,
    ``chunk``, ``use_kernel`` and ``accel`` are the step's own.  A new key
    captures again and drops the old graph.  Results are fresh tensors,
    never the graph's outputs, so a caller may keep a step's gradients
    across the next.  A failed capture or replay raises.  The CPU always
    runs eagerly; so does ``_eager=True`` (private: the card tests and
    chip_smoke.py compare the two routes with it).  The gradient
    all-reduce runs after the replay, outside the graph (gloo cannot be
    captured).  ``step_graph_count`` counts steps, captures, recaptures,
    replays and capture seconds.

    Spans: a call is "train.step"; in it "train.prep" (``_prep``; a miss
    adds to the counter "train.prep_miss"), "train.copy_in" (the copy into
    the static operands), "train.launch" (the replay), "train.out" (the
    result clones), "train.eager" (the key's eager first step, beside its
    "graphs.capture") and "train.all_reduce".  Each replay stamps its
    device time (``graphs.capture``); the next call reads it on entry, if
    the replay is done, into the counter "train.step_device_ns", and the
    host's time from the replayed call's start to its own into
    "train.step_period_ns"; a replay not yet done when the next call
    starts is not waited for but counted in "train.step_device_unread".
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
    # the captured step of the current key: key, graph, replay, static
    # operands and outputs
    graph = {}

    def _prep(data, cam, target_img):
        """(hit, operands): whether the caller's objects are the last
        call's, and their device operands (data, cam, target block, pixel
        ids, the aaq rows off their axes)."""
        key = prep_cache.get("key")
        hit = (key is not None and key[0] is data and key[1] is cam
               and key[2] is target_img)
        if not hit:
            pix, WH = _padded_pixels(cam.image_width, cam.image_height, n)
            per = len(pix) // n
            target = torch.as_tensor(
                np.asarray(target_img, np.float32).reshape(-1, 3)
                if not isinstance(target_img, torch.Tensor)
                else target_img.reshape(-1, 3)).to(device, torch.float32)
            target = torch.cat(
                [target, target[-1:].expand(n * per - WH, 3)])
            block = slice(sid * per, (sid + 1) * per)
            pix = torch.from_numpy(pix[block]).to(device, torch.int64)
            data_dev = data.to(device)
            off_axis = None
            if aaq_split:
                with torch.no_grad():
                    off_axis = ch.aaq_off_axis(meta, ch.quad_records(
                        data_dev, quad_frames(data_dev)))
            prep_cache.update(key=(data, cam, target_img),
                              val=(data_dev, cam.to(device), target[block],
                                   pix, off_axis))
        return hit, prep_cache["val"]

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

    def _graph_step(hit, ops, seed):
        data_dev, cam_dev, target, pix, off_axis = ops
        key = ((cam_dev.image_width, cam_dev.image_height, cam_dev.sqrt_spp,
                cam_dev.bounce_limit), off_axis,
               tuple(tuple(t.shape) for t in tensors(data_dev)))
        if graph.get("key") != key:
            if graph:
                graph.pop("graph").reset()
                step_graph_count["recaptures"] += 1
            graph.clear()
            data = cloned(data_dev)
            leaves = {k: v.requires_grad_()
                      for k, v in _extract_diff(data).items()}
            static = (data, leaves, cloned(cam_dev), target.clone(),
                      pix.clone(), torch.full((), seed, dtype=torch.int64,
                                              device=device), off_axis)
            out = {}

            def body():
                out["loss"], out["grads"] = _body(*static)

            # the warm-up, eager: this call's result
            with metrics.span("train.eager"):
                first = _body(*static)
            captured, replay = _capture(body, device)
            graph.update(key=key, graph=captured, replay=replay,
                         static=static, out=out)
            return first, None
        data, _leaves, cam_s, target_s, pix_s, seed_s, _ = graph["static"]
        with torch.no_grad(), metrics.span("train.copy_in"):
            if not hit:
                for dst, src in zip(tensors(data) + tensors(cam_s)
                                    + [target_s, pix_s],
                                    tensors(data_dev) + tensors(cam_dev)
                                    + [target, pix]):
                    dst.copy_(src)
            seed_s.fill_(seed)
        with metrics.span("train.launch"):
            stamps = graph["replay"]()
        out = graph["out"]
        with metrics.span("train.out"):
            result = out["loss"].clone(), [g.clone() for g in out["grads"]]
        return result, stamps

    collectives = Counter()
    # the last replayed call's timing events and start, until the next call
    last_replay = []

    def _read_last_replay(start_ns):
        """The counters of the last call's replay, if it is done."""
        if not last_replay:
            return
        stamps, t0 = last_replay.pop()
        if stamps[1].query():
            metrics.count("train.step_device_ns",
                          metrics.elapsed_ns(*stamps))
            metrics.count("train.step_period_ns", start_ns - t0)
        else:
            metrics.count("train.step_device_unread")

    def run(data: SceneData, cam: Camera, target_img, seed=DEFAULT_SEED):
        with metrics.span("train.step") as step:
            step_graph_count["steps"] += 1
            _read_last_replay(step.start)
            with metrics.span("train.prep"):
                hit, ops = _prep(data, cam, target_img)
            if not hit:
                metrics.count("train.prep_miss")
            if _graph_route(device, _eager):
                (loss, grads), stamps = _graph_step(
                    hit, ops, int(seed) & 0xFFFFFFFF)
                if stamps is not None:
                    last_replay.append((stamps, step.start))
            else:
                data_dev, cam_dev, target, pix, off_axis = ops
                leaves = {k: v.detach().requires_grad_()
                          for k, v in _extract_diff(data_dev).items()}
                loss, grads = _body(data_dev, leaves, cam_dev, target, pix,
                                    int(seed), off_axis)
            collectives.clear()
            if mesh is not None and mesh.groups:
                with metrics.span("train.all_reduce"):
                    bucket = torch.cat([loss.reshape(1)]
                                       + [g.reshape(-1) for g in grads])
                    collectives["all_reduce"] = _all_reduce(mesh, bucket,
                                                            "grads")
                loss = bucket[0]
                parts = bucket[1:].split([g.numel() for g in grads])
                grads = [p.reshape(g.shape) for p, g in zip(parts, grads)]
            return loss, dict(zip(_DIFF_FIELDS, grads))

    # attributes, not names ``run`` reads: a function that refers to
    # itself lives in a reference cycle, and a captured graph it holds would
    # be freed by the cyclic collector at any time, a capture included
    run.prep_cache = prep_cache
    run.collectives = collectives
    return run
