"""Persistent wavefront integrator with in-window ray regeneration.

The port of ``mort_tpu.render.wavefront`` (single device).  A fixed pool of
P lanes stays busy: a *task* is a (pixel, sample-chunk) pair — ``spt``
stratified samples of one pixel.  A lane accumulates its chunk's radiance in
``Lsum`` and respawns the next camera ray of its chunk the moment a path
terminates, inside the bounce loop; the framebuffer add happens once per
finished chunk:

  while tasks remain or lanes active:
      deposit: lanes whose chunk completed add Lsum into the framebuffer
      refill:  idle lanes claim the next tasks via a cumsum-rank
      window:  several intersect+shade bounce steps; a terminated path
               folds into Lsum and respawns the lane on the next sample

The counter-based RNG keys draws by (pixel, sample, bounce, slot), so the
per-sample radiance is the JAX package's; only the accumulation order
differs.  ``jax.lax.while_loop``/``fori_loop`` become Python loops whose
condition is read on the host once a round (one device sync).  On a card
the span's round is one captured device program kept by graph key across
spans and calls (``graphs.KeptProgram``), the counterpart of
``jax.jit(_wavefront_span)`` and its cache: the key's first round runs
eagerly and is captured into a CUDA graph, and every later round of every
span of the key is one replay over static tensors that each span fills
(``_span_core``).  The deposit has a fixed shape, as JAX's drop-mode
scatter: a lane that does not deposit adds into a drop row of its own
past the image (``_deposit``).

Every reference scene renders: constant media are sampled after the closest
hit (``media_pass``), lights through the mixture pdf and fallback
(image/noise) textures inline in ``finalize_and_shade``.  The JAX package's
deferred-texture mode is not ported: it served the TPU, whose texel gather
is serialised, and changes only the float32 association of the image.

Several devices
---------------
``render_wavefront(..., mesh=...)`` shards the task space over the ranks of
a ``parallel.mesh.Mesh`` (one process a device): pixels are dealt
round-robin (global pixel = local * n_shards + shard id), so every rank's
pool sees the whole image and the ranks' loads balance.  Rays and Philox
draws are keyed by the global pixel id, spans are layer-aligned, so each
pixel deposits once a layer and ``index_add_`` never sees one pixel twice
in a call: the image is bit-identical for any mesh size.  The spans run
no collective; one all-reduce of a zero-filled canonical framebuffer (each
pixel from one rank) gathers the image on every rank.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

from .. import metrics
from ..camera import Camera, CameraBasis, derive_basis, get_rays_soa
from ..rng import DEFAULT_SEED
from ..parallel.mesh import _all_reduce, check_mesh
from ..scene.build import SceneData, SceneMeta
from ..device import require_cuda
from . import closest_hit as ch
from . import graphs
from . import vec as v3
from .hitshade import finalize_and_shade
from .intersect import T_MIN, QuadFrames, media_pass, quad_frames
from .primtable import build_prim_table
from .vec import V3


# What the spans did since import (or since a caller reset them): spans
# run, rounds run, CUDA graphs captured, captures that replaced another
# key's program, rounds replayed from a graph, host reads (the loop
# condition once a round, the useful count once a span) and seconds spent
# capturing.
graph_count = {"spans": 0, "rounds": 0, "captures": 0, "recaptures": 0,
               "replays": 0, "syncs": 0, "capture_s": 0.0}


@dataclass(frozen=True)
class SpanOperands:
    """What every span of a call reads besides its lanes: the scene, its
    quad frames, the camera and its basis, the primitive table, the
    material columns, the closest hit's pack and the "none" mode's
    axis-aligned quad rows off their axes (``closest_hit.aaq_off_axis``),
    built once a call outside any capture."""
    data: SceneData
    qf: QuadFrames
    cam: Camera
    basis: CameraBasis
    table: torch.Tensor
    mat_cols: torch.Tensor
    packed: ch.PackedScene
    off_axis: tuple


def span_operands(data: SceneData, meta: SceneMeta, cam: Camera,
                  accel: str) -> SpanOperands:
    """``SpanOperands`` of a scene and camera on their device; on "none"
    one host read (``closest_hit.aaq_off_axis``)."""
    qf = quad_frames(data)
    table, mat_cols = build_prim_table(data, meta, qf)
    off_axis = ()
    if accel == "none":
        with torch.no_grad():
            off_axis = ch.aaq_off_axis(meta, ch.quad_records(data, qf))
    return SpanOperands(data, qf, cam, derive_basis(cam), table, mat_cols,
                        ch.pack_scene(data, meta, qf, table, accel, off_axis),
                        off_axis)


def _deposit(fb: torch.Tensor, pend: torch.Tensor, pixel: torch.Tensor,
             Lsum: V3, inv_spp: float, drop: torch.Tensor) -> None:
    """Add the chunk sums of the lanes in ``pend`` into their pixels' rows
    of ``fb`` [per + P, 3], in place, by one ``index_add_`` of a fixed
    shape: every other lane adds into its own row past the image (``drop``
    = per + lane), which nothing reads, as JAX's drop-mode scatter throws
    it away (mort_tpu/render/wavefront.py:266-277).  No host read decides
    which lanes deposit, so a captured graph can hold it; a real pixel gets
    the same adds in the same lane order as from its depositing lanes
    alone."""
    fb.index_add_(0, torch.where(pend, pixel, drop), Lsum.to_rows() * inv_spp)


# each lane field's value at a span's start (the rest are 0 or false)
_LANE_ONES = ("rd", "beta")


def _make_round(ops: SpanOperands, meta: SceneMeta, *, pool: int,
                window: int, spt: int, use_kernel: bool, no_defocus: bool,
                per: int, n_shards: int, shard_id: int):
    """A round over ``ops`` and the static tensors it reads and writes in
    place: returns ``(round_, state)``.  ``state`` holds the lanes' fields,
    ``fb`` (the image's ``per`` rows, then one drop row a lane), ``seed``
    (an int64 scalar: Philox's key word), ``total`` (the span's end task),
    ``counter`` (the next task), ``useful`` (the useful segments so far)
    and ``go`` (the loop condition after the last round); ``_start_span``
    fills them for a span.  A replayed CUDA graph reads and writes the
    addresses it was captured with, so a round rebinds nothing that
    outlives it: it ends by copying its results into these tensors.  The
    round's Python numbers (``spp``, ``inv_spp``, ``spt``, ``per``, the
    image size, the bounce limit) come from the graph key."""
    data, qf, cam, basis = ops.data, ops.qf, ops.cam, ops.basis
    table, mat_cols, packed = ops.table, ops.mat_cols, ops.packed
    dev = data.sph_center.device
    W, H = cam.image_width, cam.image_height
    WH = W * H
    spp = cam.sqrt_spp * cam.sqrt_spp
    inv_spp = float(np.float32(1.0 / spp))
    P = pool
    bg = cam.background
    bg_v = V3(bg[0], bg[1], bg[2])

    def zeros(dtype):
        return torch.zeros(P, dtype=dtype, device=dev)

    def v3_zeros():
        return V3(*(zeros(torch.float32) for _ in range(3)))

    def scalar(dtype=torch.int64):
        return torch.zeros((), dtype=dtype, device=dev)

    lanes = {
        "alive": zeros(torch.bool), "pend": zeros(torch.bool),
        "pixel": zeros(torch.int64), "sample": zeros(torch.int64),
        "send": zeros(torch.int64), "ro": v3_zeros(), "rd": v3_zeros(),
        "tme": zeros(torch.float32), "bounce": zeros(torch.int64),
        "L": v3_zeros(), "Lsum": v3_zeros(), "beta": v3_zeros(),
    }
    fbx = torch.zeros((per + P, 3), dtype=torch.float32, device=dev)
    state = {
        "lanes": lanes, "fb": fbx,
        "drop": torch.arange(per, per + P, device=dev),
        "seed": scalar(), "total": scalar(), "counter": scalar(),
        "useful": scalar(), "go": scalar(torch.bool),
    }
    seed, total = state["seed"], state["total"]
    counter, useful = state["counter"], state["useful"]

    def closest(ro, rd, tme):
        if use_kernel:
            return ch.closest_hit(packed, ro, rd, tme)
        return ch.split_row(ch.closest_hit_reference(
            packed, ch.stack_rays(ro, rd, tme)))

    def to_global(local_pixel):
        if n_shards == 1:
            return local_pixel
        return local_pixel * n_shards + shard_id

    def bounce_step(s):
        act = s["alive"]
        useful.add_(act.sum())
        pixel = to_global(s["pixel"])
        sample, bounce = s["sample"], s["bounce"]
        ro, rd, tme, beta, L = s["ro"], s["rd"], s["tme"], s["beta"], s["L"]
        bt, bk, bi, row_t = closest(ro, rd, tme)
        bt, bk, bi = media_pass(data, meta, qf, ro, rd, seed, pixel, sample,
                                bounce, T_MIN, bt, bk, bi)
        out = finalize_and_shade(data, meta, qf, table, mat_cols, ro, rd,
                                 tme, bt, bk, bi, seed, pixel, sample,
                                 bounce, row_t=row_t)

        miss = act & ~out.hit
        lterm = act & out.hit & ~out.scatter_ok
        cont = act & out.hit & out.scatter_ok

        L = L + v3.where(miss, beta * bg_v, 0.0)
        L = L + v3.where(lterm, beta * out.emission, 0.0)
        L = L + v3.where(cont & ~out.skip_pdf, beta * out.emission, 0.0)
        beta = v3.where(cont, beta * out.weight, beta)
        ro = v3.where(cont, out.p, ro)
        rd = v3.where(cont, out.new_dir, rd)
        bounce = torch.where(cont, bounce + 1, bounce)
        path_on = cont & (bounce < cam.bounce_limit)

        # fold the finished path into the lane's chunk sum and respawn on
        # the next sample of the chunk, inside the window
        path_done = act & ~path_on
        s["Lsum"] = s["Lsum"] + v3.where(path_done, L, 0.0)
        more = path_done & (sample + 1 < s["send"])
        sample = torch.where(more, sample + 1, sample)
        ro_n, rd_n, t_n = get_rays_soa(cam, basis, seed, pixel, sample,
                                       no_defocus=no_defocus)
        s["ro"] = v3.where(more, ro_n, ro)
        s["rd"] = v3.where(more, rd_n, rd)
        s["tme"] = torch.where(more, t_n, tme)
        s["bounce"] = torch.where(more, 0, bounce)
        s["L"] = v3.where(more, 0.0, L)
        s["beta"] = v3.where(more, 1.0, beta)
        s["sample"] = sample
        s["alive"] = path_on | more

    def round_():
        s = dict(lanes)
        # --- deposit chunk sums finished in the previous window ---
        pend = s["pend"]
        _deposit(fbx, pend, s["pixel"], s["Lsum"], inv_spp, state["drop"])
        Lsum = v3.where(pend, 0.0, s["Lsum"])

        # --- refill idle lanes with fresh chunk-tasks ---
        alive = s["alive"]
        idle = ~alive
        ranks = torch.cumsum(idle.to(torch.int64), 0) - 1
        task = counter + torch.where(idle, ranks, 0)
        has = idle & (task < total)
        new_pixel = task % per
        if n_shards > 1:
            has = has & (to_global(new_pixel) < WH)
        s0 = torch.div(task, per, rounding_mode="floor") * spt
        pixel = torch.where(has, new_pixel, s["pixel"])
        sample = torch.where(has, s0, s["sample"])
        s["send"] = torch.where(has, torch.clamp(s0 + spt, max=spp),
                                s["send"])
        ro_n, rd_n, t_n = get_rays_soa(cam, basis, seed, to_global(pixel),
                                       sample, no_defocus=no_defocus)
        s["ro"] = v3.where(has, ro_n, s["ro"])
        s["rd"] = v3.where(has, rd_n, s["rd"])
        s["tme"] = torch.where(has, t_n, s["tme"])
        s["bounce"] = torch.where(has, 0, s["bounce"])
        s["L"] = v3.where(has, 0.0, s["L"])
        s["Lsum"] = v3.where(has, 0.0, Lsum)
        s["beta"] = v3.where(has, 1.0, s["beta"])
        s["pixel"], s["sample"] = pixel, sample
        s["alive"] = alive | has
        counter.add_(idle.sum())

        entering = s["alive"]
        for _ in range(window):
            bounce_step(s)
        # lanes whose chunk completed during the window deposit next round
        s["pend"] = entering & ~s["alive"]
        for k, x in s.items():
            if isinstance(x, V3):
                for dst, src in zip(lanes[k], x):
                    dst.copy_(src)
            else:
                lanes[k].copy_(x)
        state["go"].copy_(torch.stack([counter < total, lanes["alive"].any(),
                                       lanes["pend"].any()]).any())

    return round_, state


def _start_span(state: dict, fb: torch.Tensor, seed: int, task_start: int,
                task_end: int) -> None:
    """Fill ``_make_round``'s static tensors for the span [task_start,
    task_end) accumulating onto ``fb`` [per, 3]: every lane idle (rd and
    beta 1, every other field 0), ``fb`` into the image rows and zeros
    into the drop rows, the seed, the bounds and the counts.  Writes in
    place with Python scalars and device copies only: no host read."""
    for k, x in state["lanes"].items():
        for t in x if isinstance(x, V3) else (x,):
            t.fill_(1 if k in _LANE_ONES else 0)
    per = fb.shape[0]
    state["fb"][:per].copy_(fb)
    state["fb"][per:].zero_()
    state["seed"].fill_(int(seed) & 0xFFFFFFFF)
    state["total"].fill_(task_end)
    state["counter"].fill_(task_start)
    state["useful"].zero_()
    state["go"].fill_(task_start < task_end)


# the kept span program; its drop is ``drop_graph``
_program = graphs.KeptProgram(graph_count, copy_in="wavefront.copy_in",
                              warm="wavefront.warm", launch="wavefront.launch")
drop_graph = _program.drop


@metrics.spanned("wavefront.span")
def _span_core(ops: SpanOperands, meta: SceneMeta, seed: int,
               fb: torch.Tensor, task_start: int, task_end: int, *,
               pool: int, window: int, spt: int, use_kernel: bool,
               no_defocus: bool, per: int, n_shards: int, shard_id: int,
               eager: bool = False):
    """Run the wavefront over local chunk-tasks [task_start, task_end),
    accumulating into ``fb`` [per, 3] in place.  Returns
    (iterations, useful_segments) as Python ints.

    ``per``/``n_shards``/``shard_id``: local pixel count and round-robin
    shard placement — local pixel p is global pixel p*n_shards+shard_id
    (identity when n_shards == 1).  Rays and RNG use the global id; padding
    pixels (global id >= W*H) are consumed but never activated.

    On a CUDA device the round is the unit "round" of the module's
    ``graphs.KeptProgram`` (the counterpart of ``jax.jit(_wavefront_span)``
    and its cache), entered once a span.  Its key: the device, ``meta``,
    ``pool``, ``window``, ``spt``, ``per``, ``n_shards``, ``shard_id``,
    ``use_kernel``, ``no_defocus`` and the layout of ``ops`` (shapes, the
    camera's static fields, the pack's sizes and accel mode: "cull"'s and
    "bvh"'s tables depend on the data; "none"'s quad rows off their axes).
    The loop condition is read on the host once a round.  A failure
    anywhere in the span drops the key.  Spans: the program's "wavefront.copy_in", "wavefront.warm" and "wavefront.launch",
    "wavefront.start" (``_start_span``), the loop's (``_loop``) and
    "wavefront.drain" (the image's copy out and the useful count's host
    read).
    ``eager`` (private: the card tests and chip_smoke.py compare the two
    routes with it) runs every round eagerly over ``ops``, as the CPU
    always does; both routes run the same ops on the same values."""
    round_kw = dict(pool=pool, window=window, spt=spt, use_kernel=use_kernel,
                    no_defocus=no_defocus, per=per, n_shards=n_shards,
                    shard_id=shard_id)
    dev = fb.device
    graph_count["spans"] += 1
    if graphs.graph_route(dev, eager):
        key = (dev, meta, pool, window, spt, per, n_shards, shard_id,
               use_kernel, no_defocus, graphs.layout(ops))

        def build(statics):
            round_, state = _make_round(statics, meta, **round_kw)
            return state, {"round": round_}
        kept = _program.entered(key, ops, build, dev)

        def run():
            return _program.run("round")[1]
    else:
        run, state = _make_round(ops, meta, **round_kw)
        kept = contextlib.nullcontext(state)
    with kept as state:
        with metrics.span("wavefront.start"):
            _start_span(state, fb, seed, task_start, task_end)
        iters = _loop(state, run)
        with metrics.span("wavefront.drain"):
            fb.copy_(state["fb"][:per])
            graph_count["syncs"] += 1
            useful = int(state["useful"])
    return iters, useful


def _loop(state: dict, run) -> int:
    """``run()`` rounds while the loop condition holds, read on the host
    once a round (one sync, the span "wavefront.read"); returns the rounds
    run.  ``run()`` returns a replayed round's timing events
    (``graphs.capture``) or None: the read after such a round has waited
    for it, so its device time is read there into the counter
    "wavefront.round_device_ns", and its period on the host's clock, from
    the end of the read before its launch to the end of the read after
    it, into "wavefront.round_period_ns"."""
    iters = 0
    stamps = last = None
    while True:
        graph_count["syncs"] += 1
        with metrics.span("wavefront.read") as read:
            go = bool(state["go"])
        if stamps is not None:
            metrics.count("wavefront.round_device_ns",
                          metrics.elapsed_ns(*stamps))
            metrics.count("wavefront.round_period_ns", read.end - last)
        if not go:
            return iters
        last = read.end
        stamps = run()
        iters += 1
        graph_count["rounds"] += 1


def default_pool(meta: SceneMeta, n_pixels: int) -> int:
    n_prims = max(1, meta.n_spheres + meta.n_quads)
    pool = 1 << 18 if n_prims <= 1024 else 1 << 16
    return min(pool, max(1024, -(-n_pixels // 1024) * 1024))


@metrics.spanned("wavefront.call")
def render_wavefront(data: SceneData, meta: SceneMeta, cam: Camera,
                     device: torch.device | str | None = None,
                     seed=DEFAULT_SEED, pool=None,
                     max_paths_per_call=200_000_000, fb=None,
                     task_range=None, scrub_nan=True, window=None, spt=None,
                     use_kernel=None, accel=None, mesh=None,
                     layer_range=None, return_stats=False, chunk=512):
    """Wavefront render on ``device`` (None: the card, ``require_cuda``, or
    the mesh's device); returns linear [H,W,3] float32 (row 0 = bottom).

    The task space — W*H pixels x ceil(spp/spt) sample-chunks — is split
    into spans of at most ``max_paths_per_call`` camera paths.  ``fb`` (a
    tensor or a numpy array of W*H x 3 floats, copied onto the device) /
    ``task_range`` (in chunk-task units) allow external accumulation; pass
    ``scrub_nan=False`` to get the raw accumulator back.

    ``layer_range`` (in sample-chunk layers: layer c is the tasks
    [c*W*H, (c+1)*W*H)) replaces ``task_range`` for progressive
    accumulation; spans are then layer-aligned, so each pixel deposits
    exactly once per layer and a resumed render is bit-identical to an
    uninterrupted one.

    ``mesh`` (``parallel.mesh.make_mesh``): pixels are dealt
    round-robin over its ranks (module docstring) and every rank gets the
    whole image; spans are always layer-aligned (``layer_range``, default
    every layer; ``task_range`` raises), ``fb`` and the result are in
    canonical pixel order, so a render checkpointed on one mesh size
    resumes on any other, and the image is bit-identical for any mesh size
    and to the render without a mesh with ``layer_range=(0, n_chunks)``.

    ``use_kernel``: None (default) runs the CUDA closest-hit kernel on a
    CUDA device and its plain version on the CPU; False forces the plain
    version (on any device, to compare against the kernel); True on a CPU
    device raises.

    ``accel``: the closest-hit kernel's mode — ``"none"``, ``"cull"`` or
    ``"bvh"`` (the JAX package's ``pallas_accel``); None picks
    ``closest_hit.auto_accel`` of the primitive count ("bvh" above 8192).
    Every mode gives the same closest hits.

    The call is the span "wavefront.call"; "wavefront.operands" holds the
    scene's and camera's moves to the device and ``span_operands``, and
    each span of the task space is "wavefront.span" (``_span_core``).

    ``chunk``: accepted for the JAX package's signature, whose XLA
    intersector scans primitives in chunks of this size; the closest-hit
    kernel has no such chunk, so it changes nothing (the image is bit-equal
    for any value).

    ``return_stats``: return ``(img, stats)`` with ``iterations``,
    ``useful_segments`` and ``slots_executed``; with a mesh also
    ``per_shard_useful`` (the useful segments of each rank) and
    ``collectives`` (the collectives the call ran, by purpose: none in
    its spans, the image's gather and the stats' own).  With a mesh,
    ``iterations`` is the sum over spans of the largest rank's rounds
    (the JAX package's rule: a span lasts as long as its slowest rank)
    and ``slots_executed`` counts every rank's rounds.
    """
    if mesh is not None:
        device = check_mesh(mesh, device)
        if task_range is not None:
            raise ValueError("use layer_range with a mesh")
        n, sid = mesh.size, mesh.rank
    else:
        device = require_cuda() if device is None else torch.device(device)
        n, sid = 1, 0
    if accel is None:
        accel = ch.auto_accel(meta.n_spheres + meta.n_quads)
    elif accel not in ch.ACCELS:
        raise ValueError(f"accel must be one of {ch.ACCELS} or None, got "
                         f"{accel!r}")
    if use_kernel is None:
        use_kernel = device.type == "cuda"
    elif use_kernel and device.type != "cuda":
        raise ValueError("use_kernel=True needs a CUDA device")
    W, H = cam.image_width, cam.image_height
    WH = W * H
    per = -(-WH // n)
    spp = cam.sqrt_spp ** 2
    if spt is None:
        spt = min(spp, 4 if cam.bounce_limit >= 32 else 8)
    if window is None:
        deep = cam.bounce_limit >= 32
        window = (4 if deep else 8) if use_kernel else 3
        if spp == 1:
            window = min(window, 3)
    n_chunks = -(-spp // spt)
    no_defocus = bool(cam.defocus_angle.item() <= 0.0)
    if pool is None:
        pool = default_pool(meta, per)
    if fb is not None:
        fb = torch.as_tensor(fb).reshape(WH, 3).to(
            device=device, dtype=torch.float32, copy=True)
    if mesh is None:
        if fb is None:
            fb = torch.zeros((WH, 3), dtype=torch.float32, device=device)
    else:
        # this rank's local pixels p are the global pixels p*n + sid
        gpix = torch.arange(per, device=device) * n + sid
        gpix = gpix[gpix < WH]
        local = torch.zeros((per, 3), dtype=torch.float32, device=device)
        if fb is not None:
            local[:len(gpix)] = fb[gpix]
        fb = local
        if layer_range is None:
            layer_range = (0, n_chunks)
    tasks_per_call = max(pool, max_paths_per_call // spt)
    if layer_range is not None:
        if task_range is not None:
            raise ValueError("layer_range and task_range are exclusive")
        spans = [(s0, min(s0 + tasks_per_call, (c + 1) * per))
                 for c in range(*layer_range)
                 for s0 in range(c * per, (c + 1) * per, tasks_per_call)]
    else:
        start, end = (task_range if task_range is not None
                      else (0, WH * n_chunks))
        spans = [(s0, min(s0 + tasks_per_call, end))
                 for s0 in range(start, end, tasks_per_call)]

    with metrics.span("wavefront.operands"):
        data = data.to(device)
        cam = cam.to(device)
        ops = span_operands(data, meta, cam, accel)
    rounds = []         # this rank's rounds, one entry a span
    useful = 0
    before = sum(mesh.collectives.values()) if mesh is not None else 0
    for s0, s1 in spans:
        it, us = _span_core(
            ops, meta, int(seed), fb, s0, s1, pool=int(pool),
            window=int(window), spt=int(spt), use_kernel=bool(use_kernel),
            no_defocus=no_defocus, per=per, n_shards=n, shard_id=sid)
        rounds.append(it)
        useful += us
    # each span's rounds and the useful segments, one column a rank (with
    # a mesh summed into place; every rank has the same spans)
    per_rank = torch.zeros((len(spans) + 1, n), dtype=torch.int64)
    per_rank[:, sid] = torch.tensor(rounds + [useful])
    if mesh is not None:
        out = torch.zeros((WH, 3), dtype=torch.float32, device=device)
        out[gpix] = fb[:len(gpix)]
        fb = out
        sent = {"spans": sum(mesh.collectives.values()) - before,
                "gather": _all_reduce(mesh, fb, "gather")}
        if return_stats:
            per_rank = per_rank.to(device)
            sent["stats"] = _all_reduce(mesh, per_rank, "stats")
    *it_r, us_r = per_rank.tolist()
    stats = {"iterations": sum(max(r) for r in it_r),
             "useful_segments": sum(us_r),
             "slots_executed": sum(map(sum, it_r)) * int(window) * int(pool)}
    if mesh is not None:
        stats.update(per_shard_useful=us_r, collectives=sent)
    if scrub_nan:
        fb = torch.where(torch.isnan(fb), 0.0, fb)
    img = fb.reshape(H, W, 3)
    return (img, stats) if return_stats else img
