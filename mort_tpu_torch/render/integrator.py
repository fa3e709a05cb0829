"""Lockstep path integrator: one camera sample for a batch of pixels.

The port of ``mort_tpu.render.integrator.trace``.  The reference's
per-thread recursion (camera.cuh:86-176) is folded *forward*:

    L_0 = 0,  beta_0 = 1
    at bounce i:   L += beta_i * E_i ;   beta_{i+1} = beta_i * A_i*spdf_i/pdf_i
    on miss:       L += beta * background          (camera.cuh:154-158)
    on no-scatter: L += beta * emission, terminate (camera.cuh:148-151)
    depth exhausted: tail contributes 0            (camera.cuh:161-163)

All rays advance in lockstep with masked lanes.  ``jax.lax.while_loop`` /
``fori_loop`` become Python loops: without a gradient the loop stops once
no lane is alive (one host read per bounce); with one it runs exactly
``cam.bounce_limit`` bounces.

``trace`` runs the loop eagerly.  ``Lanes``, ``start_sample`` and
``bounce_once`` are the same loop cut into the two units that
``renderer.radiance_batches`` captures into CUDA graphs on a card: one
sample's start and one bounce, each writing static tensors in place, the
bounce index a device scalar.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
from torch.utils.checkpoint import checkpoint

from ..camera import Camera, CameraBasis, get_rays_soa
from ..scene.build import SceneData, SceneMeta
from . import closest_hit as ch
from . import vec as v3
from .hitshade import finalize_and_shade
from .intersect import T_MIN, QuadFrames, intersect_best, media_pass
from .primtable import build_prim_table
from .vec import V3

# What the lockstep forward did since import (or since a caller reset
# them): bounces run and host reads of the loop condition (``alive.any()``)
# by the forward traces of both routes, and, on the graph route
# (``renderer.radiance_batches``), CUDA graphs captured, captures that
# replaced another key's graphs, replays and seconds spent capturing.
lockstep_graph_count = {"bounces": 0, "syncs": 0, "captures": 0,
                        "recaptures": 0, "replays": 0, "capture_s": 0.0}


@dataclass(frozen=True)
class Prepacked:
    """The per-scene operands of ``trace``, built once per step (not per
    sample or bounce): the joined table, the material columns and, on the
    kernel route, the closest hit's packed records."""
    table: torch.Tensor
    mat_cols: torch.Tensor
    packed: ch.PackedScene | None


def prepack(data: SceneData, meta: SceneMeta, qf: QuadFrames,
            use_kernel: bool, accel: str | None = None,
            off_axis=None) -> Prepacked:
    """``accel``: the kernel's mode (None picks ``closest_hit.auto_accel``);
    ``off_axis``: as in ``closest_hit.pack_scene``."""
    table, mat_cols = build_prim_table(data, meta, qf)
    packed = None
    if use_kernel:
        if accel is None:
            accel = ch.auto_accel(meta.n_spheres + meta.n_quads)
        packed = ch.pack_scene(data, meta, qf, table, accel, off_axis)
    return Prepacked(table, mat_cols, packed)


def _closest(data, meta, qf, prepacked, seed, pixel_ids, sample_ids, bounce,
             ro, rd, time, chunk):
    """The closest hit of one bounce (t, kind, idx, row_t or None): the
    ``closest_hit`` Function where ``prepacked`` carries a
    ``PackedScene``, else ``intersect_best`` (media included)."""
    if prepacked.packed is not None:
        return ch.closest_hit(prepacked.packed, ro, rd, time)
    bt, bk, bi = intersect_best(data, meta, qf, ro.to_rows(), rd.to_rows(),
                                time, seed, pixel_ids, sample_ids, bounce,
                                chunk=chunk)
    return bt, bk, bi, None


def _fold(data, meta, qf, prepacked, cam, seed, pixel_ids, sample_ids,
          time, bounce, L, beta, alive, ro, rd, bt, bk, bi, row_t):
    """Everything after the closest hit: media (on the kernel route),
    shading, the radiance fold; returns the next (L, beta, alive, ro,
    rd)."""
    if prepacked.packed is not None and meta.media:
        bt, bk, bi = media_pass(data, meta, qf, ro, rd, seed, pixel_ids,
                                sample_ids, bounce, T_MIN, bt, bk, bi)
    out = finalize_and_shade(data, meta, qf, prepacked.table,
                             prepacked.mat_cols, ro, rd, time, bt, bk, bi,
                             seed, pixel_ids, sample_ids, bounce, row_t=row_t)
    bg = cam.background
    miss = alive & ~out.hit
    L = L + v3.where(miss, beta * V3(bg[0], bg[1], bg[2]), 0.0)
    terminated = alive & out.hit & ~out.scatter_ok
    L = L + v3.where(terminated, beta * out.emission, 0.0)
    cont = alive & out.hit & out.scatter_ok
    # skip_pdf bounces store zero emission (camera.cuh:107-110)
    L = L + v3.where(cont & ~out.skip_pdf, beta * out.emission, 0.0)
    beta = v3.where(cont, beta * out.weight, beta)
    ro = v3.where(cont, out.p, ro)
    rd = v3.where(cont, out.new_dir, rd)
    return L, beta, cont, ro, rd


def trace(data: SceneData, meta: SceneMeta, qf: QuadFrames, cam: Camera,
          basis: CameraBasis, seed: int, pixel_ids, sample_ids,
          prepacked: Prepacked, chunk=512, differentiable=False):
    """Trace one camera sample for a batch of pixels; returns radiance [R,3].

    ``prepacked``: ``prepack``'s result, built once for all the samples of
    a scene.  Where it carries a ``PackedScene`` (the kernel route), the
    closest hit goes through ``closest_hit.closest_hit``, an autograd
    Function; otherwise through ``intersect.intersect_best`` under plain
    autograd.

    ``differentiable=True`` runs exactly ``cam.bounce_limit`` bounces and
    recomputes each bounce's post-hit part (media, shading, fold) in the
    backward (``torch.utils.checkpoint``) rather than saving it; the closest
    hit stays outside the checkpoint, so its backward reuses the saved
    winner.  The recompute redraws Philox from the same counters, so no
    random state is saved.
    """
    dev = pixel_ids.device
    ro, rd, time = get_rays_soa(cam, basis, seed, pixel_ids, sample_ids)
    R = pixel_ids.shape[0]
    scene = (data, meta, qf, prepacked)
    fold = functools.partial(_fold, *scene, cam, seed, pixel_ids, sample_ids,
                             time)
    L, beta = V3.zeros(R, dev), V3.ones(R, dev)
    alive = torch.ones(R, dtype=torch.bool, device=dev)
    for bounce in range(cam.bounce_limit):
        if not differentiable:
            lockstep_graph_count["syncs"] += 1
            if not bool(alive.any()):
                break
            lockstep_graph_count["bounces"] += 1
        hit = _closest(*scene, seed, pixel_ids, sample_ids, bounce, ro, rd,
                       time, chunk)
        args = (bounce, L, beta, alive, ro, rd, *hit)
        if differentiable:
            L, beta, alive, ro, rd = checkpoint(
                fold, *args, use_reentrant=False, preserve_rng_state=False)
        else:
            L, beta, alive, ro, rd = fold(*args)
    return L.to_rows()


@dataclass(frozen=True)
class Lanes:
    """The static operands of the captured lockstep units for a batch of B
    pixels: the scene, camera and pack (``data``, ``qf``, ``cam``,
    ``basis``, ``prepacked``), the seed, the sample and the bounce index
    (int64 device scalars), the pixel ids [B] and the lane state.  A
    replayed CUDA graph reads and writes the addresses it was captured
    with, so the units write these tensors in place and rebind nothing."""
    data: SceneData
    qf: QuadFrames
    cam: Camera
    basis: CameraBasis
    prepacked: Prepacked
    seed: torch.Tensor
    sample: torch.Tensor
    bounce: torch.Tensor
    pixel: torch.Tensor
    L: V3
    beta: V3
    alive: torch.Tensor
    ro: V3
    rd: V3
    time: torch.Tensor


def make_lanes(data: SceneData, qf: QuadFrames, cam: Camera,
               basis: CameraBasis, prepacked: Prepacked, B: int) -> Lanes:
    """``Lanes`` over the given scene operands (which become static: the
    caller passes copies it owns) with fresh lane tensors for B pixels."""
    dev = data.sph_center.device

    def scalar():
        return torch.zeros((), dtype=torch.int64, device=dev)

    def v3_lanes():
        return V3(*(torch.zeros(B, dtype=torch.float32, device=dev)
                    for _ in range(3)))

    return Lanes(data, qf, cam, basis, prepacked, seed=scalar(),
                 sample=scalar(), bounce=scalar(),
                 pixel=torch.zeros(B, dtype=torch.int64, device=dev),
                 L=v3_lanes(), beta=v3_lanes(),
                 alive=torch.zeros(B, dtype=torch.bool, device=dev),
                 ro=v3_lanes(), rd=v3_lanes(),
                 time=torch.zeros(B, dtype=torch.float32, device=dev))


def _store(dst: V3, src: V3) -> None:
    for d, s in zip(dst, src):
        d.copy_(s)


def start_sample(st: Lanes) -> None:
    """One sample's start (the captured unit "start"): the camera rays of
    ``st.pixel`` at sample ``st.sample``, L = 0, beta = 1, every lane
    alive, bounce 0; ``trace``'s ops before its loop."""
    ro, rd, time = get_rays_soa(st.cam, st.basis, st.seed, st.pixel,
                                st.sample.expand_as(st.pixel))
    _store(st.ro, ro)
    _store(st.rd, rd)
    st.time.copy_(time)
    for c in st.L:
        c.zero_()
    for c in st.beta:
        c.fill_(1.0)
    st.alive.fill_(True)
    st.bounce.zero_()


def bounce_once(st: Lanes, meta: SceneMeta, chunk: int) -> None:
    """One pass of ``trace``'s loop body (the captured unit "bounce"): the
    closest hit, the fold, then ``st.bounce += 1``, all on the device.  The
    bounce index is a tensor where ``trace`` passes an int: the Philox
    draws take it as a counter word with the int's bits."""
    sample = st.sample.expand_as(st.pixel)
    scene = (st.data, meta, st.qf, st.prepacked)
    hit = _closest(*scene, st.seed, st.pixel, sample, st.bounce, st.ro,
                   st.rd, st.time, chunk)
    L, beta, alive, ro, rd = _fold(*scene, st.cam, st.seed, st.pixel, sample,
                                   st.time, st.bounce, st.L, st.beta,
                                   st.alive, st.ro, st.rd, *hit)
    _store(st.L, L)
    _store(st.beta, beta)
    st.alive.copy_(alive)
    _store(st.ro, ro)
    _store(st.rd, rd)
    st.bounce.add_(1)
