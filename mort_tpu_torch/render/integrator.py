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
"""

from __future__ import annotations

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
    use_kernel = prepacked.packed is not None
    table, mat_cols = prepacked.table, prepacked.mat_cols
    ro, rd, time = get_rays_soa(cam, basis, seed, pixel_ids, sample_ids)
    R = pixel_ids.shape[0]
    bg = cam.background
    bg_v = V3(bg[0], bg[1], bg[2])

    def fold(bounce, L, beta, alive, ro, rd, bt, bk, bi, row_t):
        """Everything after the closest hit: media, shading, the radiance
        fold."""
        if use_kernel and meta.media:
            bt, bk, bi = media_pass(data, meta, qf, ro, rd, seed, pixel_ids,
                                    sample_ids, bounce, T_MIN, bt, bk, bi)
        out = finalize_and_shade(data, meta, qf, table, mat_cols, ro, rd,
                                 time, bt, bk, bi, seed, pixel_ids,
                                 sample_ids, bounce, row_t=row_t)
        miss = alive & ~out.hit
        L = L + v3.where(miss, beta * bg_v, 0.0)
        terminated = alive & out.hit & ~out.scatter_ok
        L = L + v3.where(terminated, beta * out.emission, 0.0)
        cont = alive & out.hit & out.scatter_ok
        # skip_pdf bounces store zero emission (camera.cuh:107-110)
        L = L + v3.where(cont & ~out.skip_pdf, beta * out.emission, 0.0)
        beta = v3.where(cont, beta * out.weight, beta)
        ro = v3.where(cont, out.p, ro)
        rd = v3.where(cont, out.new_dir, rd)
        return L, beta, cont, ro, rd

    L, beta = V3.zeros(R, dev), V3.ones(R, dev)
    alive = torch.ones(R, dtype=torch.bool, device=dev)
    for bounce in range(cam.bounce_limit):
        if not differentiable and not bool(alive.any()):
            break
        if use_kernel:
            bt, bk, bi, row_t = ch.closest_hit(prepacked.packed, ro, rd, time)
        else:
            bt, bk, bi = intersect_best(data, meta, qf, ro.to_rows(),
                                        rd.to_rows(), time, seed, pixel_ids,
                                        sample_ids, bounce, chunk=chunk)
            row_t = None
        args = (bounce, L, beta, alive, ro, rd, bt, bk, bi, row_t)
        if differentiable:
            L, beta, alive, ro, rd = checkpoint(
                fold, *args, use_reentrant=False, preserve_rng_state=False)
        else:
            L, beta, alive, ro, rd = fold(*args)
    return L.to_rows()
