"""Top-level lockstep render: pixel batches, strata, post-processing.

The port of ``mort_tpu.render.renderer``: pixel batches x stratified
samples, radiance accumulated in a float32 framebuffer.  Post-processing
matches camera.cuh:194-207: mean over sqrt_spp^2 samples, NaN scrub,
gamma 2 (sqrt, utils.h:41-43), clamp to [0, 0.999], u8 pack.

The framebuffer convention is [H, W, 3] with row 0 at the *bottom* (the
reference renders into a bottom-up GL buffer); image writers flip.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from ..camera import Camera, derive_basis
from ..device import require_cuda
from ..rng import DEFAULT_SEED
from ..scene.build import SceneData, SceneMeta
from . import closest_hit as ch
from . import graphs
from .integrator import (
    bounce_once, lockstep_graph_count, make_lanes, prepack, start_sample,
    trace,
)
from .intersect import quad_frames


def _pick_ray_batch(meta: SceneMeta, n_pixels: int) -> int:
    """Heuristic ray batch size: keeps [batch, chunk] intermediates of the
    ``intersect_best`` route at tens of MB."""
    n_prims = max(meta.n_spheres + meta.n_quads, 1)
    if n_prims <= 64:
        b = 1 << 17
    elif n_prims <= 1024:
        b = 1 << 16
    else:
        b = 1 << 15
    return min(b, max(1024, n_pixels))


def radiance_for_pixels(data: SceneData, meta: SceneMeta, cam: Camera,
                        seed: int, pixel_ids, chunk=512, differentiable=False,
                        sample_offset=0, n_samples=None, use_kernel=None,
                        accel=None, off_axis=None):
    """Mean radiance over ``n_samples`` stratified samples for a flat pixel
    id tensor [P] -> [P, 3], on ``pixel_ids``' device (where ``data`` and
    ``cam`` must lie).  ``sample_offset`` allows progressive accumulation
    across calls.  The scene is packed once, above the sample loop.

    ``use_kernel`` (the JAX package's ``use_pallas``): True sends the
    closest hit through ``closest_hit.closest_hit``, an autograd Function
    that launches the CUDA kernel on a CUDA tensor and takes its plain
    version on a CPU tensor (as the JAX package runs its kernel by
    interpreter on the CPU); False sends it through
    ``intersect.intersect_best`` under plain autograd; None is True on a
    card and False on the CPU (the JAX default).  Unlike
    ``render_wavefront``, where ``use_kernel=True`` on the CPU raises, here
    it selects the Function's plain version.  ``accel``: the kernel's mode
    (None picks ``closest_hit.auto_accel``).  ``off_axis``: as in
    ``closest_hit.pack_scene``.

    ``seed``: an int, or an int64 tensor of one element (``rng.philox4x32``);
    with that and ``off_axis`` given, nothing here reads the host or makes
    a tensor from host data once the closest-hit library is loaded and the
    ``device.constant``s exist, so a CUDA graph can capture the call
    (the train step's, ``make_train_step``)."""
    if use_kernel is None:
        use_kernel = pixel_ids.device.type == "cuda"
    qf = quad_frames(data)
    prepacked = prepack(data, meta, qf, use_kernel, accel, off_axis)
    return _radiance(data, meta, qf, cam, derive_basis(cam), prepacked, seed,
                     pixel_ids, chunk, differentiable,
                     _samples(cam, sample_offset, n_samples))


def _samples(cam: Camera, sample_offset, n_samples) -> range:
    """The sample ids of a call: ``n_samples`` (None: all sqrt_spp^2) from
    ``sample_offset``."""
    if n_samples is None:
        n_samples = cam.sqrt_spp * cam.sqrt_spp
    return range(sample_offset, sample_offset + n_samples)


def _radiance(data, meta, qf, cam, basis, prepacked, seed, pixel_ids, chunk,
              differentiable, samples):
    """``radiance_for_pixels``' sample loop over a packed scene (eager)."""
    acc = torch.zeros((pixel_ids.shape[0], 3), dtype=torch.float32,
                      device=pixel_ids.device)
    for s in samples:
        sample_ids = torch.full_like(pixel_ids, s)
        acc = acc + trace(data, meta, qf, cam, basis, seed, pixel_ids,
                          sample_ids, prepacked, chunk=chunk,
                          differentiable=differentiable)
    # the mean uses pixel_samples_scale = 1/sqrt_spp^2 (camera.cuh:52), so
    # partial accumulations sum to the reference estimator
    return acc * (1.0 / (cam.sqrt_spp * cam.sqrt_spp))


# the kept lockstep units, "start" and "bounce"
_program = graphs.KeptProgram(lockstep_graph_count)


def radiance_batches(data: SceneData, meta: SceneMeta, cam: Camera,
                     seed: int, pixel_ids, batch: int, chunk=512,
                     differentiable=False, sample_offset=0, n_samples=None,
                     use_kernel=None, accel=None, eager=False):
    """``radiance_for_pixels`` of the flat pixel ids ``pixel_ids`` [P] ->
    [P, 3], in batches of ``batch`` pixels (the last padded by repeating
    its last id: lanes are independent, so real lanes keep their bits and
    every batch has one shape), the scene packed once for all: the
    lockstep forward of ``render``, ``render_progressive`` and
    ``render_sharded``.

    On a card it is the counterpart of the JAX package's jitted
    ``_render_flat``, progressive ``_step`` and ``_sharded_radiance``, two
    captured units replayed from CUDA graphs (``integrator.start_sample``
    and ``integrator.bounce_once`` over static ``integrator.Lanes``).  For
    each batch and sample the host replays "start", then, for at most
    ``cam.bounce_limit`` bounces, reads ``alive.any()`` and stops once it
    is false, else replays "bounce": the eager route's bounces and its one
    host read a bounce, so its closest-hit launches too.  The sum over
    samples is one eager add a sample.  With ``differentiable`` (which
    ``render_sharded`` passes through; its result is a detached image)
    every bounce runs with no read, as the eager differentiable loop does.

    The two units are the module's ``graphs.KeptProgram`` over the scene,
    camera and pack; each call then fills the seed's int64 device scalar
    and each batch's pixel ids.  The key: the device, ``meta``, ``batch``,
    ``chunk``, ``closest_hit.aaq_off_axis`` (one host read a call on
    "none") and the layout of the scene, the camera and the pack (shapes,
    the camera's static fields, the route and accel mode; "cull"'s and
    "bvh"'s tables depend on the data).  A failure anywhere in the call
    drops the key.  Results are fresh tensors.

    Eager, as ``radiance_for_pixels`` per batch: the CPU, ``eager`` (the
    card tests and chip_smoke.py compare the routes with it; ``render``
    passes it for ``differentiable=True``, whose result carries autograd
    history) and a call made while a stream is capturing.
    ``lockstep_graph_count`` counts bounces and host reads on both routes
    (without ``differentiable``), and captures, recaptures, replays and
    capture seconds."""
    dev = pixel_ids.device
    if use_kernel is None:
        use_kernel = dev.type == "cuda"
    if use_kernel and accel is None:
        accel = ch.auto_accel(meta.n_spheres + meta.n_quads)
    samples = _samples(cam, sample_offset, n_samples)
    qf = quad_frames(data)
    off_axis = None
    if use_kernel and accel == "none":
        with torch.no_grad():
            off_axis = ch.aaq_off_axis(meta, ch.quad_records(data, qf))
    ops = (data, qf, cam, derive_basis(cam),
           prepack(data, meta, qf, use_kernel, accel, off_axis))
    P = pixel_ids.shape[0]
    pad = -P % batch
    if pad:
        pixel_ids = torch.cat([pixel_ids, pixel_ids[-1:].expand(pad)])
    batches = pixel_ids.split(batch)
    # a call made inside another capture (``make_train_step``'s) stays in
    # that one
    if (not graphs.graph_route(dev, eager)
            or torch.cuda.is_current_stream_capturing()):
        data, qf, cam, basis, prepacked = ops
        return torch.cat([_radiance(data, meta, qf, cam, basis, prepacked,
                                    seed, pix, chunk, differentiable, samples)
                          for pix in batches])[:P]
    key = (dev, meta, batch, chunk, off_axis, graphs.layout(ops))

    def build(statics):
        st = make_lanes(*statics, batch)
        return st, {"start": functools.partial(start_sample, st),
                    "bounce": functools.partial(bounce_once, st, meta, chunk)}
    with torch.no_grad(), _program.entered(key, ops, build, dev) as st:
        st.seed.fill_(int(seed) & 0xFFFFFFFF)
        out = []
        for pix in batches:
            st.pixel.copy_(pix)
            acc = torch.zeros((batch, 3), dtype=torch.float32, device=dev)
            for s in samples:
                st.sample.fill_(s)
                _program.run("start")
                for _ in range(cam.bounce_limit):
                    if not differentiable:
                        lockstep_graph_count["syncs"] += 1
                        if not bool(st.alive.any()):
                            break
                        lockstep_graph_count["bounces"] += 1
                    _program.run("bounce")
                acc = acc + st.L.to_rows()
            out.append(acc * (1.0 / (cam.sqrt_spp * cam.sqrt_spp)))
    return torch.cat(out)[:P]


def render(data: SceneData, meta: SceneMeta, cam: Camera, seed=DEFAULT_SEED,
           ray_batch=None, chunk=512, differentiable=False, use_kernel=None,
           device=None, _eager=False):
    """Render the scene on ``device`` (None: the card, ``require_cuda``);
    returns the linear radiance image [H, W, 3] float32 (row 0 = bottom).
    Without ``differentiable`` the render runs under ``torch.no_grad`` and,
    on a card, replays the lockstep's CUDA graphs (``radiance_batches``;
    ``_eager``, private to the card tests and chip_smoke.py, takes the
    eager route)."""
    device = require_cuda() if device is None else torch.device(device)
    data = data.to(device)
    cam = cam.to(device)
    W, H = cam.image_width, cam.image_height
    WH = W * H
    if ray_batch is None:
        ray_batch = _pick_ray_batch(meta, WH)
    grad = contextlib.nullcontext() if differentiable else torch.no_grad()
    with grad:
        fb = radiance_batches(
            data, meta, cam, int(seed),
            torch.arange(WH, dtype=torch.int64, device=device),
            min(int(ray_batch), WH), chunk=chunk,
            differentiable=differentiable, use_kernel=use_kernel,
            eager=_eager or differentiable)
        # NaN scrub (camera.cuh:196-198)
        fb = torch.where(torch.isnan(fb), 0.0, fb)
    return fb.reshape(H, W, 3)


def to_u8(linear_img: torch.Tensor) -> torch.Tensor:
    """Gamma 2 + clamp + u8 pack (camera.cuh:200-207, utils.h:41-43)."""
    g = torch.sqrt(torch.clamp(linear_img, min=0.0))
    return (256.0 * torch.clamp(g, 0.0, 0.999)).to(torch.uint8)


def to_u8_np(linear_img) -> np.ndarray:
    """``to_u8`` of a tensor or array, as a numpy array."""
    img = torch.as_tensor(np.asarray(linear_img, np.float32)) \
        if not isinstance(linear_img, torch.Tensor) else linear_img
    return to_u8(img).cpu().numpy()
