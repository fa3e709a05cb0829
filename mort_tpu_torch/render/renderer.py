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

import numpy as np
import torch

from ..camera import Camera, derive_basis
from ..device import require_cuda
from ..rng import DEFAULT_SEED
from ..scene.build import SceneData, SceneMeta
from .integrator import prepack, trace
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
    (``parallel.sharding.make_train_step``)."""
    spp = cam.sqrt_spp * cam.sqrt_spp
    if n_samples is None:
        n_samples = spp
    if use_kernel is None:
        use_kernel = pixel_ids.device.type == "cuda"
    basis = derive_basis(cam)
    qf = quad_frames(data)
    prepacked = prepack(data, meta, qf, use_kernel, accel, off_axis)
    P = pixel_ids.shape[0]
    acc = torch.zeros((P, 3), dtype=torch.float32, device=pixel_ids.device)
    for s in range(sample_offset, sample_offset + n_samples):
        sample_ids = torch.full_like(pixel_ids, s)
        acc = acc + trace(data, meta, qf, cam, basis, seed, pixel_ids,
                          sample_ids, prepacked, chunk=chunk,
                          differentiable=differentiable)
    # the mean uses pixel_samples_scale = 1/sqrt_spp^2 (camera.cuh:52), so
    # partial accumulations sum to the reference estimator
    return acc * (1.0 / spp)


def render(data: SceneData, meta: SceneMeta, cam: Camera, seed=DEFAULT_SEED,
           ray_batch=None, chunk=512, differentiable=False, use_kernel=None,
           device=None):
    """Render the scene on ``device`` (None: the card, ``require_cuda``);
    returns the linear radiance image [H, W, 3] float32 (row 0 = bottom).
    Without ``differentiable`` the render runs under ``torch.no_grad``."""
    device = require_cuda() if device is None else torch.device(device)
    data = data.to(device)
    cam = cam.to(device)
    W, H = cam.image_width, cam.image_height
    WH = W * H
    if ray_batch is None:
        ray_batch = _pick_ray_batch(meta, WH)
    B = min(int(ray_batch), WH)
    n_batches = -(-WH // B)
    grad = contextlib.nullcontext() if differentiable else torch.no_grad()
    with grad:
        parts = []
        for i in range(n_batches):
            pix = torch.arange(B, dtype=torch.int64, device=device) + i * B
            pix = torch.clamp(pix, max=WH - 1)  # the tail repeats a pixel
            parts.append(radiance_for_pixels(
                data, meta, cam, int(seed), pix, chunk=chunk,
                differentiable=differentiable, use_kernel=use_kernel))
        fb = torch.cat(parts)[:WH]
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
