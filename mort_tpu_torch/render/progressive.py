"""Progressive rendering with checkpoint/resume.

The port of ``mort_tpu.render.progressive``.  A render accumulates
stratified samples across steps in a float32 framebuffer and can checkpoint
and resume: the state is the partial sample sum plus the sample cursor, and
the counter-based RNG makes a resumed render bit-identical to an
uninterrupted one.  ``RenderState.fb`` is a numpy array [H, W, 3] in
canonical pixel order (row 0 = bottom) wherever the render ran, and a
checkpoint is an ``.npz`` with the JAX package's keys (``fb``,
``samples_done``, ``seed``, ``spp_total``), so a checkpoint written by
either package resumes in the other.

Both entry points run on ``device`` (None: the card, ``require_cuda``).
"""

from __future__ import annotations

import dataclasses
import os
import tempfile

import numpy as np
import torch

from ..camera import Camera
from ..device import require_cuda
from ..rng import DEFAULT_SEED
from ..scene.build import SceneData, SceneMeta
from .renderer import _pick_ray_batch, radiance_batches


@dataclasses.dataclass
class RenderState:
    """Accumulated partial render: sum of per-sample radiance scaled by
    1/spp_total, plus the next sample index."""
    fb: np.ndarray          # [H, W, 3] partial estimator (sums to the mean)
    samples_done: int
    seed: int
    spp_total: int = 0

    @property
    def image(self) -> np.ndarray:
        """Current estimate rescaled to a proper mean for previews."""
        if self.samples_done in (0, self.spp_total) or self.spp_total == 0:
            return self.fb
        return self.fb * (self.spp_total / self.samples_done)


def _start(cam: Camera, seed, state: RenderState | None) -> RenderState:
    spp = cam.sqrt_spp ** 2
    if state is None:
        state = RenderState(
            fb=np.zeros((cam.image_height, cam.image_width, 3), np.float32),
            samples_done=0, seed=int(seed), spp_total=spp)
    state.spp_total = spp
    if state.seed != int(seed):
        raise ValueError("resume must use the original seed")
    return state


def _step_done(state, step_idx, checkpoint_path, checkpoint_every, on_step):
    if checkpoint_path and step_idx % checkpoint_every == 0:
        save_state(checkpoint_path, state)
    if on_step is not None:
        on_step(state)


def _finish(state, checkpoint_path):
    state.fb = np.where(np.isnan(state.fb), 0.0, state.fb).astype(np.float32)
    if checkpoint_path:
        save_state(checkpoint_path, state)
    return state


def render_progressive(data: SceneData, meta: SceneMeta, cam: Camera,
                       seed=DEFAULT_SEED, samples_per_step=None,
                       state: RenderState | None = None,
                       checkpoint_path: str | None = None,
                       checkpoint_every=1, chunk=512, on_step=None,
                       device=None, _eager=False):
    """Render in sample-steps on the lockstep path
    (``renderer.radiance_batches``, pixels in batches of
    ``_pick_ray_batch``), optionally checkpointing after each.  On a card
    each step replays the lockstep's CUDA graphs, the counterpart of the
    JAX package's jitted ``_step`` (``_eager``, private to the card tests
    and chip_smoke.py, takes the eager route).

    Returns the final RenderState; ``state.fb`` is the NaN-scrubbed mean
    image once all spp are accumulated."""
    device = require_cuda() if device is None else torch.device(device)
    data = data.to(device)
    cam = cam.to(device)
    W, H = cam.image_width, cam.image_height
    WH = W * H
    spp = cam.sqrt_spp ** 2
    if samples_per_step is None:
        samples_per_step = max(1, cam.sqrt_spp)
    state = _start(cam, seed, state)
    B = min(_pick_ray_batch(meta, WH), WH)
    pix = torch.arange(WH, dtype=torch.int64, device=device)
    step_idx = 0
    while state.samples_done < spp:
        n = min(samples_per_step, spp - state.samples_done)
        with torch.no_grad():
            acc = radiance_batches(data, meta, cam, int(seed), pix, B,
                                   chunk=chunk,
                                   sample_offset=state.samples_done,
                                   n_samples=int(n), eager=_eager)
        acc = acc.cpu().numpy().reshape(H, W, 3)
        state.fb = state.fb + acc
        state.samples_done += n
        step_idx += 1
        _step_done(state, step_idx, checkpoint_path, checkpoint_every,
                   on_step)
    return _finish(state, checkpoint_path)


def render_progressive_wavefront(data: SceneData, meta: SceneMeta,
                                 cam: Camera, seed=DEFAULT_SEED, spt=None,
                                 layers_per_step=1,
                                 state: RenderState | None = None,
                                 checkpoint_path: str | None = None,
                                 checkpoint_every=1, mesh=None, on_step=None,
                                 device=None, **wf_kwargs):
    """Progressive accumulation on the wavefront path.

    The sample space is split into *layers* of ``spt`` stratified samples
    per pixel (``wavefront.py``); each step renders ``layers_per_step`` of
    them through ``render_wavefront``'s layer-aligned spans.  Each pixel
    receives exactly one framebuffer add per layer, so ``index_add_`` never
    sees one pixel twice in a call and a resumed render is bit-identical to
    an uninterrupted one wherever the interruption fell, on the card too.

    ``state.samples_done`` advances in whole layers (``spt`` samples each,
    ``spt`` defaulting to min(spp, 16)); resume must use the same ``seed``
    and ``spt``.  ``mesh`` (``parallel.mesh.make_mesh``) shards each
    step's pixels over its ranks (then ``device`` defaults to the mesh's);
    ``state.fb`` stays in canonical pixel order on every rank, so a render
    checkpointed on one mesh size resumes on another bit-identically.  Only
    rank 0 writes the checkpoint."""
    from .wavefront import render_wavefront

    if mesh is None:
        device = require_cuda() if device is None else torch.device(device)
    elif mesh.rank != 0:
        checkpoint_path = None
    W, H = cam.image_width, cam.image_height
    spp = cam.sqrt_spp ** 2
    if spt is None:
        spt = min(spp, 16)
    n_layers = -(-spp // spt)
    state = _start(cam, seed, state)
    if state.samples_done >= spp:
        layers_done = n_layers
    else:
        if state.samples_done % spt:
            raise ValueError("resume must use the original spt (layer size)")
        layers_done = state.samples_done // spt

    step_idx = 0
    while layers_done < n_layers:
        l1 = min(layers_done + layers_per_step, n_layers)
        img = render_wavefront(data, meta, cam, device, seed=seed, spt=spt,
                               mesh=mesh, fb=state.fb.reshape(W * H, 3),
                               layer_range=(layers_done, l1),
                               scrub_nan=False, **wf_kwargs)
        state.fb = img.cpu().numpy().reshape(H, W, 3)
        layers_done = l1
        state.samples_done = min(layers_done * spt, spp)
        step_idx += 1
        _step_done(state, step_idx, checkpoint_path, checkpoint_every,
                   on_step)
    return _finish(state, checkpoint_path)


def save_state(path: str, state: RenderState) -> None:
    """Atomic npz checkpoint write: a temporary file in the same directory,
    then ``os.replace``."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, fb=np.asarray(state.fb, np.float32),
                                samples_done=np.int64(state.samples_done),
                                seed=np.int64(state.seed),
                                spp_total=np.int64(state.spp_total))
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_state(path: str) -> RenderState:
    with np.load(path) as z:
        return RenderState(fb=z["fb"].copy(),
                           samples_done=int(z["samples_done"]),
                           seed=int(z["seed"]),
                           spp_total=int(z["spp_total"])
                           if "spp_total" in z.files else 0)
