"""Interactive camera control + headless viewer loop.

The port of ``mort_tpu.interactive``.  The reference binds WASD + mouse
drag to camera motion inside a GLUT window (input(), mort.cu:49-91): W/S
move along the view axis -w/+w, A/D strafe along -u/+u, and mouse drag
orbits lookat around lookfrom by rotate_around(dir, vup | u, -delta/500)
(vec3.cuh:214-227), re-running Camera::initialize every frame.  Here the
same controls are a pure :class:`CameraController` API plus a frame loop
that renders progressive previews to PNG (and an optional ANSI terminal
preview) on ``device`` (None: the card).
"""

from __future__ import annotations

import contextlib
import sys

import numpy as np
import torch

from . import metrics
from .camera import Camera
from .device import require_cuda
from .render.renderer import to_u8_np
from .render.vec import rotate_around
from .render.wavefront import render_wavefront
from .rng import DEFAULT_SEED


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _rotate_around(vec, axis, theta):
    """``vec.rotate_around`` of two 3-vectors in float64 (the JAX
    package's viewer rotates in numpy float64), as float32 numpy."""
    vec, axis = (torch.as_tensor(np.asarray(a, np.float64))
                 for a in (vec, axis))
    return rotate_around(vec, axis, theta).numpy().astype(np.float32)


class CameraController:
    """Replicates the reference's per-frame camera input handling."""

    MOUSE_SENSITIVITY = 1.0 / 500.0   # mort.cu:78,84

    def __init__(self, cam: Camera):
        self.cam = cam

    def _basis(self):
        lookfrom = _np(self.cam.lookfrom)
        lookat = _np(self.cam.lookat)
        vup = _np(self.cam.vup)
        w = lookfrom - lookat
        w = w / np.linalg.norm(w)
        u = np.cross(vup, w)
        u = u / np.linalg.norm(u)
        return u, w

    def _vec(self, x):
        return torch.as_tensor(np.asarray(x, np.float32),
                               device=self.cam.lookfrom.device)

    def _move(self, delta):
        self.cam = self.cam.replace(
            lookfrom=self.cam.lookfrom + self._vec(delta),
            lookat=self.cam.lookat + self._vec(delta))

    def key(self, k: str):
        """WASD movement by one basis unit (mort.cu:52-67)."""
        u, w = self._basis()
        if k == "w":
            self._move(-w)
        elif k == "s":
            self._move(w)
        elif k == "a":
            self._move(-u)
        elif k == "d":
            self._move(u)

    def mouse_drag(self, dx: float, dy: float):
        """Orbit lookat around lookfrom (mort.cu:75-87)."""
        u, _w = self._basis()
        if dx:
            direction = _np(self.cam.lookat) - _np(self.cam.lookfrom)
            rotated = _rotate_around(direction, _np(self.cam.vup),
                                     -dx * self.MOUSE_SENSITIVITY)
            self.cam = self.cam.replace(
                lookat=self._vec(_np(self.cam.lookfrom) + rotated))
        if dy:
            direction = _np(self.cam.lookat) - _np(self.cam.lookfrom)
            rotated = _rotate_around(direction, u, -dy * self.MOUSE_SENSITIVITY)
            self.cam = self.cam.replace(
                lookat=self._vec(_np(self.cam.lookfrom) + rotated))


def _ansi_preview(u8_img, max_cols=80):
    """Half-block terminal preview (two rows per character cell)."""
    img = u8_img[::-1]  # top-down
    H, W, _ = img.shape
    step = max(1, W // max_cols)
    img = img[::step * 2, ::step]
    lines = []
    for y in range(0, img.shape[0] - 1, 2):
        row = []
        for x in range(img.shape[1]):
            t = img[y, x]
            b = img[y + 1, x]
            row.append(f"\x1b[38;2;{t[0]};{t[1]};{t[2]}m"
                       f"\x1b[48;2;{b[0]};{b[1]};{b[2]}m▀")
        lines.append("".join(row) + "\x1b[0m")
    return "\n".join(lines)


@metrics.spanned("viewer.call")
def view(data, meta, cam: Camera, commands, seed=DEFAULT_SEED,
         out_pattern=None, ansi=False, log=sys.stderr, preview_spt=None,
         device=None):
    """Headless viewer loop: apply a command stream, render a frame each.

    ``commands``: iterable of ('key', 'w'|'a'|'s'|'d') or
    ('mouse', dx, dy) or ('frame',) events.  Returns the last frame (numpy
    [H, W, 3]).  Per-frame timing (``metrics.FrameTimer``) is logged like
    the reference's avg-ms print (mort.cu:110-119); ``out_pattern``
    (``str.format`` of the frame number) writes each frame as PNG.

    ``preview_spt``: interactive-rate progressive mode.  Each 'frame' event
    renders ONE layer of ``preview_spt`` stratified samples through the
    wavefront's layer-aligned spans and accumulates; any camera input resets
    the accumulator, so a camera held still refines to the full-spp image
    while movement stays at one-layer latency.

    Spans: the call is "viewer.call", a 'frame' event "viewer.frame", its
    copy of the image to the host "viewer.copy_out", and its scale, NaN
    scrub, print and outputs "viewer.finish".
    """
    from .io.image import save_png

    device = require_cuda() if device is None else torch.device(device)
    ctl = CameraController(cam)
    timer = metrics.FrameTimer(log=log)
    frame = None
    spp = int(cam.sqrt_spp) ** 2
    if preview_spt:
        preview_spt = min(int(preview_spt), spp)
    n_layers = -(-spp // preview_spt) if preview_spt else 1
    fb = None
    layer = 0
    for event in commands:
        if event[0] == "key":
            ctl.key(event[1])
            fb, layer = None, 0          # camera moved: restart refinement
            continue
        if event[0] == "mouse":
            ctl.mouse_drag(event[1], event[2])
            fb, layer = None, 0
            continue
        # the timed frame ends before the print; "viewer.finish" spans
        # the scale and NaN scrub within it and the outputs after it
        with metrics.span("viewer.frame"), contextlib.ExitStack() as finish:
            with timer.frame():
                if preview_spt:
                    if layer < n_layers:
                        img = render_wavefront(
                            data, meta, ctl.cam, device, seed=seed,
                            spt=preview_spt, fb=fb,
                            layer_range=(layer, layer + 1), scrub_nan=False)
                        fb = img.reshape(-1, 3)
                        layer += 1
                    done = min(layer * preview_spt, spp)
                    with metrics.span("viewer.copy_out"):
                        host = fb.cpu()
                    finish.enter_context(metrics.span("viewer.finish"))
                    # the 10- and 20-MB host arrays are made and freed in
                    # the order of one expression (the copy freed before
                    # the last frame): the host allocator's reuse of them
                    # depends on it, and freeing the last frame first
                    # cost ~8 ms a frame on the H100's host
                    scaled = host.numpy().reshape(img.shape) * (spp / done)
                    del host
                    frame = scaled
                    del scaled
                    frame = np.where(np.isnan(frame), 0.0, frame)
                else:
                    img = render_wavefront(data, meta, ctl.cam, device,
                                           seed=seed)
                    with metrics.span("viewer.copy_out"):
                        frame = img.cpu().numpy()
                    finish.enter_context(metrics.span("viewer.finish"))
            timer.print_avg()
            if out_pattern:
                save_png(out_pattern.format(timer.frames), frame)
            if ansi:
                print(_ansi_preview(to_u8_np(frame)), file=sys.stdout)
    return frame
