"""Image output.

The port of ``mort_tpu.io.image``: PNG and NPZ writers in place of the
reference's GL display path.  The renderer's framebuffer has row 0 at the
*bottom* (GL convention); the PNG writer flips to top-down file order.
Every function takes a numpy array or a tensor on any device.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch


def _numpy(img) -> np.ndarray:
    if isinstance(img, torch.Tensor):
        return img.detach().cpu().numpy()
    return np.asarray(img)


def save_png(path: str, img) -> None:
    """Write a [H, W, 3] image (uint8, or float linear radiance, which gets
    the reference's gamma 2, clamp to 0.999 and x256) to PNG, flipping to
    top-down.  Uses PIL where it is installed, else ``_save_png_pure``."""
    arr = _numpy(img)
    if arr.dtype != np.uint8:
        g = np.sqrt(np.maximum(arr, 0.0))
        arr = (256.0 * np.clip(g, 0.0, 0.999)).astype(np.uint8)
    arr = np.ascontiguousarray(arr[::-1])  # bottom-up framebuffer -> file
    try:
        from PIL import Image
    except ImportError:
        _save_png_pure(path, arr)
        return
    Image.fromarray(arr).save(path)


def _save_png_pure(path: str, arr: np.ndarray) -> None:
    """Minimal dependency-free PNG encoder (8-bit RGB, no filtering, zlib
    level 6): the JAX package's, byte for byte."""
    h, w, _ = arr.shape
    raw = b"".join(b"\x00" + arr[i].tobytes() for i in range(h))

    def chunk(tag, payload):
        out = struct.pack(">I", len(payload)) + tag + payload
        return out + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def save_npz(path: str, linear_img, **extra) -> None:
    """Save the float framebuffer (plus metadata) for accumulation/tests."""
    np.savez_compressed(path, image=_numpy(linear_img), **extra)


def load_npz(path: str):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
