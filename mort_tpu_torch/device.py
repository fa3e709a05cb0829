"""Device helpers and the port's numerics policy.

Every device decision of the port is explicit: functions take a
``torch.device`` (or tensors that lie on one) and never guess.  The
numerics policy lives here and only here: all arithmetic is float32, and
no matrix product or convolution may silently drop to TF32 — a
reduced-precision dot is exactly the fault that once darkened the JAX
package's images by ~28% (DEVIATIONS.md section 6).
"""

from __future__ import annotations

import functools
import subprocess

import torch


def configure_numerics() -> None:
    """Full-precision float32 everywhere: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def require_cuda() -> torch.device:
    """The first CUDA device; raises when the process sees no card."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device visible: torch.cuda.is_available() is False")
    return torch.device("cuda", torch.cuda.current_device())


def card_line() -> str:
    """The first card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them: a
    card set below its maximum power runs slower under load, so every
    timing is reported beside this line."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def device_line(device: torch.device) -> str:
    """``card_line()`` for a CUDA device, else the device type: the line
    every timing record carries beside its numbers."""
    return card_line() if device.type == "cuda" else device.type


def synchronize(device: torch.device) -> None:
    """Wait for ``device``'s queued work (a no-op on the CPU): every timed
    window ends with it."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@functools.cache
def constant(values, dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
    """A constant tensor (``values``: a number or nested tuples of them)
    made once a device: the first (eager) call copies it from the host,
    and a later call inside a captured CUDA graph, which allows no
    host-to-device copy, reads the same tensor.  The cache never drops an
    entry: a captured graph reads the tensor's address for as long as the
    graph lives, and a freed tensor's memory could be handed to another."""
    return torch.tensor(values, dtype=dtype, device=device)
