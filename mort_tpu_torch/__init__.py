"""mort_tpu_torch: the PyTorch + CUDA port of mort_tpu.

The JAX package ``mort_tpu`` is the reference; this package mirrors its
module names (``rng``, ``camera``, ``scene.build``, ``render.wavefront``,
...) and never imports jax.  Plain tensor code is PyTorch; the TPU's Pallas
closest-hit kernel and its gradient are hand-written CUDA kernels for
Hopper (``csrc/closest_hit.cu``), built with nvcc at first use.

Importing the package applies the numerics policy of ``device.py``
(float32 everywhere, TF32 off).
"""

from .device import configure_numerics, require_cuda

configure_numerics()

from .camera import Camera, camera_from_numpy, make_camera  # noqa: E402
from .rng import DEFAULT_SEED  # noqa: E402
from .scene.build import (  # noqa: E402
    SceneData, SceneMeta, World, scene_from_numpy,
)
from .render.wavefront import render_wavefront  # noqa: E402
from .render.renderer import render, to_u8  # noqa: E402
from .parallel.sharding import make_train_step  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "Camera", "camera_from_numpy", "make_camera", "DEFAULT_SEED",
    "SceneData", "SceneMeta", "World", "scene_from_numpy",
    "render_wavefront", "render", "to_u8", "make_train_step",
    "require_cuda", "configure_numerics",
]
