"""The differentiable train step (scene-parameter optimisation).

The port of ``mort_tpu.parallel.sharding``'s ``make_train_step``,
``_DIFF_FIELDS``, ``_extract_diff`` and ``_merge_diff``, on one device.
Sharding pixels over several cards with a gradient all-reduce
(``render_sharded``, ``make_mesh``) is not ported yet: ``mesh`` other than
None raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..camera import Camera
from ..device import require_cuda
from ..rng import DEFAULT_SEED
from ..scene.build import SceneData, SceneMeta
from ..render.renderer import radiance_for_pixels

# The differentiable scene leaves (the JAX package's names, so gradients
# compare key by key).
_DIFF_FIELDS = ("sph_center", "sph_cvec", "sph_radius", "quad_Q", "quad_u",
                "quad_v", "mat_albedo", "mat_fuzz", "mat_ior", "tex_color")


def _extract_diff(data: SceneData) -> dict:
    return {f: getattr(data, f) for f in _DIFF_FIELDS}


def _merge_diff(data: SceneData, diff: dict) -> SceneData:
    return data.replace(**diff)


def make_train_step(meta: SceneMeta, device=None, chunk=512, use_kernel=None,
                    accel=None, mesh=None):
    """Build ``run(data, cam, target_img, seed) -> (loss, grads)``: the MSE
    of ``radiance_for_pixels(differentiable=True)`` over all pixels against
    ``target_img`` ([H, W, 3], row 0 = bottom), and its gradient with
    respect to each of ``_DIFF_FIELDS`` (a dict of tensors on ``device``).

    ``device``: None is the card (``require_cuda``); pass ``"cpu"`` for the
    plain versions.  ``use_kernel`` and ``accel``: as in
    ``renderer.radiance_for_pixels`` (None: the kernel on a card,
    ``intersect_best`` on the CPU).
    """
    if mesh is not None:
        raise NotImplementedError(
            "make_train_step: pixel sharding over several devices is not "
            "ported yet")
    device = require_cuda() if device is None else torch.device(device)

    # The step's operands live on the device across calls, keyed on the
    # identity of the caller's objects: a training loop passes the same
    # scene, camera and target every step.  The keys are held strongly: an
    # id() alone can be reused by the next object after a collection (a
    # stale scene under finite-difference probing, in the JAX package).
    prep_cache = {}

    def _prep(data, cam, target_img):
        key = prep_cache.get("key")
        hit = (key is not None and key[0] is data and key[1] is cam
               and key[2] is target_img)
        if not hit:
            WH = cam.image_width * cam.image_height
            target = torch.as_tensor(
                np.asarray(target_img, np.float32).reshape(-1, 3)
                if not isinstance(target_img, torch.Tensor)
                else target_img.reshape(-1, 3)).to(device, torch.float32)
            pix = torch.arange(WH, dtype=torch.int64, device=device)
            prep_cache.update(key=(data, cam, target_img),
                              val=(data.to(device), cam.to(device), target,
                                   pix))
        return prep_cache["val"]

    def run(data: SceneData, cam: Camera, target_img, seed=DEFAULT_SEED):
        data_dev, cam_dev, target, pix = _prep(data, cam, target_img)
        diff = {k: v.detach().requires_grad_()
                for k, v in _extract_diff(data_dev).items()}
        img = radiance_for_pixels(_merge_diff(data_dev, diff), meta, cam_dev,
                                  int(seed), pix, chunk=chunk,
                                  differentiable=True, use_kernel=use_kernel,
                                  accel=accel)
        loss = torch.mean((img - target) ** 2)
        grads = torch.autograd.grad(loss, list(diff.values()),
                                    allow_unused=True, materialize_grads=True)
        return loss.detach(), dict(zip(diff, grads))

    run.prep_cache = prep_cache
    return run
