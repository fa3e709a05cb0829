"""Camera model: viewport setup, stratified sampling, defocus blur.

The port of ``mort_tpu.camera`` (behavioural parity with the reference
Camera, camera.cuh:12-243):

* Static image geometry (width/height/sqrt_spp/bounce_limit) is fixed at
  construction; the basis (pixel00, pixel deltas, defocus disk) is derived
  from the float parameters by :func:`derive_basis`, in float32 on the
  parameters' device.

* Stratified sampling truncates spp to a perfect square:
  ``sqrt_spp = int(sqrt(spp))`` (camera.cuh:51-53).

* ``get_rays_soa`` consumes counter-RNG draws: pixel jitter + ray time from
  SLOT_CAM_PIXEL, the defocus-disk point from SLOT_CAM_LENS, through the
  exact polar disk transform (r = sqrt(u), theta = 2*pi*v).

Pixel convention: x in [0,W), y in [0,H) with y increasing *upward* (row 0
of the framebuffer is the bottom of the image).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from .rng import SLOT_CAM_LENS, SLOT_CAM_PIXEL, uniform4
from .render.vec import V3

_FLOAT_FIELDS = ("lookfrom", "lookat", "vup", "vfov", "defocus_angle",
                 "focus_dist", "background")
_STATIC_FIELDS = ("image_width", "image_height", "sqrt_spp", "bounce_limit")


@dataclass(frozen=True)
class Camera:
    # Float parameters: float32 tensors ([3] or 0-d).
    lookfrom: torch.Tensor
    lookat: torch.Tensor
    vup: torch.Tensor
    vfov: torch.Tensor            # degrees
    defocus_angle: torch.Tensor   # degrees
    focus_dist: torch.Tensor
    background: torch.Tensor      # flat miss color (camera.cuh:22)
    # Static geometry / sampling config.
    image_width: int
    image_height: int
    sqrt_spp: int
    bounce_limit: int

    def replace(self, **kw) -> "Camera":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "Camera":
        return self.replace(**{n: getattr(self, n).to(device)
                               for n in _FLOAT_FIELDS})


def make_camera(
    *,
    aspect_ratio: float = 1.0,
    image_width: int = 400,
    samples_per_pixel: int = 50,
    bounce_limit: int = 10,
    vfov: float = 90.0,
    lookfrom=(0.0, 0.0, 1.0),
    lookat=(0.0, 0.0, 0.0),
    vup=(0.0, 1.0, 0.0),
    defocus_angle: float = 0.0,
    focus_dist: float = 10.0,
    background=(0.70, 0.80, 1.00),
) -> Camera:
    image_height = max(1, int(image_width / aspect_ratio))
    sqrt_spp = max(1, int(math.sqrt(samples_per_pixel)))
    return camera_from_numpy({
        "lookfrom": lookfrom, "lookat": lookat, "vup": vup, "vfov": vfov,
        "defocus_angle": defocus_angle, "focus_dist": focus_dist,
        "background": background, "image_width": image_width,
        "image_height": image_height, "sqrt_spp": sqrt_spp,
        "bounce_limit": bounce_limit,
    })


def camera_from_numpy(fields: dict) -> Camera:
    """A ``Camera`` from every field's value: numpy arrays or numbers for
    the float parameters (e.g. ``np.asarray`` of the JAX package's Camera
    leaves), ints for the static geometry."""
    kw = {n: torch.from_numpy(np.asarray(fields[n], np.float32).copy())
          for n in _FLOAT_FIELDS}
    kw.update({n: int(fields[n]) for n in _STATIC_FIELDS})
    return Camera(**kw)


@dataclass(frozen=True)
class CameraBasis:
    center: torch.Tensor
    pixel00_loc: torch.Tensor
    pixel_delta_u: torch.Tensor
    pixel_delta_v: torch.Tensor
    defocus_disk_u: torch.Tensor
    defocus_disk_v: torch.Tensor
    use_defocus: torch.Tensor     # 0-d bool (defocus_angle > 0)


def _unit(v):
    return v / torch.sqrt(torch.sum(v * v))


def derive_basis(cam: Camera) -> CameraBasis:
    """Camera::initialize (camera.cuh:47-84), float32."""
    W, H = cam.image_width, cam.image_height
    theta = torch.deg2rad(cam.vfov)
    h = torch.tan(theta / 2.0)
    viewport_height = 2.0 * h * cam.focus_dist
    viewport_width = viewport_height * (W / H)

    w = _unit(cam.lookfrom - cam.lookat)
    u = _unit(torch.linalg.cross(cam.vup, w))
    v = torch.linalg.cross(w, u)

    viewport_u = viewport_width * u
    viewport_v = viewport_height * -v
    pixel_delta_u = viewport_u / W
    pixel_delta_v = -viewport_v / H

    center = cam.lookfrom
    viewport_upper_left = center - cam.focus_dist * w - viewport_u / 2 + viewport_v / 2
    pixel00_loc = viewport_upper_left + 0.5 * (pixel_delta_u + pixel_delta_v)

    defocus_radius = cam.focus_dist * torch.tan(
        torch.deg2rad(cam.defocus_angle / 2.0))
    return CameraBasis(
        center=center,
        pixel00_loc=pixel00_loc,
        pixel_delta_u=pixel_delta_u,
        pixel_delta_v=pixel_delta_v,
        defocus_disk_u=u * defocus_radius,
        defocus_disk_v=v * defocus_radius,
        use_defocus=cam.defocus_angle > 0,
    )


def get_rays_soa(cam: Camera, basis: CameraBasis, seed, pixel_ids,
                 sample_ids, no_defocus: bool = False):
    """Camera rays for flat pixel ids + stratified sample ids.

    pixel_id = x + y * W;  sample_id = s_i + s_j * sqrt_spp
    (camera.cuh:187-192, 210-220).  Returns (origin V3, dir V3, time [R]).
    Directions are NOT normalised, as in the reference.

    ``no_defocus``: callers that know defocus_angle == 0 skip the
    SLOT_CAM_LENS block and the disk math; at zero aperture its values are
    unused, so skipping is unobservable.
    """
    W = cam.image_width
    x = (pixel_ids % W).to(torch.float32)
    y = torch.div(pixel_ids, W, rounding_mode="floor").to(torch.float32)
    s_i = (sample_ids % cam.sqrt_spp).to(torch.float32)
    s_j = torch.div(sample_ids, cam.sqrt_spp,
                    rounding_mode="floor").to(torch.float32)
    recip = float(np.float32(1.0 / cam.sqrt_spp))

    u1, u2, u_time, _ = uniform4(seed, pixel_ids, sample_ids, 0,
                                 SLOT_CAM_PIXEL)

    # sample_square_stratified (camera.cuh:236-242)
    sx = x + (s_i + u1) * recip - 0.5
    sy = y + (s_j + u2) * recip - 0.5

    p00, du, dv = basis.pixel00_loc, basis.pixel_delta_u, basis.pixel_delta_v
    pixel_sample = V3(p00[0] + sx * du[0] + sy * dv[0],
                      p00[1] + sx * du[1] + sy * dv[1],
                      p00[2] + sx * du[2] + sy * dv[2])

    # defocus_disk_sample (camera.cuh:230-234) with polar disk sampling.
    c = basis.center
    zero = torch.zeros_like(u_time)
    center = V3(c[0] + zero, c[1] + zero, c[2] + zero)
    if no_defocus:
        return center, pixel_sample - center, u_time
    d1, d2, _, _ = uniform4(seed, pixel_ids, sample_ids, 0, SLOT_CAM_LENS)
    r = torch.sqrt(d1)
    phi = (2.0 * math.pi) * d2
    a = r * torch.cos(phi)
    b = r * torch.sin(phi)
    ku, kv = basis.defocus_disk_u, basis.defocus_disk_v
    disk = V3(c[0] + a * ku[0] + b * kv[0],
              c[1] + a * ku[1] + b * kv[1],
              c[2] + a * ku[2] + b * kv[2])
    use = basis.use_defocus
    origin = V3(torch.where(use, disk.x, center.x),
                torch.where(use, disk.y, center.y),
                torch.where(use, disk.z, center.z))
    return origin, pixel_sample - origin, u_time


def get_rays(cam: Camera, basis: CameraBasis, seed, pixel_ids, sample_ids):
    """AoS wrapper over :func:`get_rays_soa`: returns ([R,3], [R,3], [R])."""
    ro, rd, t = get_rays_soa(cam, basis, seed, pixel_ids, sample_ids)
    return ro.to_rows(), rd.to_rows(), t
