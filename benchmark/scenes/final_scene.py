"""mort's ``final_scene`` (mort.cu:506-631), The Next Week's final scene
as mort builds it: a 20 x 20 field of boxes, a quad light, a moving
sphere, glass and metal spheres, a glass sphere filled with a blue
medium, scene-wide fog, an image-textured earth, a marble noise sphere
(``noise_texture(0.1)``) and a rotated, translated cluster of 1,000
spheres.  The description of the port's ``final_scene``, on any
``World`` with the port's registry calls; the earth texture is the
port's procedural stand-in, since ``earthmap.jpg`` is not in the
repository."""

from __future__ import annotations

import numpy as np


def earthmap() -> np.ndarray:
    """[256, 512, 3] uint8: latitude bands and 24 continent blobs."""
    H, W = 256, 512
    v, u = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W),
                       indexing="ij")
    rng = np.random.RandomState(7)
    land = np.zeros((H, W))
    for _ in range(24):
        cu, cv, r = rng.rand(), rng.rand() * 0.8 + 0.1, rng.rand() * 0.08 + 0.03
        du = np.minimum(np.abs(u - cu), 1 - np.abs(u - cu))
        land += np.exp(-((du ** 2 + (v - cv) ** 2) / (2 * r ** 2)))
    is_land = land > 0.9
    ice = (v < 0.08) | (v > 0.92)
    img = np.empty((H, W, 3), np.uint8)
    img[..., 0] = np.where(ice, 240, np.where(is_land, 80, 20))
    img[..., 1] = np.where(ice, 245, np.where(is_land, 140, 60))
    img[..., 2] = np.where(ice, 250, np.where(is_land, 60, 160))
    return img


def build(params: dict, World):
    """The scene's description on a new ``World`` of the class given."""
    rng = np.random.RandomState(int(params["construction_seed"]))
    w = World()

    ground_mat = w.lambertian(w.solid_color([0.48, 0.83, 0.53]))
    boxes_per_side = int(params["boxes_per_side"])
    for i in range(boxes_per_side):
        for j in range(boxes_per_side):
            side = 100.0 * (20 / boxes_per_side)
            x0 = -1000.0 + i * side
            z0 = -1000.0 + j * side
            y1 = rng.uniform(1, 101)
            w.box([x0, 0.0, z0], [x0 + side, y1, z0 + side], ground_mat)

    light_mat = w.diffuse_light(w.solid_color([7.0, 7.0, 7.0]))
    light = w.quad([123, 554, 147], [300, 0, 0], [0, 0, 265], light_mat)

    moving_mat = w.lambertian(w.solid_color([0.7, 0.3, 0.1]))
    w.sphere([400, 400, 200], 50, moving_mat, center2=[430, 400, 200])

    glass = w.dielectric(1.5)
    w.sphere([260, 150, 45], 50, glass)
    w.sphere([0, 150, 145], 50, w.metal([0.8, 0.8, 0.9], 1.0))

    subsurface_mat = w.lambertian(w.solid_color([0.2, 0.4, 0.9]))
    subsurface_sphere = w.sphere([360, 150, 145], 70, glass)
    w.constant_medium(subsurface_sphere, 0.2, subsurface_mat)

    fog_mat = w.lambertian(w.solid_color([1, 1, 1]))
    boundary_sphere = w.sphere([0, 0, 0], 5000, glass)
    w.constant_medium(boundary_sphere, 0.0001, fog_mat)

    earth_mat = w.lambertian(w.image_texture(earthmap()))
    w.sphere([400, 200, 400], 100, earth_mat)

    noise_mat = w.lambertian(w.noise_texture(0.1))
    w.sphere([220, 280, 300], 80, noise_mat)

    cluster_mat = w.lambertian(w.solid_color([0.73, 0.73, 0.73]))
    cluster = []
    for _ in range(int(params["cluster_spheres"])):
        cluster.append(w.sphere(rng.uniform(0, 165, 3), 10, cluster_mat,
                                skip=True))
    base = w.hittable_list(cluster, skip=True)
    rot = w.rotate_y(base, 15, skip=True)
    w.translate(rot, [-100, 270, 395])

    w.light = light
    return w
