"""mort's scene 1 (``random_spheres``, mort.cu:129-226): The Next Week's
bouncing spheres, a checkered ground sphere of radius 1000, a 22 x 22
grid of small spheres (80% lambertian and moving, 15% metal, 5% glass)
and three large ones, all under one BVH list.  The description of the
port's ``random_spheres``, on any ``World`` with the port's registry
calls."""

from __future__ import annotations

import numpy as np


def build(params: dict, World):
    """The scene's description on a new ``World`` of the class given."""
    rng = np.random.RandomState(int(params["construction_seed"]))
    w = World()
    members = []

    c1 = w.solid_color([0.2, 0.3, 0.1])
    c2 = w.solid_color([0.9, 0.9, 0.9])
    checker = w.checker(0.32, c1, c2)
    ground_mat = w.lambertian(checker)
    members.append(w.sphere([0, -1000, 0], 1000, ground_mat, skip=True))

    span = int(params["grid_half_span"])
    for a in range(-span, span):
        for b in range(-span, span):
            choose_mat = rng.rand()
            center = np.array([a + 0.9 * rng.rand(), 0.2, b + 0.9 * rng.rand()])
            if np.linalg.norm(center - np.array([4, 0.2, 0])) > 0.9:
                if choose_mat < 0.8:
                    albedo = rng.rand(3) * rng.rand(3)
                    center2 = center + np.array([0, rng.uniform(0, 0.5), 0])
                    mat = w.lambertian(w.solid_color(albedo))
                    members.append(w.sphere(center, 0.2, mat, center2=center2,
                                            skip=True))
                elif choose_mat < 0.95:
                    albedo = rng.uniform(0.5, 1, 3)
                    fuzz = rng.uniform(0, 0.5)
                    mat = w.metal(albedo, fuzz)
                    members.append(w.sphere(center, 0.2, mat, skip=True))
                else:
                    mat = w.dielectric(1.5)
                    members.append(w.sphere(center, 0.2, mat, skip=True))

    members.append(w.sphere([0, 1, 0], 1.0, w.dielectric(1.5), skip=True))
    members.append(w.sphere([-4, 1, 0], 1.0,
                            w.lambertian(w.solid_color([0.4, 0.2, 0.1])),
                            skip=True))
    members.append(w.sphere([4, 1, 0], 1.0, w.metal([0.7, 0.6, 0.5], 0.0),
                            skip=True))

    lst = w.hittable_list(members, skip=True)
    w.bvh(lst)
    return w
