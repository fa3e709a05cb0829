"""The ten reference scenes (mort.cu:129-631), built with the port's scene API.

The same builders as ``mort_tpu.scene.scenes``, so both packages compile the
same arrays from the same seeds.

Scene-generation randomness uses a fixed numpy seed (the reference uses the
C library rand(), unseeded per run) — scenes are deterministic here.

The earth image texture loads the reference's asset when present
(imgs/earthmap.jpg) and falls back to a procedural substitute, so renders
are self-contained.  Override with the MORT_TPU_EARTHMAP env var.
"""

from __future__ import annotations

import os

import numpy as np

from ..camera import make_camera
from .build import World

_EARTHMAP_CANDIDATES = (
    os.environ.get("MORT_TPU_EARTHMAP", ""),
    os.path.join(os.path.dirname(__file__), "..", "..", "assets", "earthmap.jpg"),
)


def load_earthmap() -> np.ndarray:
    """[H,W,3] uint8 earth texture; procedural fallback keeps the repo
    standalone (img_loader.h returns magenta on failure; we do better)."""
    for path in _EARTHMAP_CANDIDATES:
        if path and os.path.exists(path):
            try:
                from PIL import Image
                return np.asarray(Image.open(path).convert("RGB"))
            except Exception:
                pass
    # Procedural "earth": latitude bands + longitude continents blobs.
    H, W = 256, 512
    v, u = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W), indexing="ij")
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


def random_spheres(quick=False):
    """Scene 1 (mort.cu:129-226): ~490 random spheres + 3 hero spheres, BVH."""
    rng = np.random.RandomState(42)
    w = World()
    members = []

    c1 = w.solid_color([0.2, 0.3, 0.1])
    c2 = w.solid_color([0.9, 0.9, 0.9])
    checker = w.checker(0.32, c1, c2)
    ground_mat = w.lambertian(checker)
    members.append(w.sphere([0, -1000, 0], 1000, ground_mat, skip=True))

    span = 4 if quick else 11
    for a in range(-span, span):
        for b in range(-span, span):
            choose_mat = rng.rand()
            center = np.array([a + 0.9 * rng.rand(), 0.2, b + 0.9 * rng.rand()])
            if np.linalg.norm(center - np.array([4, 0.2, 0])) > 0.9:
                if choose_mat < 0.8:
                    albedo = rng.rand(3) * rng.rand(3)
                    center2 = center + np.array([0, rng.uniform(0, 0.5), 0])
                    mat = w.lambertian(w.solid_color(albedo))
                    members.append(w.sphere(center, 0.2, mat, center2=center2, skip=True))
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
                            w.lambertian(w.solid_color([0.4, 0.2, 0.1])), skip=True))
    members.append(w.sphere([4, 1, 0], 1.0, w.metal([0.7, 0.6, 0.5], 0.0), skip=True))

    lst = w.hittable_list(members, skip=True)
    w.bvh(lst)

    cam = make_camera(
        aspect_ratio=16.0 / 9.0, image_width=1200, samples_per_pixel=100,
        bounce_limit=20, vfov=20, lookfrom=[13, 2, 3], lookat=[0, 0, 0],
        defocus_angle=0.0, focus_dist=10.0,
    )
    return w, cam


def two_spheres():
    """Scene 2 (mort.cu:228-253)."""
    w = World()
    c1 = w.solid_color([0.2, 0.3, 0.1])
    c2 = w.solid_color([0.9, 0.9, 0.9])
    mat = w.lambertian(w.checker(0.32, c1, c2))
    w.sphere([0, -10, 0], 10, mat)
    w.sphere([0, 10, 0], 10, mat)
    cam = make_camera(
        aspect_ratio=16.0 / 9.0, image_width=1200, samples_per_pixel=20,
        bounce_limit=50, vfov=20, lookfrom=[13, 2, 3], lookat=[0, 0, 0],
    )
    return w, cam


def earth():
    """Scene 3 (mort.cu:292-313)."""
    w = World()
    tex = w.image_texture(load_earthmap())
    w.sphere([0, 0, 0], 2, w.lambertian(tex))
    cam = make_camera(
        aspect_ratio=16.0 / 9.0, image_width=1200, samples_per_pixel=100,
        bounce_limit=50, vfov=20, lookfrom=[0, 0, 12], lookat=[0, 0, 0],
    )
    return w, cam


def two_perlin_spheres():
    """Scene 4 (mort.cu:315-338)."""
    w = World()
    mat = w.lambertian(w.noise_texture(4.0))
    w.sphere([0, -1000, 0], 1000, mat)
    w.sphere([0, 2, 0], 2, mat)
    cam = make_camera(
        aspect_ratio=16.0 / 9.0, image_width=1200, samples_per_pixel=5,
        bounce_limit=10, vfov=20, lookfrom=[13, 2, 3], lookat=[0, 0, 0],
    )
    return w, cam


def quads():
    """Scene 5 (mort.cu:340-390)."""
    w = World()
    mats = [w.lambertian(w.solid_color(c)) for c in
            ([1.0, 0.2, 0.2], [0.2, 1.0, 0.2], [0.2, 0.2, 1.0],
             [1.0, 0.5, 0.0], [0.2, 0.8, 0.8])]
    w.quad([-3, -2, 5], [0, 0, -4], [0, 4, 0], mats[0])
    w.quad([-2, -2, 0], [4, 0, 0], [0, 4, 0], mats[1])
    w.quad([3, -2, 1], [0, 0, 4], [0, 4, 0], mats[2])
    w.quad([-2, 3, 1], [4, 0, 0], [0, 0, 4], mats[3])
    w.quad([-2, -3, 5], [4, 0, 0], [0, 0, -4], mats[4])
    cam = make_camera(
        aspect_ratio=1.0, image_width=400, samples_per_pixel=100,
        bounce_limit=50, vfov=20, lookfrom=[0, 0, 9], lookat=[0, 0, 0],
    )
    return w, cam


def cornell_box():
    """Scene 6 (mort.cu:392-448): MIS light list = ceiling lamp + glass sphere."""
    w = World()
    red = w.lambertian(w.solid_color([0.65, 0.05, 0.05]))
    white = w.lambertian(w.solid_color([0.73, 0.73, 0.73]))
    green = w.lambertian(w.solid_color([0.12, 0.45, 0.15]))
    lamp = w.diffuse_light(w.solid_color([15.0, 15.0, 10.0]))
    glass = w.dielectric(1.5)

    ceiling_lamp = w.quad([343, 554, 332], [-130, 0, 0], [0, 0, -105], lamp, skip=True)
    glass_sphere = w.sphere([190, 90, 190], 90, glass, skip=True)
    lights = w.hittable_list([ceiling_lamp, glass_sphere], skip=False)

    w.quad([555, 0, 0], [0, 555, 0], [0, 0, 555], green)
    w.quad([0, 0, 0], [0, 555, 0], [0, 0, 555], red)
    w.quad([0, 0, 0], [555, 0, 0], [0, 0, 555], white)
    w.quad([555, 555, 555], [-555, 0, 0], [0, 0, -555], white)
    w.quad([0, 0, 555], [555, 0, 0], [0, 555, 0], white)
    w.rotated_box([165, 330, 165], [265, 0, 295], 15, white)

    w.light = lights
    cam = make_camera(
        aspect_ratio=1.0, image_width=600, samples_per_pixel=1000,
        bounce_limit=50, vfov=40, lookfrom=[278, 278, -800],
        lookat=[278, 278, 0], background=[0, 0, 0],
    )
    return w, cam


def cornell_smoke():
    """Scene 7 (mort.cu:450-504)."""
    w = World()
    red = w.lambertian(w.solid_color([0.65, 0.05, 0.05]))
    white = w.lambertian(w.solid_color([0.73, 0.73, 0.73]))
    green = w.lambertian(w.solid_color([0.12, 0.45, 0.15]))
    lamp = w.diffuse_light(w.solid_color([15.0, 15.0, 10.0]))
    # NB the reference uses *lambertian* phase materials for its smoke
    # (mort.cu:462-463), not isotropic; reproduced faithfully.
    black_smoke = w.lambertian(w.solid_color([0, 0, 0]))
    white_smoke = w.lambertian(w.solid_color([1, 1, 1]))

    w.quad([555, 0, 0], [0, 555, 0], [0, 0, 555], green)
    w.quad([0, 0, 0], [0, 555, 0], [0, 0, 555], red)
    lamp_quad = w.quad([343, 554, 332], [-130, 0, 0], [0, 0, -105], lamp)
    w.quad([0, 0, 0], [555, 0, 0], [0, 0, 555], white)
    w.quad([555, 555, 555], [-555, 0, 0], [0, 0, -555], white)
    w.quad([0, 0, 555], [555, 0, 0], [0, 555, 0], white)

    w.rotated_smoke_box([165, 330, 165], [265, 0, 295], 15, 0.01, black_smoke)
    w.rotated_smoke_box([165, 165, 165], [130, 0, 65], -18, 0.01, white_smoke)

    w.light = lamp_quad
    cam = make_camera(
        aspect_ratio=1.0, image_width=800, samples_per_pixel=2000,
        bounce_limit=50, vfov=40, lookfrom=[278, 278, -800],
        lookat=[278, 278, 0], background=[0, 0, 0],
    )
    return w, cam


def final_scene(image_width=800, samples_per_pixel=1000, max_depth=40, quick=False):
    """Scenes 8/9 (mort.cu:506-631): every feature at once."""
    rng = np.random.RandomState(1337)
    w = World()

    ground_mat = w.lambertian(w.solid_color([0.48, 0.83, 0.53]))
    boxes_per_side = 6 if quick else 20
    for i in range(boxes_per_side):
        for j in range(boxes_per_side):
            side = 100.0 * (20 / boxes_per_side if quick else 1.0)
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

    # Blue "subsurface" sphere: glass boundary + interior medium whose phase
    # material is the blue lambertian (mort.cu:559-567).
    subsurface_mat = w.lambertian(w.solid_color([0.2, 0.4, 0.9]))
    subsurface_sphere = w.sphere([360, 150, 145], 70, glass)
    w.constant_medium(subsurface_sphere, 0.2, subsurface_mat)

    # Scene-wide fog (mort.cu:569-577).
    fog_mat = w.lambertian(w.solid_color([1, 1, 1]))
    boundary_sphere = w.sphere([0, 0, 0], 5000, glass)
    w.constant_medium(boundary_sphere, 0.0001, fog_mat)

    earth_mat = w.lambertian(w.image_texture(load_earthmap()))
    w.sphere([400, 200, 400], 100, earth_mat)

    noise_mat = w.lambertian(w.noise_texture(0.1))
    w.sphere([220, 280, 300], 80, noise_mat)

    # Sphere cluster under rotate_y + translate (mort.cu:595-614).
    cluster_mat = w.lambertian(w.solid_color([0.73, 0.73, 0.73]))
    ns = 100 if quick else 1000
    cluster = []
    for _ in range(ns):
        cluster.append(w.sphere(rng.uniform(0, 165, 3), 10, cluster_mat, skip=True))
    base = w.hittable_list(cluster, skip=True)
    rot = w.rotate_y(base, 15, skip=True)
    w.translate(rot, [-100, 270, 395])

    w.light = light
    cam = make_camera(
        aspect_ratio=1.0, image_width=image_width,
        samples_per_pixel=samples_per_pixel, bounce_limit=max_depth,
        vfov=40, lookfrom=[478, 278, -600], lookat=[278, 278, 0],
        background=[0, 0, 0],
    )
    return w, cam


def out_of_order_spheres(n_spheres=35):
    """Scene 10 (mort.cu:255-290): BVH stress — spheres added in reverse
    spatial order along the diagonal."""
    rng = np.random.RandomState(5)
    w = World()
    members = []
    for i in range(n_spheres):
        albedo = rng.rand(3) * rng.rand(3)
        center = [n_spheres - i] * 3
        mat = w.lambertian(w.solid_color(albedo))
        members.append(w.sphere(center, 0.2, mat, skip=True))
    lst = w.hittable_list(members, skip=True)
    w.bvh(lst)
    cam = make_camera(
        aspect_ratio=16.0 / 9.0, image_width=1200, samples_per_pixel=1,
        bounce_limit=5, vfov=20, lookfrom=[13, 2, 3], lookat=[0, 0, 0],
    )
    return w, cam


def spread_spheres(nx=32, ny=16, nz=32):
    """A stress scene beyond the reference ten: nx x ny x nz spheres (16,384
    by default, above the 8192-primitive crossover, so the auto accel policy
    picks "bvh") on a jittered grid of spacing 5 filling a 160 x 80 x 160
    volume, lambertian, metal and glass, seen from above at an angle."""
    rng = np.random.RandomState(16384)
    w = World()
    mats = [w.lambertian(w.solid_color(rng.rand(3) * 0.8 + 0.1))
            for _ in range(8)]
    mats += [w.metal([0.8, 0.8, 0.9], 0.1), w.dielectric(1.5)]
    for i in range(nx):
        for j in range(ny):
            for k in range(nz):
                c = (np.array([i, j, k]) + 0.5 + rng.uniform(-0.25, 0.25, 3)) \
                    * 5.0 - [80.0, 0.0, 80.0]
                w.sphere(c, rng.uniform(0.8, 2.0),
                         mats[rng.randint(len(mats))])
    cam = make_camera(
        aspect_ratio=16.0 / 9.0, image_width=400, samples_per_pixel=4,
        bounce_limit=8, vfov=50, lookfrom=[0, 140, 260], lookat=[0, 40, 0],
    )
    return w, cam


SCENES = {
    1: lambda: random_spheres(),
    2: two_spheres,
    3: earth,
    4: two_perlin_spheres,
    5: quads,
    6: cornell_box,
    7: cornell_smoke,
    8: lambda: final_scene(800, 1000, 40),
    9: lambda: final_scene(400, 250, 4),
    10: lambda: out_of_order_spheres(35),
}


def build_scene(idx: int):
    """Scene number -> (World, Camera), mirroring the CLI switch
    (mort.cu:649-689)."""
    if idx not in SCENES:
        raise ValueError(f"scene must be 1-10, got {idx}")
    return SCENES[idx]()
