#!/usr/bin/env python3
"""Build and run the port on one NVIDIA card, as a user would.

    python3 chip_smoke.py

Phases, one line each or more (any failure raises and exits non-zero):

1. card: the device, its name and power limit (nvidia-smi), versions;
2. build: nvcc-compiles csrc/closest_hit.cu (or loads it from the build
   cache) and reports the seconds, each kernel's registers, spills and
   shared memory (``-Xptxas -v``) and the static SASS instruction mix of
   the "none" and "bvh" kernels (``cuobjdump -sass``);
3. philox: the pinned Philox vector of tests/test_rng.py, on the card;
4. parity: the CUDA closest-hit kernel in each accel mode ("none", "bvh",
   "cull") against its plain PyTorch version on the same card tensors, on
   eight ray sets — scene 1 (2^18 camera rays and their bounces), scene 9
   (2^16, its default pool), scene 7 (2^18: the Cornell box, quads only),
   scene9_edges (2^16 rays aimed at scene 9's
   box edges and corners, from its camera, from far away, from box faces
   and from inside boxes, some with a direction component under 1e-8), a
   moving sphere/quad scene (2^18), a 16,384-sphere spread scene (2^18),
   and 2^16 rays grazing the sphere silhouettes of scene 1 (its r = 1000
   ground among them) and of the spread scene — t, kind, idx and rows
   bit-equal, also from a launch that counts its sphere, quad and box or
   node slab tests (printed a ray); then every mode and the
   plain version timed with CUDA events on each set, one call between two
   events and ten calls back to back, and the share of "none"'s time that
   scene 7's quads take;
5. main path, scene 1: ``render_wavefront`` at its bench config (1200x675,
   100 spp, depth 20, default pool/window/spt), launch counts reset just
   before and read just after; then, at a reduced config, the same render
   through the kernel and through the plain closest hit must agree by the
   image rule of tests/conftest.py;
6. main path, scene 9 (final_scene: quads, a light, media, image and noise
   textures) at its code-true config (400x400, 250 spp — 225 as the camera
   floors it to 15^2 — depth 4, auto accel);
7. scene 9 at 100x100, 16 spp, depth 4 through the "none", "bvh" and
   "cull" kernels and the plain closest hit: the four images agree by the
   image rule;
8. scenes 2-8 and 10 at the golden config (48 px, 4 spp, depth 8), kernel
   against plain by the image rule, each with kernel launches; then main
   path, the 16,384-sphere scene (``spread_spheres``) at its own config
   (400x225, 4 spp, depth 8, auto accel "bvh"), launch counts reset just
   before and read just after, rendered once more under ``torch.profiler``
   for the "bvh" kernel's share of device time; and at 160x90, kernel
   against plain by the image rule;
9. backward parity: the CUDA backward kernel (the gradient of the closest
   hit) against its plain version on phase 4's four ray sets with random
   cotangents — d_rays bit-equal, the atomically summed table gradients
   within BWD_SUM_RTOL of the sum of |terms| per entry — and timed on
   scene 1's rays at the train step's config (R = 202,800);
10. main path, the train step: ``make_train_step`` on scene 1 at
   ``bench.py --grad``'s config (600x338, 4 spp, depth 8), one warm-up step
   and three timed ones, launch counts reset just before and read just
   after (32 forward and 32 backward launches a step);
11. the lockstep ``render`` of scene 1 (200x112, 16 spp, depth 20) through
   the kernel, through the plain closest hit and against
   ``render_wavefront``, by the image rule;
12. the Cornell box train step (12x12, 4 spp, depth 6) on the card against
   the same step on the CPU (the Function's plain versions), and the card's
   ``intersect_best`` route.

The line before the last is the nvidia-smi name/power line, the one before
it a JSON record of the kernels (launches on the paths above, the largest
error against the plain version, kernel ms — one call between two events,
and back to back — plain and bound ms); the last
line is a JSON object with ``ok`` and the device.  Imports neither jax nor
the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from mort_tpu_torch import (  # noqa: E402
    make_train_step, render, render_wavefront, require_cuda,
)
from mort_tpu_torch import _build, rng  # noqa: E402
from mort_tpu_torch.device import card_line  # noqa: E402
from mort_tpu_torch.profile_wavefront import device_times  # noqa: E402
from mort_tpu_torch.camera import derive_basis, get_rays_soa  # noqa: E402
from mort_tpu_torch.render import closest_hit as ch  # noqa: E402
from mort_tpu_torch.render.hitshade import finalize_and_shade  # noqa: E402
from mort_tpu_torch.render.intersect import (  # noqa: E402
    K_QUAD, K_SPHERE, T_MIN, media_pass, quad_frames,
)
from mort_tpu_torch.render.primtable import build_prim_table  # noqa: E402
from mort_tpu_torch.render.vec import V3  # noqa: E402
from mort_tpu_torch.scene import scenes as sc  # noqa: E402
from mort_tpu_torch.scene.build import World  # noqa: E402

R_PARITY = 1 << 18          # the default pool of scene 1: the kernel's R
R_SCENE9 = 1 << 16          # the default pool of scene 9 (> 1024 prims)
SEED = 69420
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 peak memory rate
FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
# float32 operations every (ray, surface primitive) pair costs in the
# kernel whatever the data: a sphere up to its discriminant (two 3-term dots
# and two subtractions for half_b, two dots and seven more ops for c_term,
# three for the discriminant), a quad up to its t test (two dots, a
# subtraction, a division)
SPHERE_OPS, QUAD_OPS = 34, 12
# float32 operations of one box slab test of "none" (box_admits and
# slab_enters): the bound (2), the slack (2), the widened box (6), the
# inverted-box check (1), six subtractions and six multiplies, ten min/max
# and three comparisons
SLAB_OPS = 36
# float32 operations of one child slab test of "bvh" (box_enters): six
# fused multiply-adds (12), six min/max for each axis's order, four for the
# entry and exit, and four comparisons
NODE_SLAB_OPS = 26
R_EDGES = 1 << 16           # rays of the scene9_edges set
R_SILHOUETTES = 1 << 16     # rays of each silhouettes set
# device clock cycles (~2.5 ms) that time_ms's sleep holds the card before
# calls timed back to back, longer than the host takes to queue them
SLEEP_CYCLES = 5_000_000
# float32 operations of the backward kernel per hit lane: a sphere lane
# recomputes the ray terms (23) and half_b, c_term, the discriminant and the
# root choice (38), forms the partials of t (20), the nine record terms (16)
# and d_rays (33); a quad lane its t (13), the four record terms (10) and
# d_rays (9)
BWD_SPHERE_OPS, BWD_QUAD_OPS = 130, 32
# The backward kernel's table gradients are float32 sums taken in atomic
# order, which changes from run to run, against the plain version's
# index_add_: they are held within BWD_SUM_RTOL of the sum of |terms| of
# each entry (float32 summation of n terms in two orders differs by about
# sqrt(n) * 6e-8 of that sum for random rounding; 2^17 terms on one
# entry give ~2e-5).
BWD_SUM_RTOL = 1e-4
GRAD_W, GRAD_H = 600, 338   # bench.py --grad's train step config
GRAD_SEEDS = (69420, 69421, 69422, 69423)   # warm-up, then three timed


def log(msg):
    print(msg, flush=True)


def assert_images_close(got, want, frac_ok=0.98, atol=2e-2, mean_tol=4e-3):
    """tests/conftest.py's rule (restated: that file imports jax): at least
    98% of pixels within 2e-2 on every channel, mean abs diff <= 4e-3."""
    diff = np.abs(np.asarray(got) - np.asarray(want))
    frac = float(np.mean(np.all(diff <= atol, axis=-1)))
    mean = float(diff.mean())
    assert frac >= frac_ok and mean <= mean_tol, (
        f"images differ: frac_within={frac:.4f} (need {frac_ok}), "
        f"mean_abs={mean:.6f} (need {mean_tol}); max={diff.max():.4f}")
    return frac, mean


def kernel_label(mangled):
    """closest_hit_none_kernel<false, 2> from its mangled name."""
    m = re.search(r"closest_hit_(?:none_|cull_|bvh_|bwd_)?kernel", mangled)
    if m is None:
        return mangled
    rest = mangled[m.end():]
    targs = rest[:rest.find("EEv") + 2] if rest.startswith("I") else ""
    args = re.findall(r"L([bi])(\d+)E", targs)
    vals = [("false", "true")[int(v)] if t == "b" else v for t, v in args]
    return m.group(0) + (f"<{', '.join(vals)}>" if vals else "")


def ptxas_report(name):
    """One line per kernel of ``name`` from its -Xptxas -v report:
    registers, stack frame, spills and shared memory."""
    lines, cur = [], None
    for line in _build.build_log(name).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = kernel_label(m.group(1))
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur:
            spills = (f"stack frame {m.group(1)} B, spills "
                      f"{m.group(2)}/{m.group(3)} B")
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            smem = re.search(r"(\d+) bytes smem", line)
            lines.append(f"{cur}: {m.group(1)} registers, {spills}, "
                         f"{smem.group(1) if smem else 0} B shared")
            cur = None
    return lines


SASS_CLASSES = ("LDS", "LDG", "STG", "LDL", "STL", "FADD", "FMUL", "FFMA",
                "MUFU", "FSETP", "FMNMX", "SHFL", "LDGSTS", "BAR")


def sass_mix(name, kernel="closest_hit_none_kernel<false"):
    """{(kernel, part): {opcode class: count}}: the static SASS instruction
    mix of the kernels of ``name`` whose label starts with ``kernel``
    (``cuobjdump -sass`` on the built library), for the whole kernel (part
    "all") and for each innermost loop that does float arithmetic (part
    "loop 0x<first>-0x<last>": the instructions from a backward branch's
    target to the branch, where no other such loop lies inside).
    Instructions predicated off for good (``@!PT``) are not counted."""
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()),
                             "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass",
                           str(_build.library_path(name))],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    mix = {}
    for block in text.split("Function : ")[1:]:
        label = kernel_label(block.split(None, 1)[0])
        if not label.startswith(kernel):
            continue
        ins = [(int(a, 16), op, rest) for a, pred, op, rest in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z0-9]+)([^;]*);",
            block) if pred.strip() != "@!PT"]
        loops = [(int(m.group(1), 16), a) for a, op, rest in ins
                 if op == "BRA" and (m := re.search(r"0x([0-9a-f]+)", rest))
                 and int(m.group(1), 16) < a]
        parts = {"all": (0, ins[-1][0] if ins else 0)}
        for lo, hi in loops:
            if not any((o_lo, o_hi) != (lo, hi) and lo <= o_lo
                       and o_hi <= hi for o_lo, o_hi in loops):
                parts[f"loop {lo:#x}-{hi:#x}"] = (lo, hi)
        for part, (lo, hi) in parts.items():
            ops = [op for a, op, _ in ins if lo <= a <= hi]
            counts = {c: sum(op == c for op in ops) for c in SASS_CLASSES}
            counts["total"] = len(ops)
            if part == "all" or counts["FADD"] + counts["FMUL"]:
                mix[label, part] = counts
    return mix


def reset_counts():
    torch.cuda.synchronize()
    for mode in ch.launch_count:
        ch.launch_count[mode] = 0


def read_counts():
    torch.cuda.synchronize()
    return dict(ch.launch_count)


class Scene:
    """A compiled scene on the card and its packed tables, per mode."""

    def __init__(self, world, dev):
        data, meta = world.compile()
        self.data, self.meta = data.to(dev), meta
        self.qf = quad_frames(self.data)
        self.table, self.mat_cols = build_prim_table(self.data, meta,
                                                     self.qf)
        self.packed = {mode: ch.pack_scene(self.data, meta, self.qf,
                                           self.table, mode)
                       for mode in ch.ACCELS}


def camera_bounce_rays(scene, cam, n, dev):
    """n camera rays of ``cam`` (random pixels and samples) and the bounces
    they take (shading as the wavefront does): 2n rays, less the bounces
    that have no direction (a path that ended on a light)."""
    g = torch.Generator().manual_seed(1)
    pix = torch.randint(0, cam.image_width * cam.image_height, (n,),
                        generator=g).to(dev)
    smp = torch.randint(0, cam.sqrt_spp ** 2, (n,), generator=g).to(dev)
    cam = cam.to(dev)
    ro, rd, tme = get_rays_soa(cam, derive_basis(cam), SEED, pix, smp,
                               no_defocus=True)
    bt, bk, bi, row = ch.closest_hit(scene.packed["none"], ro, rd, tme)
    bt, bk, bi = media_pass(scene.data, scene.meta, scene.qf, ro, rd, SEED,
                            pix, smp, 0, T_MIN, bt, bk, bi)
    out = finalize_and_shade(scene.data, scene.meta, scene.qf, scene.table,
                             scene.mat_cols, ro, rd, tme, bt, bk, bi, SEED,
                             pix, smp, 0, row_t=row)
    keep = torch.isfinite(torch.stack(list(out.new_dir))).all(dim=0)
    cat = lambda a, b: torch.cat([a, b[keep]])  # noqa: E731
    return (V3(*(cat(a, b) for a, b in zip(ro, out.p))),
            V3(*(cat(a, b) for a, b in zip(rd, out.new_dir))),
            cat(tme, tme))


def moving_mixed_world():
    """A moving sphere/quad scene (test_pallas_kernel.py's _mixed_world
    shape, larger)."""
    rs = np.random.RandomState(1)
    w = World()
    m = w.lambertian(w.solid_color([0.5, 0.5, 0.5]))
    for i in range(300):
        c = rs.randn(3) * 3
        if i % 2 == 0:
            w.sphere(c, 0.1 + 0.3 * rs.rand(), m,
                     center2=c + rs.randn(3) * 0.5)
        else:
            w.sphere(c, 0.1 + 0.3 * rs.rand(), m)
    for _ in range(200):
        w.quad(rs.randn(3) * 3, rs.randn(3), rs.randn(3), m)
    return w


def random_rays(n, dev):
    g = np.random.RandomState(3)
    ro = torch.from_numpy((g.randn(n, 3) * 6).astype(np.float32))
    rd = torch.from_numpy(g.randn(n, 3).astype(np.float32))
    tme = torch.from_numpy(g.rand(n).astype(np.float32))
    return V3.from_rows(ro.to(dev)), V3.from_rows(rd.to(dev)), tme.to(dev)


def compare(name, packed, rays, want):
    """Kernel vs plain version on the same card tensors: the whole [32, R]
    output bit-equal (t, kind, idx and the joined rows).  Returns the
    largest |dt| over hit lanes (0 when bit-equal)."""
    got = ch._launch(packed, rays, T_MIN)
    torch.cuda.synchronize()
    hit = want[ch.ROW_KIND] > 0
    t, wt = got[ch.ROW_T][hit], want[ch.ROW_T][hit]
    err = float((t - wt).abs().max()) if hit.any() else 0.0
    assert torch.equal(got[ch.ROW_KIND], want[ch.ROW_KIND]), \
        f"{name}: kind differs"
    assert torch.equal(got[ch.ROW_IDX], want[ch.ROW_IDX]), \
        f"{name}: idx differs"
    assert torch.equal(got[ch.ROW_T], want[ch.ROW_T]), \
        f"{name}: t differs (max |dt| {err:.3e})"
    assert torch.equal(got, want), f"{name}: joined rows differ"
    log(f"parity {name}: R={rays.shape[1]} hits={int(hit.sum())} t, kind, "
        f"idx and rows bit-equal to the plain version")
    return err


def time_ms(fn, reps=20, warmup=3, calls=1):
    """Median over ``reps`` samples of the ms per call.  With ``calls`` = 1,
    CUDA events around one call (the ``ms`` of the kernels line), which
    also counts the host's Python and launch time where it exceeds the
    kernel's; with more, CUDA events around ``calls`` calls queued behind a
    device-side sleep, so that the card runs them back to back: the kernel
    alone."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if calls > 1:
            torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def surface_counts(packed):
    """(surface spheres, surface quads) of a packed scene."""
    return (int((packed.sph[:packed.n_sph, 9] != 0).sum()),
            int((packed.quad[:packed.n_quad, 12] != 0).sum()))


def count_tests(name, packed, rays, want):
    """The (sphere, quad, box slab) tests one launch of ``packed.accel``
    performs, from the kernel's optional counter; the counted launch must
    still equal the plain version bit for bit.  In "none" every ray tests
    every surface sphere and every box, and at most every surface quad
    (every one when the scene has no closed box)."""
    n = torch.zeros(ch.N_TESTS, dtype=torch.int64, device=rays.device)
    got = ch._launch(packed, rays, T_MIN, n)
    torch.cuda.synchronize()
    assert torch.equal(got, want), f"{name}: the counted launch differs"
    n_s, n_q, n_b = (int(x) for x in n)
    if packed.accel == "none":
        R = rays.shape[1]
        surf_s, surf_q = surface_counts(packed)
        n_box = packed.aab_tab.shape[0]
        assert n_s == R * surf_s and n_b == R * n_box and n_q <= R * surf_q \
            and (n_box or n_q == R * surf_q), \
            f"{name}: counted {(n_s, n_q, n_b)} tests"
    return n_s, n_q, n_b


def bound_parts(packed, R, n_tests):
    """(bytes bound, operations bound) of one call in ms: the bytes the
    call must move (the [8, R] rays in, the [32, R] rows out, every table
    once) over HBM bandwidth, and the operations of the (sphere, quad, box
    slab) tests ``n_tests`` over the float32 peak."""
    tabs = [packed.sph, packed.quad, packed.joined]
    for t in (packed.accel_tab, packed.aab_tab, packed.aab_faces,
              packed.gen_rows):
        if t is not None:
            tabs.append(t)
    n_bytes = R * (8 + ch.ROW_K) * 4 + sum(t.numel() * 4 for t in tabs)
    n_s, n_q, n_b = n_tests
    slab = NODE_SLAB_OPS if packed.accel == "bvh" else SLAB_OPS
    return (n_bytes / HBM_BYTES_PER_S * 1e3,
            (n_s * SPHERE_OPS + n_q * QUAD_OPS + n_b * slab)
            / FP32_OPS_PER_S * 1e3)


def brute_force_tests(packed, R):
    """The tests of a scan of every surface primitive (the "none" kernel
    before its box cull), whose bound is printed beside the bound of the
    tests counted."""
    surf_s, surf_q = surface_counts(packed)
    return R * surf_s, R * surf_q, 0


def bound_ms(packed, R, n_tests):
    """The least time the card could take for one call: the larger of the
    two ``bound_parts``, and which it is."""
    t_bytes, t_ops = bound_parts(packed, R, n_tests)
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


ORIGINS = ("camera", "far", "face", "inside")


def box_bounds(data, meta):
    """(lo, hi), numpy [n_box, 3]: the unpadded bounds of the closed boxes of
    ``meta.aab``."""
    Q, u, v = data.quad_Q, data.quad_u, data.quad_v
    corners = torch.stack([Q, Q + u, Q + v, Q + u + v])
    faces = torch.tensor(meta.aab, device=Q.device).long()
    return (corners.amin(0)[faces].amin(1).cpu().numpy(),
            corners.amax(0)[faces].amax(1).cpu().numpy())


def box_edge_rays(lo, hi, eye, n, seed, origins=ORIGINS, tiny=0.15):
    """[8, n] float32 rays on the CPU aimed at points on the edges and
    corners of the boxes [lo, hi], each coordinate moved by -4..4 ulps, from
    the kinds of origin ``origins`` in turn: "camera" (``eye``), "far"
    (N(0, 1500^2) a coordinate), "face" (a point on a box face) and
    "inside" (a point inside a box, half of those with a random direction).
    A share ``tiny`` of the rays get one direction component under 1e-8."""
    g = np.random.RandomState(seed)

    def box_points(m):
        b = g.randint(0, lo.shape[0], m)
        return lo[b], hi[b], (lo[b] + g.rand(m, 3) * (hi[b] - lo[b])
                              ).astype(np.float32)

    L, H, p = box_points(n)
    # one free axis (an edge) or none (a corner)
    p = np.where(g.randint(0, 4, n)[:, None] == np.arange(3), p,
                 np.where(g.rand(n, 3) < 0.5, L, H)).astype(np.float32)
    ulps = g.randint(-4, 5, (n, 3))
    toward = np.where(ulps > 0, np.float32(np.inf), np.float32(-np.inf))
    for k in range(4):
        p = np.where(np.abs(ulps) > k, np.nextafter(p, toward), p)
    kind = np.asarray(origins)[np.arange(n) % len(origins)]
    L2, H2, o = box_points(n)
    axis = g.randint(0, 3, n)
    on_face = np.where(g.rand(n) < 0.5, L2[np.arange(n), axis],
                       H2[np.arange(n), axis])
    face, far = kind == "face", kind == "far"
    o[face, axis[face]] = on_face[face]
    o[kind == "camera"] = np.asarray(eye, np.float32)
    o[far] = g.randn(int(far.sum()), 3) * 1500
    d = (p - o).astype(np.float32)
    free = (kind == "inside") & (g.rand(n) < 0.5)
    d[free] = g.randn(int(free.sum()), 3)
    small = g.rand(n) < tiny
    d[small, g.randint(0, 3, n)[small]] = g.randn(int(small.sum())) * 1e-9
    rays = torch.zeros(8, n)
    rays[0:3] = torch.from_numpy(o).T
    rays[3:6] = torch.from_numpy(d).T
    rays[6] = torch.from_numpy(g.rand(n).astype(np.float32))
    return rays


def silhouette_rays(data, meta, eye, n, seed):
    """[8, n] float32 rays on the CPU that graze the silhouettes of the
    surface spheres of ``data`` (the largest, scene 1's r = 1000 ground,
    every fourth ray) at the ray's time.  Half start at ``eye`` and aim at
    the sphere's tangent cone from there; half lie along a line tangent to
    the sphere at a point near one of its six poles (where the sphere
    touches its box) or anywhere on it, from an origin 1e-2..3e3 back along
    that line.  The distance of closest approach is r (1 + delta), delta
    log-uniform in 1e-9..1e-2 of either sign."""
    g = np.random.RandomState(seed)
    ns = meta.n_spheres
    c, cv, r = (x[:ns].double().cpu().numpy() for x in (
        data.sph_center, data.sph_cvec, data.sph_radius))
    b = g.choice(np.flatnonzero(data.sph_surface[:ns].cpu().numpy()), n)
    b[::4] = np.argmax(np.abs(r))
    tm = g.rand(n)
    cen, rad = c[b] + tm[:, None] * cv[b], np.abs(r[b])
    delta = np.exp(g.uniform(np.log(1e-9), np.log(1e-2), n)) \
        * g.choice([-1.0, 1.0], n)

    def unit(x):
        return x / np.linalg.norm(x, axis=1, keepdims=True)

    def perp(w):
        """A random unit vector perpendicular to each row of w."""
        p = g.randn(len(w), 3)
        return unit(p - (p * w).sum(1, keepdims=True) * w)

    # the normal at the grazing point: near a pole, or anywhere
    pole = np.eye(3)[g.randint(0, 3, n)] * g.choice([-1.0, 1.0], (n, 1))
    normal = unit(np.where(g.rand(n, 1) < 0.5, pole + 1e-3 * g.randn(n, 3),
                           g.randn(n, 3)))
    tangent = perp(normal)
    back = np.exp(g.uniform(np.log(1e-2), np.log(3e3), n))[:, None]
    o = cen + normal * (rad * (1 + delta))[:, None] - tangent * back
    d = tangent * back
    # from the eye: aim past the centre at the tangent cone's distance
    w = cen - np.asarray(eye, np.float64)
    dist = np.linalg.norm(w, axis=1)
    cone = (dist > rad * 1.001) & (np.arange(n) % 2 == 0)
    s = rad * (1 + delta) * dist / np.sqrt(np.maximum(dist ** 2 - rad ** 2,
                                                      1e-30))
    aim = cen + perp(unit(w)) * s[:, None]
    o[cone] = np.asarray(eye, np.float64)
    d[cone] = (aim - o)[cone]
    rays = torch.zeros(8, n)
    rays[0:3] = torch.from_numpy(o.astype(np.float32)).T
    rays[3:6] = torch.from_numpy(d.astype(np.float32)).T
    rays[6] = torch.from_numpy(tm.astype(np.float32))
    return rays


def quad_share(s7, rays, card):
    """The share of "none"'s time that scene 7's (the Cornell box's) quads
    take on its camera and bounce rays, and the share of its axis-aligned
    quads (what the JAX package's _aaq_group_best takes): the kernel timed
    with every quad, without the axis-aligned ones and without any (the
    rows the kernel scans cut, so only these timings, not a result)."""
    p = s7.packed["none"]
    general = [r for r in p.gen_rows.tolist() if s7.meta.aaq_class[r] == 9]
    cuts = {"all": p.gen_rows,
            "general": torch.tensor(general, dtype=torch.int32,
                                    device=rays.device),
            "none": p.gen_rows[:0]}
    ms = {k: time_ms(lambda: ch._launch(dataclasses.replace(p, gen_rows=g),
                                        rays, T_MIN), calls=10)
          for k, g in cuts.items()}
    log(f"quad share scene7 R={rays.shape[1]} ({len(p.gen_rows)} quads, "
        f"{len(p.gen_rows) - len(general)} axis-aligned), ten calls back to "
        f"back: none {ms['all']:.4f} ms, without the axis-aligned quads {ms['general']:.4f} ms, without "
        f"quads {ms['none']:.4f} ms: quads {1 - ms['none'] / ms['all']:.4f}, "
        f"axis-aligned quads {1 - ms['general'] / ms['all']:.4f} of the time "
        f"| {card}")


def parity_and_timing(dev, card):
    """Phase 4.  Returns {mode: {"err", "ms", "ms_back_to_back",
    "plain_ms", "bound_ms", "bound_by"}} at scene 9's shapes (the bound of
    the tests counted), and the ray sets {name: (scene, rays, plain
    output)}."""
    world1, cam1 = sc.random_spheres()
    world9, cam9 = sc.final_scene(400, 250, 4)
    world16, cam16 = sc.spread_spheres()
    world7, cam7 = sc.build_scene(7)
    s1, s9, s16 = Scene(world1, dev), Scene(world9, dev), Scene(world16, dev)
    s7 = Scene(world7, dev)
    assert ch.auto_accel(s16.meta.n_spheres) == "bvh"
    stack = ch.stack_rays
    sets = {
        "scene1": (s1, stack(*camera_bounce_rays(s1, cam1, R_PARITY // 2,
                                                 dev))),
        "scene9": (s9, stack(*camera_bounce_rays(s9, cam9, R_SCENE9 // 2,
                                                 dev))),
        "scene7": (s7, stack(*camera_bounce_rays(s7, cam7, R_PARITY // 2,
                                                 dev))),
        "scene9_edges": (s9, box_edge_rays(*box_bounds(s9.data, s9.meta),
                                           cam9.lookfrom, R_EDGES, 11
                                           ).to(dev)),
        "moving_mixed": (Scene(moving_mixed_world(), dev),
                         stack(*random_rays(R_PARITY, dev))),
        "spread16k": (s16, stack(*camera_bounce_rays(s16, cam16,
                                                     R_PARITY // 2, dev))),
        "scene1_silhouettes": (s1, silhouette_rays(
            s1.data, s1.meta, cam1.lookfrom, R_SILHOUETTES, 12).to(dev)),
        "spread16k_silhouettes": (s16, silhouette_rays(
            s16.data, s16.meta, cam16.lookfrom, R_SILHOUETTES, 13).to(dev)),
    }
    err = dict.fromkeys(ch.ACCELS, 0.0)
    times, b2b, tests, out_sets = {}, {}, {}, {}
    for name, (scene, rays) in sets.items():
        R = rays.shape[1]
        want = ch.closest_hit_reference(scene.packed["none"], rays)
        out_sets[name] = (scene, rays, want)
        tests[name] = {}
        for mode in ch.ACCELS:
            err[mode] = max(err[mode], compare(
                f"{name}/{mode}", scene.packed[mode], rays, want))
            tests[name][mode] = count_tests(f"{name}/{mode}",
                                            scene.packed[mode], rays, want)
        row = {mode: time_ms(lambda: ch._launch(scene.packed[mode], rays,
                                                T_MIN))
               for mode in ch.ACCELS}
        b2b[name] = {mode: time_ms(lambda: ch._launch(scene.packed[mode],
                                                      rays, T_MIN), calls=10)
                     for mode in ch.ACCELS}
        plain = row["plain"] = time_ms(lambda: ch.closest_hit_reference(
            scene.packed["none"], rays), reps=3, warmup=1)
        times[name] = row
        parts = []
        for m in ch.ACCELS:
            t_bytes, t_ops = bound_parts(scene.packed[m], R, tests[name][m])
            n_s, n_q, n_b = tests[name][m]
            parts.append(f"{m} {row[m]:.4f} ms, back to back "
                         f"{b2b[name][m]:.4f} ms (operations bound "
                         f"{t_ops:.4f} ms for {n_s / R:.2f} sphere + "
                         f"{n_q / R:.2f} quad + {n_b / R:.1f} "
                         f"{'node' if m == 'bvh' else 'box'} slab tests a "
                         f"ray, bytes bound {t_bytes:.4f} ms)")
        brute = bound_parts(scene.packed["none"], R,
                            brute_force_tests(scene.packed["none"], R))[1]
        log(f"timing {name} R={R}: " + ", ".join(parts)
            + f", plain {plain:.4f} ms; none brute-force operations bound "
            f"{brute:.4f} ms | {card}")
    quad_share(s7, sets["scene7"][1], card)
    out = {}
    for mode in ch.ACCELS:
        b, by = bound_ms(s9.packed[mode], R_SCENE9, tests["scene9"][mode])
        out[mode] = {"err": err[mode], "ms": times["scene9"][mode],
                     "ms_back_to_back": b2b["scene9"][mode],
                     "plain_ms": times["scene9"]["plain"], "bound_ms": b,
                     "bound_by": by}
    for name in ("scene7", "scene9_edges", "scene1_silhouettes",
                 "spread16k_silhouettes"):
        del out_sets[name]
    return out, out_sets


def random_cotangents(R, dev, seed):
    """dt [R] and drow [32, R] from numpy."""
    g = np.random.RandomState(seed)
    dt = torch.from_numpy(g.randn(R).astype(np.float32)).to(dev)
    drow = torch.from_numpy(g.randn(ch.ROW_K, R).astype(np.float32)).to(dev)
    return dt, drow


def bwd_args(scene, rays, fwd, dt, drow):
    p = scene.packed["none"]
    return (rays, fwd[ch.ROW_KIND].to(torch.int32),
            fwd[ch.ROW_IDX].to(torch.int32), dt, drow, p.sph, p.quad,
            tuple(p.joined.shape), p.quad_base, T_MIN)


def compare_bwd(name, args):
    """The backward kernel against its plain version on the same card
    tensors: d_rays bit-equal (each lane's value is the same rounded ops),
    d_sph, d_quad and d_joined within BWD_SUM_RTOL of each entry's sum of
    |terms|.  Returns (largest |difference|, largest |difference| / sum of
    |terms|)."""
    got = ch._launch_bwd(*args)
    want = ch.closest_hit_bwd_reference(*args)
    scale = ch.closest_hit_bwd_reference(*args, absolute=True)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]), f"{name}: d_rays differ"
    err, rel = 0.0, 0.0
    for what, g, w, s in zip(("d_sph", "d_quad", "d_joined"), got[1:],
                             want[1:], scale[1:]):
        diff = (g - w).abs()
        if diff.numel():
            err = max(err, float(diff.max()))
            rel = max(rel, float((diff / s.clamp_min(1e-30)).max()))
        bad = int((diff > BWD_SUM_RTOL * s).sum())
        assert bad == 0, (f"{name}: {what} differs beyond {BWD_SUM_RTOL} of "
                          f"the sum of |terms| at {bad} entries (largest "
                          f"ratio {rel:.3e})")
    return err, rel


def bwd_bound_ms(args):
    """The least time of one backward call: the larger of the bytes it must
    move over HBM bandwidth, and its float32 operations per hit lane over
    the float32 peak.  Every lane reads kind and writes its 8 rows of
    d_rays; only a hit lane reads its 7 ray rows, idx, dt and the 28 rows
    of drow it uses (a miss drops its cotangents).  The record tables are
    read once and the three gradient tables written once."""
    rays, kind, _idx, _dt, _drow, sph, quad, joined_shape = args[:8]
    R = rays.shape[1]
    n_join, k_join = joined_shape
    n_sph_hits = int((kind == K_SPHERE).sum())
    n_quad_hits = int((kind == K_QUAD).sum())
    n_bytes = (4 * R * (1 + 8)
               + 4 * (n_sph_hits + n_quad_hits) * (7 + 1 + 1 + (k_join + 1))
               + 4 * 2 * (sph.numel() + quad.numel()) + 4 * n_join * k_join)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    n_ops = n_sph_hits * BWD_SPHERE_OPS + n_quad_hits * BWD_QUAD_OPS
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def backward_parity_and_timing(dev, card, sets):
    """Phase 9.  Returns the closest_hit_bwd record at the train step's
    shapes (scene 1, R = 202,800)."""
    err = 0.0
    for k, (name, (scene, rays, fwd)) in enumerate(sets.items()):
        args = bwd_args(scene, rays, fwd, *random_cotangents(
            rays.shape[1], dev, 10 + k))
        e, rel = compare_bwd(f"{name}/bwd", args)
        err = max(err, e)
        log(f"bwd parity {name}: R={rays.shape[1]} "
            f"hits={int((args[1] > 0).sum())} d_rays bit-equal; table sums "
            f"max |diff| {e:.3e}, max |diff| / sum|terms| {rel:.3e} (limit "
            f"{BWD_SUM_RTOL})")
    # the train step's first bounce: every pixel's camera ray, sample 0
    s1 = sets["scene1"][0]
    _w, cam = sc.random_spheres()
    cam = cam.replace(image_width=GRAD_W, image_height=GRAD_H, sqrt_spp=2,
                      bounce_limit=8).to(dev)
    R = GRAD_W * GRAD_H
    pix = torch.arange(R, device=dev)
    ro, rd, tme = get_rays_soa(cam, derive_basis(cam), SEED, pix,
                               torch.zeros_like(pix))
    rays = ch.stack_rays(ro, rd, tme)
    fwd = ch._launch(s1.packed["none"], rays, T_MIN)
    args = bwd_args(s1, rays, fwd, *random_cotangents(R, dev, 9))
    e, rel = compare_bwd("scene1 grad/bwd", args)
    err = max(err, e)
    ms = time_ms(lambda: ch._launch_bwd(*args))
    ms_b2b = time_ms(lambda: ch._launch_bwd(*args), calls=10)
    plain = time_ms(lambda: ch.closest_hit_bwd_reference(*args), reps=5,
                    warmup=1)
    b, by = bwd_bound_ms(args)
    hits = int((args[1] > 0).sum())
    ground = int((args[2][args[1] == K_SPHERE] == int(torch.argmax(
        s1.data.sph_radius))).sum())
    log(f"bwd timing scene1 grad R={R} ({hits} hits, {ground} on the ground "
        f"sphere): kernel {ms:.4f} ms, back to back {ms_b2b:.4f} ms, plain "
        f"{plain:.4f} ms, bound {b:.4f} ms by {by} | {card}")
    return {"err": err, "ms": ms, "ms_back_to_back": ms_b2b,
            "plain_ms": plain, "bound_ms": b, "bound_by": by}


def step_grads_ok(loss, grads, need=()):
    assert bool(torch.isfinite(loss)), f"loss {float(loss)}"
    for k, g in grads.items():
        assert bool(torch.isfinite(g).all()), f"non-finite grad {k}"
    for k in need:
        assert bool((grads[k] != 0).any()), f"zero grad {k}"


def train_step_main_path(dev, card):
    """Phase 10: the scene-1 train step at bench.py --grad's config."""
    world, cam = sc.random_spheres()
    data, meta = world.compile()
    cam = cam.replace(image_width=GRAD_W, image_height=GRAD_H, sqrt_spp=2,
                      bounce_limit=8)
    steps_per_run = len(GRAD_SEEDS)
    per_step = cam.sqrt_spp ** 2 * cam.bounce_limit
    n_paths = GRAD_W * GRAD_H * cam.sqrt_spp ** 2
    target = np.zeros((GRAD_H, GRAD_W, 3), np.float32)
    step = make_train_step(meta)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    loss, grads = step(data, cam, target, GRAD_SEEDS[0])
    float(loss)
    walls = []
    for seed in GRAD_SEEDS[1:]:
        t0 = time.perf_counter()
        loss, grads = step(data, cam, target, seed)
        float(loss)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    step_grads_ok(loss, grads, ("sph_center", "mat_albedo", "tex_color"))
    assert counts["none"] == steps_per_run * per_step, counts
    assert counts["bwd"] == steps_per_run * per_step, counts
    wall = statistics.median(walls)
    log(f"main path train step scene1 {GRAD_W}x{GRAD_H} @ "
        f"{cam.sqrt_spp ** 2}spp depth {cam.bounce_limit}: median wall "
        f"{wall:.3f} s ({', '.join(f'{w:.3f}' for w in walls)}), "
        f"{n_paths / wall:.1f} grad paths/s, loss {float(loss):.6f}, "
        f"launches per step none {counts['none'] // steps_per_run} bwd "
        f"{counts['bwd'] // steps_per_run} ({steps_per_run} steps), peak "
        f"memory {peak / 2 ** 30:.3f} GiB | {card}")
    return counts


def lockstep_render(dev):
    """Phase 11: the lockstep render of scene 1 on the card, through the
    kernel and through the plain closest hit, and against the wavefront."""
    world, cam = sc.random_spheres()
    data, meta = world.compile()
    cam = cam.replace(image_width=200, image_height=112, sqrt_spp=4,
                      bounce_limit=20)
    reset_counts()
    a = render(data, meta, cam, seed=SEED)
    counts = read_counts()
    assert counts["none"] > 0, "the lockstep render launched no kernel"
    b = render(data, meta, cam, seed=SEED, use_kernel=False)
    c = render_wavefront(data, meta, cam, dev, seed=SEED)
    a, b, c = (x.cpu().numpy() for x in (a, b, c))
    assert np.isfinite(a).all(), "non-finite pixels"
    fp, mp = assert_images_close(a, b)
    fw, mw = assert_images_close(a, c)
    log(f"lockstep render scene1 200x112 @ 16spp depth 20: kernel "
        f"({counts['none']} launches) vs plain frac_within={fp:.5f}, "
        f"mean_abs={mp:.3e}; vs render_wavefront frac_within={fw:.5f}, "
        f"mean_abs={mw:.3e}")


def train_step_card_vs_cpu(dev):
    """Phase 12: the Cornell box step through the kernels on the card
    against the same step through their plain versions on the CPU."""
    world, cam = sc.cornell_box()
    data, meta = world.compile()
    cam = cam.replace(image_width=12, image_height=12, sqrt_spp=2,
                      bounce_limit=6)
    target = render(data, meta, cam, seed=SEED).cpu().numpy() * 0.9
    reset_counts()
    loss, grads = make_train_step(meta)(data, cam, target, SEED)
    counts = read_counts()
    assert counts["none"] > 0 and counts["bwd"] > 0, counts
    c_loss, c_grads = make_train_step(meta, device="cpu", use_kernel=True)(
        data, cam, target, SEED)
    step_grads_ok(loss, grads)
    scale = max(float(g.abs().max()) for g in c_grads.values())
    worst = 0.0
    for k, g in grads.items():
        g, w = g.cpu(), c_grads[k]
        # the two run the same ops, but CUDA's and the CPU's exp, log, sin
        # and pow may differ in the last bit, and the CPU sums in another
        # order: the tolerance of the port-vs-JAX gradient tests
        torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-5 * scale,
                                   msg=lambda m, k=k: f"{k}: {m}")
        worst = max(worst, float((g - w).abs().max()) / scale)
    torch.testing.assert_close(loss.cpu(), c_loss, rtol=1e-4, atol=0.0)
    x_loss, x_grads = make_train_step(meta, use_kernel=False)(
        data, cam, target, SEED)
    step_grads_ok(x_loss, x_grads)
    log(f"train step cornell 12x12 @ 4spp depth 6: card loss "
        f"{float(loss):.7f} vs CPU {float(c_loss):.7f}; grads max |diff| / "
        f"max|g| {worst:.3e}; card intersect_best route loss "
        f"{float(x_loss):.7f}, grads finite")


def render_pair(data, meta, cam, dev):
    """The kernel's and the plain closest hit's image of one config, and
    the kernel launches per mode of the first."""
    reset_counts()
    a = render_wavefront(data, meta, cam, dev, seed=SEED)
    counts = read_counts()
    b = render_wavefront(data, meta, cam, dev, seed=SEED, use_kernel=False)
    assert bool(torch.isfinite(a).all()), "non-finite pixels"
    return a.cpu().numpy(), b.cpu().numpy(), counts


def main_path(name, world, cam, dev, card, profiled=False):
    """Drive ``render_wavefront`` once at ``cam``'s config; returns the
    launch counts per mode.  ``profiled``: then render the same frame once
    more under ``torch.profiler`` and print the closest-hit kernels' share
    of device time and the device's idle share of the first run's wall."""
    data, meta = world.compile()
    spp = cam.sqrt_spp ** 2
    n_paths = cam.image_width * cam.image_height * spp
    reset_counts()
    t0 = time.perf_counter()
    img, stats = render_wavefront(data, meta, cam, dev, seed=SEED,
                                  return_stats=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    assert sum(counts.values()) > 0, f"{name}: the kernel never launched"
    assert img.shape == (cam.image_height, cam.image_width, 3)
    assert bool(torch.isfinite(img).all()), "non-finite pixels"
    mean = float(img.mean())
    assert 0.01 < mean < 2.0, f"implausible image mean {mean}"
    segs = stats["useful_segments"]
    log(f"main path {name} {cam.image_width}x{cam.image_height} @ {spp}spp "
        f"depth {cam.bounce_limit}: wall {wall:.3f} s, "
        f"{n_paths / wall:.1f} paths/s, {segs / wall:.1f} segments/s, "
        f"occupancy {segs / stats['slots_executed']:.4f}, "
        f"{stats['iterations']} rounds, kernel launches {counts}, "
        f"image mean {mean:.5f} | {card}")
    if profiled:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            render_wavefront(data, meta, cam, dev, seed=SEED)
            torch.cuda.synchronize()
        _, busy_us, n_launch, modes = device_times(prof)
        assert busy_us > 0, f"{name}: the profiler saw no device time"
        log(f"main path {name} profiled: device busy {busy_us / 1e6:.4f} s "
            f"(idle share {1 - busy_us / 1e6 / wall:.4f} of the unprofiled "
            f"wall), {n_launch} device kernels; closest-hit share of device "
            f"time " + ", ".join(f"{m} {us / busy_us:.4f} ({us / 1e3:.3f} "
                                 f"ms)" for m, us in modes.items() if us)
            + f" | {card}")
    return counts


def main():
    t_start = time.perf_counter()
    # ---- 1. card ----
    dev = require_cuda()
    card = card_line()
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    log(f"card: {torch.cuda.get_device_name(dev)} | nvidia-smi: {card} | "
        f"SM clock, max SM clock: {clocks} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | devices {torch.cuda.device_count()}")

    # ---- 2. build ----
    t0 = time.perf_counter()
    built = _build.library_path("closest_hit").exists()
    _build.load_library("closest_hit")
    build_s = time.perf_counter() - t0
    log(f"build: closest_hit {'loaded from cache' if built else 'compiled'}"
        f" in {build_s:.2f} s -> {_build.library_path('closest_hit')}")
    for line in ptxas_report("closest_hit"):
        log(f"ptxas {line}")
    for kernel in ("closest_hit_none_kernel<false",
                   "closest_hit_bvh_kernel<false"):
        for (label, part), counts in sass_mix("closest_hit", kernel).items():
            log(f"sass {label} {part}: " + ", ".join(
                f"{k} {v}" for k, v in counts.items() if v))

    # ---- 3. philox ----
    u = rng.uniform4(SEED, torch.tensor([123], device=dev),
                     torch.tensor([4], device=dev), 2, 1)
    got = [float(x[0]) for x in u]
    want = [0.7667282223701477, 0.9874579310417175,
            0.48183852434158325, 0.6557576656341553]
    assert got == want, f"philox on the card: {got} != {want}"
    log(f"philox: pinned vector reproduced bit for bit on {dev}")

    # ---- 4. every mode vs the plain version, and timings ----
    kern, sets = parity_and_timing(dev, card)
    log(f"phase 4 done at {time.perf_counter() - t_start:.1f} s")

    # ---- 5. main path: scene 1 at its bench config ----
    world1, cam1 = sc.random_spheres()
    counts1 = main_path("scene1", world1, cam1, dev, card)
    data1, meta1 = world1.compile()
    small = cam1.replace(image_width=200, image_height=112, sqrt_spp=4)
    a, b, _ = render_pair(data1, meta1, small, dev)
    # on the card index_add_ adds in atomic order, so the last bits of a
    # pixel can vary from run to run: compare by the image rule
    frac, mdiff = assert_images_close(a, b)
    log(f"main path kernel vs plain closest-hit, scene1 "
        f"{small.image_width}x{small.image_height} @ {small.sqrt_spp ** 2}spp"
        f" depth {small.bounce_limit}: frac_within={frac:.5f}, "
        f"mean_abs={mdiff:.3e}")

    # ---- 6. main path: scene 9 at its code-true config ----
    world9, cam9 = sc.final_scene(400, 250, 4)
    counts9 = main_path("scene9", world9, cam9, dev, card)
    assert counts9["none"] > 0, "scene 9's auto accel should be none"

    # ---- 7. scene 9 four ways: none, bvh, cull kernels and plain ----
    data9, meta9 = world9.compile()
    small9 = cam9.replace(image_width=100, image_height=100, sqrt_spp=4)
    imgs, four_counts = {}, {}
    for mode in ch.ACCELS:
        reset_counts()
        imgs[mode] = render_wavefront(data9, meta9, small9, dev, seed=SEED,
                                      accel=mode).cpu().numpy()
        four_counts[mode] = read_counts()[mode]
        assert four_counts[mode] > 0, f"{mode}: no launch"
    plain = render_wavefront(data9, meta9, small9, dev, seed=SEED,
                             use_kernel=False).cpu().numpy()
    for mode in ch.ACCELS:
        frac, mdiff = assert_images_close(imgs[mode], plain)
        log(f"scene9 100x100 @ 16spp depth 4, {mode} kernel "
            f"({four_counts[mode]} launches) vs plain: frac_within="
            f"{frac:.5f}, mean_abs={mdiff:.3e}")

    # ---- 8. every scene on the card, and the 16k-sphere scene ----
    for idx in (2, 3, 4, 5, 6, 7, 8, 10):
        world, cam = sc.build_scene(idx)
        data, meta = world.compile()
        h = max(1, int(48 * cam.image_height / cam.image_width))
        golden = cam.replace(image_width=48, image_height=h, sqrt_spp=2,
                             bounce_limit=8)
        a, b, counts = render_pair(data, meta, golden, dev)
        assert counts["none"] > 0, f"scene {idx}: no kernel launch"
        frac, mdiff = assert_images_close(a, b)
        log(f"scene{idx} golden config: kernel ({counts['none']} launches) "
            f"vs plain frac_within={frac:.5f}, mean_abs={mdiff:.3e}, "
            f"image mean {float(a.mean()):.4f}")
    world16, cam16 = sc.spread_spheres()
    counts16m = main_path("spread16k", world16, cam16, dev, card,
                          profiled=True)
    assert counts16m["bvh"] > 0, "16k spheres: the auto policy ran no bvh"
    data16, meta16 = world16.compile()
    small16 = cam16.replace(image_width=160, image_height=90, sqrt_spp=2,
                            bounce_limit=4)
    a, b, counts16 = render_pair(data16, meta16, small16, dev)
    assert counts16["bvh"] > 0, "16k spheres: the auto policy ran no bvh"
    frac, mdiff = assert_images_close(a, b)
    log(f"spread16k 160x90 @ 4spp depth 4, auto accel: bvh kernel "
        f"({counts16['bvh']} launches) vs plain frac_within={frac:.5f}, "
        f"mean_abs={mdiff:.3e}")

    # ---- 9. the backward kernel vs its plain version, and timings ----
    kern["bwd"] = backward_parity_and_timing(dev, card, sets)
    del sets
    log(f"phase 9 done at {time.perf_counter() - t_start:.1f} s")

    # ---- 10. main path: the scene-1 train step ----
    counts10 = train_step_main_path(dev, card)
    log(f"phase 10 done at {time.perf_counter() - t_start:.1f} s")

    # ---- 11. the lockstep render on the card ----
    lockstep_render(dev)

    # ---- 12. the Cornell train step, card against CPU ----
    train_step_card_vs_cpu(dev)

    launches = {"none": counts9["none"], "bvh": counts16m["bvh"],
                "cull": four_counts["cull"], "bwd": counts10["bwd"]}
    log(f"launches: none {counts9['none']} (scene 9 main path; scene 1 main "
        f"path {counts1['none']}), bvh {launches['bvh']} (spread16k main "
        f"path; scene 9 four-way {four_counts['bvh']}, spread16k 160x90 "
        f"{counts16['bvh']}), cull {launches['cull']} (scene 9 four-way), "
        f"bwd {launches['bwd']} (the train step main path, "
        f"{len(GRAD_SEEDS)} steps)")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    names = {"none": "closest_hit", "bvh": "closest_hit_bvh",
             "cull": "closest_hit_cull", "bwd": "closest_hit_bwd"}
    replaces = dict.fromkeys(ch.ACCELS,
                             "mort_tpu/render/pallas_intersect.py:1215")
    replaces["bwd"] = "mort_tpu/render/pallas_intersect.py:1305"
    shapes = dict.fromkeys(ch.ACCELS, f"scene9 R={R_SCENE9}")
    shapes["bwd"] = f"scene1 grad R={GRAD_W * GRAD_H}"
    log(json.dumps({"kernels": [{
        "name": names[k], "route": "cuda",
        "source": "mort_tpu_torch/csrc/closest_hit.cu",
        "replaces": replaces[k], "launches": launches[k],
        "max_abs_err": kern[k]["err"], "ms": kern[k]["ms"],
        "ms_back_to_back": kern[k]["ms_back_to_back"],
        "plain_ms": kern[k]["plain_ms"], "bound_ms": kern[k]["bound_ms"],
        "bound_by": kern[k]["bound_by"], "library_ms": None,
        "shape": shapes[k]} for k in ch.ACCELS + ("bwd",)]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
