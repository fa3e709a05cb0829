#!/usr/bin/env python3
"""Build and run the port on one NVIDIA card, as a user would.

    python3 chip_smoke.py

Phases, one line each or more (any failure raises and exits non-zero):

1. card: the device, its name and power limit (nvidia-smi), versions;
2. build: nvcc-compiles csrc/closest_hit.cu (or loads it from the build
   cache) and reports the seconds, each kernel's registers, spills and
   shared memory (``-Xptxas -v``), the static SASS instruction mix of
   the "none", "bvh" and "cull" test kernels (``cuobjdump -sass``), and no
   float atomic in the backward's six kernels or in the "cull" kernels;
3. philox: nvcc-compiles csrc/philox.cu (its -Xptxas -v line), the pinned
   Philox vector of tests/test_rng.py on the card, the kernel bit-equal to
   the plain version (``rng.uniform4_plain``) on CPU copies of its
   operands, its time one call and back to back at 2^18, 2^16 and 202,800
   lanes beside its byte bound and the plain version's on the card, the
   wrapper's host time part by part, the device kernels a draw dispatches
   on each route (``torch.profiler``), and ``rng.launch_count`` after a
   scene-1 frame and a train step (no plain call on card operands; the
   kernels line's ``philox_uniform4`` row);
4. parity: the CUDA closest-hit kernel in each accel mode ("none", "bvh",
   "cull") against its plain PyTorch version on the same card tensors, on
   eleven ray sets — scene 1 (2^18 camera rays and their bounces), scene 9
   (2^16, its default pool), scene 7 (2^18: the Cornell box, quads only),
   scene 5 (2^18: every surface row an axis-aligned quad), scene9_edges
   (2^16 rays aimed at scene 9's box edges and corners, from its camera,
   from far away, from box faces and from inside boxes, some with a
   direction component under 1e-8), scene5_ and scene6_edges (4096 rays at
   the window edges of the axis-aligned quads, some with a component under
   1e-8), a moving sphere/quad scene (2^18), a 16,384-sphere spread scene
   (2^18), and 2^16 rays grazing the sphere silhouettes of scene 1 (its
   r = 1000 ground among them) and of the spread scene — t, kind, idx and
   rows bit-equal, also from a launch that counts its sphere, quad, box or
   node slab and axis-aligned quad tests and "cull"'s pairs (ray, entered
   sub-cluster) (printed a ray); then every mode and the plain version
   timed with CUDA events on each set, one call between two events and ten
   calls back to back (the four-way line: none / cull / bvh back to back
   on scenes 1, 7, 9 and spread16k), the share of "none"'s
   time that scene 7's quads and its axis-aligned quads take, and the rows
   emitted on hit lanes against the joined table's;
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
9. backward parity: the CUDA backward kernels (the gradient of the closest
   hit) against their plain versions on phase 4's four ray sets with random
   cotangents, on the train step's rays and on a bounce captured from a
   real train step — three launches bit-identical, d_rays and the table
   gradients bit-equal to ``closest_hit_bwd_ordered`` (the plain mirror of
   their order of adds), d_rays bit-equal to ``closest_hit_bwd_reference``
   and the tables within BWD_SUM_RTOL of its sum of |terms| per entry —
   and timed on scene 1's rays at the train step's config (R = 202,800)
   and on the captured bounce;
10. main path, the train step: ``make_train_step`` on scene 1 at
   ``bench.py --grad``'s config (600x338, 4 spp, depth 8), one warm-up step
   and three timed ones, launch counts reset just before and read just
   after (32 forward and 32 backward launches a step): the first call
   runs eagerly and captures the step into a CUDA graph, the three timed
   ones replay it;
11. the lockstep ``render`` of scene 1 (200x112, 16 spp, depth 20) through
   the kernel (replays of the lockstep graphs, one "none" launch a bounce
   step), through the plain closest hit and against ``render_wavefront``,
   by the image rule;
12. the Cornell box train step (12x12, 4 spp, depth 6) on the card against
   the same step on the CPU (the Function's plain versions), and the card's
   ``intersect_best`` route;
13. main path, the CLI: ``cli.main(["render", "5", ...])`` at scene 5's
   code-true config (400x400, 100 spp, depth 50) in-process, launch counts
   reset just before and read just after, the PNG read back; the same
   command through ``python -m mort_tpu_torch.cli`` (an NPZ, held against an
   in-process ``render_wavefront`` by the image rule); ``cli bench 5``;
14. main path, progressive: scene 6 at 600x600, depth 50, 36 spp, spt 12,
   uninterrupted, then interrupted after two layers and resumed from its
   checkpoint: bit-equal;
15. the viewer: ``view`` on scene 6 at 64x64 with movement, a drag and
   saved frames;
16. main path, forced "cull": ``render_wavefront(..., accel="cull")`` on
   scene 9 at 400x400, depth 4, spp cut from 225 to 16 (the run's time),
   launch counts reset just before and read just after; beside it the same
   config through the auto accel ("none"), in the order none, cull, cull,
   none, none (the third and fifth replay the span program kept from the
   run before: 0 captures), the five images bit-equal; half the frame's
   tasks (every pixel once) rendered once more under ``torch.profiler``
   for the "cull" kernels' share of device time;
17. the sharded paths (``parallel/sharding.py``): (a) on a 1-rank NCCL
   group, main path ``render_wavefront(mesh=make_mesh(1))`` on scene 1 at
   its bench config, launch counts reset just before and read just after,
   its wall beside phase 5's; main path ``make_train_step(meta,
   make_mesh(1))`` at phase 10's config, against ``mesh=None`` by phase
   10's rule, with its all-reduce count; (b) the script starts itself twice
   (``--rank r --world 2``) as gloo ranks sharing the one card: the
   wavefront (scene 1 at 300x169, 16 spp, depth 20; spread16k at 160x90
   through "bvh") bit-equal to one rank, with each span's rounds
   recorded on every rank (``_span_core`` wrapped) and every rank's
   ``iterations`` the sum over spans of the largest rank's rounds and its
   ``slots_executed`` every rank's rounds (the JAX package's rule),
   ``render_sharded`` (replays of the lockstep graphs on every rank) by
   the image rule, the train step's grads within rtol 5e-3, a scene-6
   progressive render checkpointed on two ranks resumed on one
   bit-identical to an uninterrupted one, every rank's launches above 0,
   and the 1-rank mesh bit-equal to the render without a mesh over the
   same layer-aligned spans at that scene-1 config (at full size it would
   cost phase 5's wall again); a worker that fails or outlives its
   timeout fails the run;
   (c) the host BVH builder: g++ builds it and it equals the numpy builder
   bit for bit;
18. the parity gate (``mort_tpu_torch.parity``): the 13 configs of
   tools/tpu_parity.py (all ten scenes at 120 px, 16 spp, depth 10, scene
   6 at depth 50, scene 1 forced to "bvh" and to "cull") rendered on the
   card at seeds A and B and held against the JAX package's committed CPU
   images (``mort_tpu_torch/data/parity_refs.npz``) by the tool's noise
   and bias rules; one line a config, then a ``{"parity": ...}`` record;
19. BASELINE config #5 (``mort_tpu_torch.config5``): final_scene at
   1920x1080 and its depth 40 with spp cut to 1 (the run's time) after a
   4096-task warm-up span, then the train step at its own 480x270, 4 spp,
   depth 8; launch counts reset just before and read just after; the
   warm-up span captures the span program, the frame replays it;
20. the bench entry (``mort_tpu_torch.bench``): scene 5's record (2
   frames) and the ``--grad`` record, each summary line checked for
   bench.py's four keys; the warm-up span captures, the frames capture
   nothing;
21. the spans' CUDA graphs: every wavefront render above (phases 5-8,
   13, 14, 16, 17, 19) ran its rounds as replays of one span program
   kept by graph key across spans and calls (``render_wavefront``'s only
   route on a card: one capture a key, after the key's one eager round;
   each main path's captures and replays are printed and checked); here
   against the eager rounds (``_span_core``'s private ``eager``): (a)
   scene 9 at 100x100, 16 spp through "none", "bvh" and "cull", spread16k
   at 160x90 and progressive scene 6 at 48x48, over layer-aligned spans,
   each from a new key: images bit-equal as raw int32, rounds, useful
   segments, slots and launches equal, one capture a call; (b) scene 1 at
   1200x675 with spp and depth cut from 100 and 20 to 36 and 8 (the run's
   time; its scene-9 frames at 400x400, 16 spp, were cut for phase 23),
   in the order graph, eager, graph (the second graph frame replays the
   kept key): wall, peak memory, host reads, captures, capture seconds,
   the same stats and launches, the images by the image rule; then each
   route's frame once more under ``torch.profiler``: its idle share and
   kernels a bounce step; (c) three frames of one key each on the graph
   route, scene 9 at 100x100, 16 spp over two layer-aligned spans,
   spread16k at its own 400x225 and scene 1 at its bench config through
   ``make_mesh(1)`` (13 spans): 1 capture, then 0 and 0 with no eager
   round, the three bit-equal; walls, captures, replays and the memory
   the kept program holds after the third;
22. the train step's CUDA graph: every train step above (phases 10, 12,
   17, 19, 20) ran its first call eagerly, captured it and replayed the
   graph for every later call (``make_train_step``'s only route on a card;
   each main path's step graph counts are printed and checked); here
   against the eager step (``make_train_step``'s private ``_eager``) at
   phase 10's config: each route's first call (the capture's seconds),
   then three seeds on both routes in turns: wall, grad paths/s, peak
   memory, 32 forward and 32 backward launches a step on both, no
   recapture across seeds; loss and grads bit-equal where two eager steps
   are, else within phase 17's tolerance; one step of each route under
   ``torch.profiler``: idle share, kernels a bounce, the closest hit's
   forward and backward device seconds;
23. the lockstep forward's CUDA graphs: ``render``, ``render_progressive``
   and ``render_sharded`` above (phases 11, 12, 17) replayed the captured
   "start" and "bounce" (``renderer.radiance_batches``' only route on a
   card; each main path's lockstep counts are printed and checked); here
   against the eager route (their private ``_eager``): (a) ``render``'s
   lockstep on scene 9 at 100x100, 16 spp, depth 4 through "none", "bvh"
   and "cull"; ``render(use_kernel=False)`` on the Cornell box at 48x48,
   16 spp, depth 8; ``render_progressive`` on the Cornell box at its own
   600x600 (three batches of 2^17 pixels, the last short), 4 spp, depth 8,
   in steps of 3 and 1 samples; ``render_sharded`` over ``make_mesh(1)``
   on scene 1 at 200x112, 16 spp, depth 20, with and without
   ``differentiable``: images bit-equal as raw int32, the same launches,
   bounces and host reads; (b) scene 1 at 1200x675 and depth 20 (13
   batches of 2^16 pixels) with spp cut from 100 to 4 (the run's time),
   in the order graph, eager, graph: wall, paths/s, bounces, host reads,
   captures, capture seconds, launches (equal), peak allocated and
   reserved memory, the images bit-equal; then one frame of each route
   under ``torch.profiler``: idle share and kernels a bounce step;
24. the program's spans (``metrics``) and its graphs' timing events: (a)
   scene 1 at 1200x675, 4 spp, depth 20 (one layer) on the graph route,
   every replayed round's device time (the timing events captured into
   the round graph) above 0 and at most its period on the host's clock,
   one "wavefront.read" a loop read and one "wavefront.launch" a replay,
   and the image bit-equal to the eager route's; (b) the train step at
   phase 10's config, four replays: each read replay's device time above
   0 and at most its step's period, and loss and gradients bit-equal to
   the eager route where two eager steps are, else within phase 22's
   tolerance; (c) one viewer call (a camera event and 8 one-sample frames
   of scene 1 at 1200x675, depth 20) under ``metrics.trace``: no device
   event of the program's ranges, every span in ``trace.json``, and the
   device's idle gaps by the innermost span open on the host, those over
   1 ms listed with their spans, none of them outside the viewer's; (d)
   the recorder's cost on this host, ns a span recorded and forwarded to
   a profiler;
25. the noise kernel (``csrc/noise.cu``): its build (-Xptxas -v line),
   ``textures.marble_kernel`` against ``marble_plain`` on the same card
   operands (scene 9's noise row at the int32 lattice extremes and at
   scales 0.5, 40 and 900) and against the CPU's plain route,
   ``texture_value`` on every texture row of scenes 4 and 9 through both
   routes (lanes off and the largest difference: bit-equal, or within
   1e-6), its time one call and back to back at 2^16 and 2^18 lanes
   beside its bound (operations) and the plain route's, the device kernels
   a call on each route (``torch.profiler``, in a process of its own), and
   ``textures.launch_count`` after one scene-9 frame at its bench config
   from a new graph key (no plain call; the kernels line's
   ``noise_marble`` row).

Every phase prints its seconds.  Files go to build/chip_smoke/
(git-ignored).  The last lines are a JSON record of phase 24
(``{"spans": ...}``), a JSON record of phase 25 (``{"noise": ...}``), a
JSON record of phase 3 (``{"philox": ...}``), a
JSON record of phase 23
(``{"lockstep_graph": ...}``), a JSON record of phase 22
(``{"step_graph": ...}``), a JSON record of phase 21
(``{"span_graph": ...}``), a JSON record of phases 18-20
(``{"tools": ...}``), a JSON record of phase 17 (``{"sharding": ...}``:
walls, launches, collectives,
bit-equal flags), a JSON record of the numerics (``{"precision": ...}``:
TF32 off, each kernel's largest error, rows bit-equal on hit lanes), a
JSON record of the kernels (launches on the paths above, the largest error
against the plain version, kernel ms — one call between two events, and
back to back — plain and bound ms), the nvidia-smi name/power line, and a
JSON object with ``ok`` and the device.  Imports neither jax nor the JAX
package.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import datetime
import io
import json
import os
import re
import statistics
import struct
import subprocess
import sys
import time
import zlib

import numpy as np
import torch
from torch.autograd import DeviceType

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from mort_tpu_torch import (  # noqa: E402
    make_mesh, make_train_step, render, render_sharded, render_wavefront,
    require_cuda,
)
from mort_tpu_torch import _build, metrics, rng  # noqa: E402
from mort_tpu_torch.device import card_line  # noqa: E402
from mort_tpu_torch.parallel import sharding  # noqa: E402
from mort_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from mort_tpu_torch.profile_wavefront import (  # noqa: E402
    OUTSIDE, SPAN_NAME, _device_us, device_times, idle_by_span,
)
from mort_tpu_torch.camera import derive_basis, get_rays_soa  # noqa: E402
from mort_tpu_torch.render import closest_hit as ch  # noqa: E402
from mort_tpu_torch.render import textures as ttx  # noqa: E402
from mort_tpu_torch.render import wavefront as wf  # noqa: E402
from mort_tpu_torch.render.hitshade import finalize_and_shade  # noqa: E402
from mort_tpu_torch.render.integrator import (  # noqa: E402
    lockstep_graph_count,
)
from mort_tpu_torch.render.intersect import (  # noqa: E402
    K_QUAD, K_SPHERE, T_MIN, media_pass, quad_frames,
)
from mort_tpu_torch.render.primtable import build_prim_table  # noqa: E402
from mort_tpu_torch.render.vec import V3  # noqa: E402
from mort_tpu_torch.scene import scenes as sc  # noqa: E402
from mort_tpu_torch.scene.build import World  # noqa: E402
from mort_tpu_torch.scene.types import TEX_NOISE  # noqa: E402

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
# float32 operations of an axis-aligned quad up to its t test in "none"'s
# specialised test: two multiplies, a subtraction, a division
AAQ_OPS = 4
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
R_WINDOW_EDGES = 4096       # rays of each scene5/6 window-edge set
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
# The backward kernels' table gradients are float32 sums in a fixed order
# of pairwise trees, bit-equal to closest_hit_bwd_ordered; against the
# plain version's index_add_ order they are held within BWD_SUM_RTOL of the
# sum of |terms| of each entry (float32 summation of n terms in two orders
# differs by about sqrt(n) * 6e-8 of that sum for random rounding; 2^17
# terms on one entry give ~2e-5).
BWD_SUM_RTOL = 1e-4
BWD_OUTS = ("d_rays", "d_sph", "d_quad", "d_joined")
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
    m = re.search(
        r"closest_hit_(?:none_|cull_[a-z]+_|bvh_|bwd_[a-z]+_)?kernel", mangled)
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


def sass_text(name):
    """``cuobjdump -sass`` of the built library ``name``."""
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()),
                             "cuobjdump")
    return subprocess.run([cuobjdump, "-sass",
                           str(_build.library_path(name))],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout


def float_atomics(name, kernel="closest_hit_bwd_"):
    """{label: float atomic instructions (RED or ATOM on .F32, .F64 or
    .FTZ.RN operands)} of the kernels of ``name`` whose label starts with
    ``kernel``, from their SASS."""
    out = {}
    for block in sass_text(name).split("Function : ")[1:]:
        label = kernel_label(block.split(None, 1)[0])
        if label.startswith(kernel):
            out[label] = len(re.findall(
                r"\b(?:RED|ATOM|ATOMG)\.[A-Z0-9.]*(?:F32|F64|FTZ)", block))
    return out


def sass_mix(name, kernel="closest_hit_none_kernel<false"):
    """{(kernel, part): {opcode class: count}}: the static SASS instruction
    mix of the kernels of ``name`` whose label starts with ``kernel``
    (``cuobjdump -sass`` on the built library), for the whole kernel (part
    "all") and for each innermost loop that does float arithmetic (part
    "loop 0x<first>-0x<last>": the instructions from a backward branch's
    target to the branch, where no other such loop lies inside).
    Instructions predicated off for good (``@!PT``) are not counted."""
    mix = {}
    for block in sass_text(name).split("Function : ")[1:]:
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


# the spans' graph counts (wavefront.graph_count) and the train steps'
# (sharding.step_graph_count) at the last reset_counts
_GRAPH_BASE = dict(wf.graph_count)
_STEP_BASE = dict(sharding.step_graph_count)
# and the lockstep forward's (integrator.lockstep_graph_count)
_LOCK_BASE = dict(lockstep_graph_count)
# the graph counts of each main path, by name, for phases 21, 22 and 23's
# records
GRAPHS = {}
STEP_GRAPHS = {}
LOCK_GRAPHS = {}


def reset_counts():
    torch.cuda.synchronize()
    for mode in ch.launch_count:
        ch.launch_count[mode] = 0
    _GRAPH_BASE.update(wf.graph_count)
    _STEP_BASE.update(sharding.step_graph_count)
    _LOCK_BASE.update(lockstep_graph_count)


def read_counts():
    torch.cuda.synchronize()
    return dict(ch.launch_count)


def read_graphs(name=None):
    """The spans' graph counts since the last ``reset_counts``: spans,
    rounds, captures, replays, host reads and capture seconds; kept in
    GRAPHS under ``name``."""
    moved = {k: wf.graph_count[k] - _GRAPH_BASE[k] for k in _GRAPH_BASE}
    moved["capture_s"] = round(moved["capture_s"], 4)
    if name is not None:
        GRAPHS[name] = moved
    return moved


def read_lockstep(name=None):
    """The lockstep forward's counts since the last ``reset_counts``:
    bounces run, host reads of ``alive.any()``, captures, recaptures,
    replays and capture seconds; kept in LOCK_GRAPHS under ``name``."""
    moved = {k: lockstep_graph_count[k] - _LOCK_BASE[k] for k in _LOCK_BASE}
    moved["capture_s"] = round(moved["capture_s"], 4)
    if name is not None:
        LOCK_GRAPHS[name] = moved
    return moved


def read_step_graphs(name=None):
    """The train steps' graph counts since the last ``reset_counts``:
    steps, captures, recaptures, replays and capture seconds; kept in
    STEP_GRAPHS under ``name``."""
    moved = {k: sharding.step_graph_count[k] - _STEP_BASE[k]
             for k in _STEP_BASE}
    moved["capture_s"] = round(moved["capture_s"], 4)
    if name is not None:
        STEP_GRAPHS[name] = moved
    return moved


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
    """The (sphere, quad, box or node slab, axis-aligned quad) tests one
    launch of ``packed.accel`` performs and "cull"'s pairs (ray, entered
    sub-cluster), from the kernel's optional counter; the counted launch
    must still equal the plain version bit for bit.  In "none" every ray
    tests every surface sphere and every box, every live axis-aligned quad
    by the specialised test (a finite ray) and at most every other surface
    quad (every one when the scene has no closed box); in "cull" every ray
    slab-tests every box and a pair is at most CL tests; the other modes
    take no specialised test and have no pairs."""
    n = torch.zeros(ch.N_TESTS, dtype=torch.int64, device=rays.device)
    got = ch._launch(packed, rays, T_MIN, n)
    torch.cuda.synchronize()
    assert torch.equal(got, want), f"{name}: the counted launch differs"
    n_s, n_q, n_b, n_a, n_p = (int(x) for x in n)
    if packed.accel == "none":
        R = rays.shape[1]
        surf_s, surf_q = surface_counts(packed)
        n_box = packed.aab_tab.shape[0]
        n_aaq = int((packed.aaq_tab[:, 7] == 1.0).sum())
        finite = bool(torch.isfinite(rays[0:6]).all())
        assert n_s == R * surf_s and n_b == R * n_box \
            and n_q + n_a <= R * surf_q \
            and (n_box or n_q + n_a == R * surf_q) \
            and (not finite or n_a == R * n_aaq), \
            f"{name}: counted {(n_s, n_q, n_b, n_a)} tests"
    else:
        assert n_a == 0, f"{name}: {n_a} axis-aligned tests"
    if packed.accel == "cull":
        R = rays.shape[1]
        assert n_b == R * packed.n_accel and n_p <= R * packed.n_accel \
            and n_s + n_q <= n_p * ch.CL, \
            f"{name}: counted {(n_s, n_q, n_b, n_p)} tests and pairs"
    else:
        assert n_p == 0, f"{name}: {n_p} pairs"
    return n_s, n_q, n_b, n_a, n_p


def bound_parts(packed, R, n_tests):
    """(bytes bound, operations bound) of one call in ms: the bytes the
    call must move (the [8, R] rays in, the [32, R] rows out, every table
    once) over HBM bandwidth, and the operations of the (sphere, quad, box
    slab, axis-aligned quad) tests ``n_tests`` over the float32 peak."""
    tabs = [packed.sph, packed.quad, packed.joined]
    for t in (packed.accel_tab, packed.aab_tab, packed.aab_faces,
              packed.gen_rows, packed.aaq_tab, packed.aaq_groups):
        if t is not None:
            tabs.append(t)
    n_bytes = R * (8 + ch.ROW_K) * 4 + sum(t.numel() * 4 for t in tabs)
    n_s, n_q, n_b, n_a = n_tests[:4]
    slab = SLAB_OPS if packed.accel == "none" else NODE_SLAB_OPS
    return (n_bytes / HBM_BYTES_PER_S * 1e3,
            (n_s * SPHERE_OPS + n_q * QUAD_OPS + n_b * slab
             + n_a * AAQ_OPS) / FP32_OPS_PER_S * 1e3)


def brute_force_tests(packed, R):
    """The tests of a scan of every surface primitive (the "none" kernel
    before its box cull), whose bound is printed beside the bound of the
    tests counted."""
    surf_s, surf_q = surface_counts(packed)
    return R * surf_s, R * surf_q, 0, 0, 0


def running_bound_tests(packed, rays):
    """The (sphere, quad, box slab, axis-aligned quad, pairs) tests of
    "cull" with a running bound, the least work the mode needs, which the
    kernels line's bound counts: a ray walks the sub-clusters in order
    (spheres first) and tests the rows of each whose widened box it enters
    before its best t so far (the sphere best, then the smaller of it and
    the quad best), and slab-tests every box.  The kernels test with the
    bound +inf and count more (``count_tests``), beside it.  A
    sub-cluster's best is ``closest_hit_reference`` over its rows alone; a
    box the bound skips holds no hit before the bound (the boxes are
    widened), so the best so far is the running minimum of the entered
    ones.  The slab planes round twice here where the kernel's fma rounds
    once."""
    R = rays.shape[1]
    box, n_ss = packed.accel_tab, packed.n_sph_sub
    o, d = rays[0:3].T, rays[3:6].T
    ir = 1.0 / torch.where(d.abs() < 1e-30,
                           torch.where(d >= 0.0, 1e-30, -1e-30), d)
    m = o.abs().amax(dim=1, keepdim=True)
    m = m * ch.AAB_SLACK + ch.sphere_pad(m, box[0, 6])
    o_lo, o_hi = (o + m) * ir, (o - m) * ir
    bound = torch.full((R,), float("inf"), device=rays.device)
    tests = [0, 0]
    for k in range(packed.n_accel):
        sphere = k < n_ss
        q = k if sphere else k - n_ss
        tab, n_rows = ((packed.sph, packed.n_sph) if sphere
                       else (packed.quad, packed.n_quad))
        rows = tab[q * ch.CL:min((q + 1) * ch.CL, n_rows)]
        if rows.shape[0] == 0:
            continue
        t_lo, t_hi = box[k, 0:3] * ir - o_lo, box[k, 3:6] * ir - o_hi
        near = torch.minimum(t_lo, t_hi).amax(dim=1)
        far = torch.maximum(t_lo, t_hi).amin(dim=1)
        enter = ((box[k, 0] <= box[k, 3]) & (near <= far) & (far > T_MIN)
                 & (near <= bound))
        alone = dataclasses.replace(
            packed, accel="none", accel_tab=None, n_accel=0, n_sph_sub=0,
            sph=rows if sphere else packed.sph[:0],
            n_sph=rows.shape[0] if sphere else 0,
            quad=packed.quad[:0] if sphere else rows,
            n_quad=0 if sphere else rows.shape[0])
        t = ch.closest_hit_reference(alone, rays)[ch.ROW_T]
        tests[0 if sphere else 1] += (int(enter.sum())
                                      * int((rows[:, -1] != 0).sum()))
        bound = torch.minimum(bound, torch.where(enter, t, float("inf")))
    return tests[0], tests[1], R * packed.n_accel, 0, 0


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


def window_edge_rays(data, meta, eye, n, seed, tiny=0.15):
    """[8, n] float32 rays on the CPU aimed at the window edges and corners
    of the axis-aligned surface quads of ``meta.aaq_class`` (alpha or beta
    of the quad test at 0 or 1), each coordinate of the aim point moved by
    -4..4 ulps, from ``eye`` (half) or from a point N(0, 3^2) a coordinate
    around the quad.  A share ``tiny`` of the rays get one direction
    component under 1e-8 (a third of those along the quad's normal: rays
    parallel to its plane)."""
    g = np.random.RandomState(seed)
    rows = np.asarray([r for r, c in enumerate(meta.aaq_class)
                       if 0 <= c <= 8], np.int64)
    Q, u, v = (x.double().cpu().numpy()[rows] for x in (
        data.quad_Q, data.quad_u, data.quad_v))
    b = g.randint(0, len(rows), n)
    ab = g.rand(n, 2)
    edge = g.randint(0, 3, n)        # alpha on an edge, beta, or both
    ab[edge != 1, 0] = g.randint(0, 2, int((edge != 1).sum()))
    ab[edge != 0, 1] = g.randint(0, 2, int((edge != 0).sum()))
    p = (Q[b] + ab[:, :1] * u[b] + ab[:, 1:] * v[b]).astype(np.float32)
    ulps = g.randint(-4, 5, (n, 3))
    toward = np.where(ulps > 0, np.float32(np.inf), np.float32(-np.inf))
    for k in range(4):
        p = np.where(np.abs(ulps) > k, np.nextafter(p, toward), p)
    o = (Q[b] + 0.5 * (u[b] + v[b]) + g.randn(n, 3) * 3).astype(np.float32)
    o[::2] = np.asarray(eye, np.float32)
    d = (p - o).astype(np.float32)
    normal = np.abs(np.cross(u[b], v[b])).argmax(axis=1)
    small = g.rand(n) < tiny
    axis = np.where(g.rand(n) < 1 / 3, normal, g.randint(0, 3, n))
    d[small, axis[small]] = g.randn(int(small.sum())) * 1e-9
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
    quads on their specialised path (the port of the JAX package's
    _aaq_group_best): the kernel timed with every quad, without the
    axis-aligned ones and without any (the rows the kernel scans cut, so
    only these timings, not a result)."""
    p = s7.packed["none"]
    no_aaq = {"aaq_tab": p.aaq_tab[:0], "aaq_groups": p.aaq_groups[:0]}
    cuts = {"all": p, "general": dataclasses.replace(p, **no_aaq),
            "none": dataclasses.replace(p, gen_rows=p.gen_rows[:0],
                                        **no_aaq)}
    ms = {k: time_ms(lambda: ch._launch(q, rays, T_MIN), calls=10)
          for k, q in cuts.items()}
    log(f"quad share scene7 R={rays.shape[1]} ({len(p.gen_rows)} general "
        f"quad rows, {len(p.aaq_tab)} axis-aligned), ten calls back to "
        f"back: none {ms['all']:.4f} ms, without the axis-aligned quads "
        f"{ms['general']:.4f} ms, without quads {ms['none']:.4f} ms: quads "
        f"{1 - ms['none'] / ms['all']:.4f}, axis-aligned quads "
        f"{1 - ms['general'] / ms['all']:.4f} of the time | {card}")


def rows_equal_joined(name, packed, rays):
    """The one-hot gather's counterpart: the rows the kernel emits on its
    hit lanes are the joined table's rows of the winner bit for bit, and a
    miss lane's are row 0.  Returns the hit lanes."""
    out = ch._launch(packed, rays, T_MIN)
    kind = out[ch.ROW_KIND].long()
    idx = out[ch.ROW_IDX].long()
    g = torch.where(kind == K_QUAD, idx + packed.quad_base, idx)
    k_join = packed.joined.shape[1]
    assert torch.equal(out[:k_join], packed.joined[g].T), \
        f"{name}: emitted rows differ from the joined table's"
    hit = kind > 0
    assert bool((g[~hit] == 0).all()), f"{name}: a miss reads another row"
    return int(hit.sum())


def parity_and_timing(dev, card):
    """Phase 4.  Returns {mode: {"err", "ms", "ms_back_to_back",
    "plain_ms", "bound_ms", "bound_by"}} at scene 9's shapes (the bound of
    the tests counted; for "cull" of the running bound's,
    ``running_bound_tests``), and the ray sets {name: (scene, rays, plain
    output)}."""
    world1, cam1 = sc.random_spheres()
    world9, cam9 = sc.final_scene(400, 250, 4)
    world16, cam16 = sc.spread_spheres()
    world7, cam7 = sc.build_scene(7)
    world5, cam5 = sc.build_scene(5)
    world6, cam6 = sc.build_scene(6)
    s1, s9, s16 = Scene(world1, dev), Scene(world9, dev), Scene(world16, dev)
    s7, s5, s6 = Scene(world7, dev), Scene(world5, dev), Scene(world6, dev)
    assert ch.auto_accel(s16.meta.n_spheres) == "bvh"
    stack = ch.stack_rays
    sets = {
        "scene1": (s1, stack(*camera_bounce_rays(s1, cam1, R_PARITY // 2,
                                                 dev))),
        "scene9": (s9, stack(*camera_bounce_rays(s9, cam9, R_SCENE9 // 2,
                                                 dev))),
        "scene7": (s7, stack(*camera_bounce_rays(s7, cam7, R_PARITY // 2,
                                                 dev))),
        "scene5": (s5, stack(*camera_bounce_rays(s5, cam5, R_PARITY // 2,
                                                 dev))),
        "scene5_edges": (s5, window_edge_rays(s5.data, s5.meta,
                                              cam5.lookfrom, R_WINDOW_EDGES,
                                              15).to(dev)),
        "scene6_edges": (s6, window_edge_rays(s6.data, s6.meta,
                                              cam6.lookfrom, R_WINDOW_EDGES,
                                              16).to(dev)),
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
    times, b2b, tests, need, out_sets = {}, {}, {}, {}, {}
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
        need[name] = running_bound_tests(scene.packed["cull"], rays)
        parts = []
        for m in ch.ACCELS:
            t_bytes, t_ops = bound_parts(scene.packed[m], R, tests[name][m])
            n_s, n_q, n_b, n_a, n_p = tests[name][m]
            least = ""
            if m == "cull":
                rb_s, rb_q = need[name][:2]
                least = (f"; the running bound's {rb_s / R:.2f} sphere + "
                         f"{rb_q / R:.2f} quad + {n_b / R:.1f} box slab "
                         f"tests a ray: operations bound "
                         f"{bound_parts(scene.packed[m], R, need[name])[1]:.4f}"
                         f" ms")
            parts.append(f"{m} {row[m]:.4f} ms, back to back "
                         f"{b2b[name][m]:.4f} ms (operations bound "
                         f"{t_ops:.4f} ms for {n_s / R:.2f} sphere + "
                         f"{n_q / R:.2f} quad + {n_a / R:.2f} axis-aligned "
                         f"quad + {n_b / R:.1f} "
                         f"{'node' if m == 'bvh' else 'box'} slab tests a "
                         f"ray{f', {n_p / R:.2f} pairs a ray' if n_p else ''}"
                         f", bytes bound {t_bytes:.4f} ms{least})")
        brute = bound_parts(scene.packed["none"], R,
                            brute_force_tests(scene.packed["none"], R))[1]
        log(f"timing {name} R={R}: " + ", ".join(parts)
            + f", plain {plain:.4f} ms; none brute-force operations bound "
            f"{brute:.4f} ms | {card}")
    log("four-way back to back (ms; " + " / ".join(ch.ACCELS) + "): "
        + ", ".join(f"{name} " + " / ".join(f"{b2b[name][m]:.4f}"
                                             for m in ch.ACCELS)
                    for name in ("scene1", "scene7", "scene9", "spread16k"))
        + f" | {card}")
    for name in ("scene9", "spread16k", "scene7"):
        scene, rays = sets[name]
        split = device_split(
            lambda: ch._launch(scene.packed["cull"], rays, T_MIN),
            "closest_hit_cull_")
        log(f"cull kernels {name} R={rays.shape[1]}, device us a call: "
            + ", ".join(f"{k.removeprefix('closest_hit_cull_')} {v:.2f}"
                        for k, v in split.items())
            + f"; sum {sum(split.values()):.2f} | {card}")
    quad_share(s7, sets["scene7"][1], card)
    # scene 9's lamp, its one quad outside the boxes, is axis-aligned
    assert tests["scene9"]["none"][3] == sets["scene9"][1].shape[1]
    hits = {name: rows_equal_joined(name, sets[name][0].packed["none"],
                                    sets[name][1])
            for name in ("scene9", "scene5", "scene6_edges")}
    out = {}
    for mode in ch.ACCELS:
        # "cull"'s bound: the work its function needs (the running bound's
        # tests), not the more its kernels do
        b, by = bound_ms(s9.packed[mode], R_SCENE9,
                         need["scene9"] if mode == "cull"
                         else tests["scene9"][mode])
        out[mode] = {"err": err[mode], "ms": times["scene9"][mode],
                     "ms_back_to_back": b2b["scene9"][mode],
                     "plain_ms": times["scene9"]["plain"], "bound_ms": b,
                     "bound_by": by}
    R5 = sets["scene5"][1].shape[1]
    b, by = bound_ms(s5.packed["none"], R5, tests["scene5"]["none"])
    out["aaq"] = {"err": err["none"], "ms": times["scene5"]["none"],
                  "ms_back_to_back": b2b["scene5"]["none"],
                  "plain_ms": times["scene5"]["plain"], "bound_ms": b,
                  "bound_by": by, "R": R5,
                  "tests": tests["scene5"]["none"]}
    out["rows_hits"] = hits
    for name in ("scene7", "scene9_edges", "scene1_silhouettes",
                 "spread16k_silhouettes", "scene5", "scene5_edges",
                 "scene6_edges"):
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


def exact_sums(args):
    """d_sph, d_quad and d_joined in float64: the float32 terms of every
    lane (the plain version's, which the kernels' equal) summed in float64,
    the yardstick of a float32 sum's own rounding."""
    rays, kind, idx, dt, drow, sph, quad, shape, quad_base, t_min = args
    _d, (s, js, ts), (q, jq, tq) = ch._bwd_lane_terms(
        rays, kind, idx, dt, drow, sph, quad, t_min)
    f64 = dict(dtype=torch.float64, device=rays.device)
    d_sph = torch.zeros(sph.shape, **f64)
    d_quad = torch.zeros(quad.shape, **f64)
    d_joined = torch.zeros(shape, **f64)
    d_sph[:, :ch.REC_TERMS] = torch.zeros_like(
        d_sph[:, :ch.REC_TERMS]).index_add_(0, js, ts.double())
    d_quad[:, :4] = torch.zeros_like(d_quad[:, :4]).index_add_(
        0, jq, tq.double())
    lanes = (kind != 0).nonzero().squeeze(1)
    key = torch.where(kind == K_QUAD, idx + quad_base, idx)[lanes].long()
    d_joined.index_add_(0, key, drow[:shape[1], lanes].T.double())
    return d_sph, d_quad, d_joined


def compare_bwd(name, args, plain=True):
    """The backward kernels against their plain versions on the same card
    tensors: three launches bit-identical; d_rays and the three tables
    bit-equal to ``closest_hit_bwd_ordered``, the plain mirror of their
    order of adds; d_rays bit-equal to ``closest_hit_bwd_reference`` (the
    same ops a lane); the tables within BWD_SUM_RTOL of each entry's sum of
    |terms| of the same terms summed in float64 (``exact_sums``) and, with
    ``plain``, of the plain version's float32 index_add_ order.  Returns
    (largest |difference| from the plain version, that / sum of |terms|,
    the kernels' and the plain version's largest |difference| from the
    float64 sums / sum of |terms|)."""
    runs = [ch._launch_bwd(*args) for _ in range(3)]
    ordered = ch.closest_hit_bwd_ordered(*args)
    want = ch.closest_hit_bwd_reference(*args)
    scale = ch.closest_hit_bwd_reference(*args, absolute=True)
    exact = exact_sums(args)
    torch.cuda.synchronize()
    got = runs[0]
    for n, again in enumerate(runs[1:], 2):
        for what, g, a in zip(BWD_OUTS, got, again):
            assert torch.equal(g, a), \
                f"{name}: launch {n}'s {what} differs from launch 1's"
    for what, g, o in zip(BWD_OUTS, got, ordered):
        assert torch.equal(g, o), (
            f"{name}: {what} differs from closest_hit_bwd_ordered at "
            f"{int((g != o).sum())} entries")
    assert torch.equal(got[0], want[0]), f"{name}: d_rays differ"
    err, rel, rel_exact, rel_plain = 0.0, 0.0, 0.0, 0.0
    for what, g, w, s, x in zip(BWD_OUTS[1:], got[1:], want[1:], scale[1:],
                                exact):
        if not g.numel():
            continue
        s = s.clamp_min(1e-30)
        diff = (g - w).abs()
        err = max(err, float(diff.max()))
        rel = max(rel, float((diff / s).max()))
        off = (g.double() - x).abs() / s
        rel_exact = max(rel_exact, float(off.max()))
        rel_plain = max(rel_plain, float(((w.double() - x).abs() / s).max()))
        bad = int((off > BWD_SUM_RTOL).sum())
        assert bad == 0, (f"{name}: {what} differs from the float64 sums "
                          f"beyond {BWD_SUM_RTOL} of the sum of |terms| at "
                          f"{bad} entries")
        bad = int((diff > BWD_SUM_RTOL * s).sum()) if plain else 0
        assert bad == 0, (f"{name}: {what} differs beyond {BWD_SUM_RTOL} of "
                          f"the sum of |terms| at {bad} entries (largest "
                          f"ratio {rel:.3e})")
    return err, rel, rel_exact, rel_plain


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


def bwd_runs(args):
    """(runs, bytes): the (tile, key) pairs of the hit lanes, each a run of
    REC_TERMS + k_join sums the tile kernel writes and the reduce kernel
    reads back, with its key and slot: the kernels' traffic beyond the
    bound, not part of it."""
    _rays, kind, idx, *_rest = args
    n_join, k_join = args[7]
    lanes = ((kind == K_SPHERE) | (kind == K_QUAD)).nonzero().squeeze(1)
    key = torch.where(kind == K_QUAD, idx + args[8], idx)[lanes].long()
    runs = int(torch.unique(lanes // ch.BWD_TILE * n_join + key).numel())
    return runs, runs * 4 * (2 * (ch.REC_TERMS + k_join) + 3)


def device_split(fn, prefix, calls=20):
    """{kernel: device us a call} of ``calls`` calls of ``fn`` under
    torch.profiler, after three unprofiled ones: kernels named from
    ``prefix`` on (``closest_hit_bwd_``: the backward's), others by their
    name's first 40 characters."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {(re.search(prefix + r"\w+", e.key) or e).group(0)
            if prefix in e.key else e.key[:40]:
            _device_us(e) / calls for e in device_times(prof)[0]}


def capture_step_bounce(dev):
    """The backward's operands in one bounce of a real train step (scene 1
    at bench.py --grad's config, seed GRAD_SEEDS[0]), captured from
    ``_ClosestHit.backward``: of the step's 32 calls, the one with the most
    hit lanes."""
    world, cam = sc.random_spheres()
    data, meta = world.compile()
    cam = cam.replace(image_width=GRAD_W, image_height=GRAD_H, sqrt_spp=2,
                      bounce_limit=8)
    target = np.zeros((GRAD_H, GRAD_W, 3), np.float32)
    best = {"hits": -1}
    launch = ch._launch_bwd

    def capture(*args):
        hits = int((args[1] > 0).sum())
        if hits > best["hits"]:
            best.update(hits=hits, args=tuple(
                a.clone() if torch.is_tensor(a) else a for a in args))
        return launch(*args)

    ch._launch_bwd = capture
    try:
        # eager: the hook reads the host, which a capture refuses
        float(make_train_step(meta, _eager=True)(data, cam, target,
                                                 GRAD_SEEDS[0])[0])
    finally:
        ch._launch_bwd = launch
    return best["args"]


def backward_parity_and_timing(dev, card, sets):
    """Phase 9.  Returns the closest_hit_bwd record at the train step's
    shapes (scene 1, R = 202,800, random cotangents)."""
    err = 0.0
    for k, (name, (scene, rays, fwd)) in enumerate(sets.items()):
        args = bwd_args(scene, rays, fwd, *random_cotangents(
            rays.shape[1], dev, 10 + k))
        e, rel, r64, p64 = compare_bwd(f"{name}/bwd", args)
        err = max(err, e)
        log(f"bwd parity {name}: R={rays.shape[1]} "
            f"hits={int((args[1] > 0).sum())} three launches bit-identical, "
            f"d_rays and tables bit-equal to the ordered mirror; table sums "
            f"against the plain version max |diff| {e:.3e}, max |diff| / "
            f"sum|terms| {rel:.3e} (limit {BWD_SUM_RTOL}); from the float64 "
            f"sums: kernels {r64:.3e}, plain {p64:.3e}")
    # the train step's first bounce: every pixel's camera ray, sample 0
    world1, cam = sc.random_spheres()
    s1 = sets["scene1"][0] if "scene1" in sets else Scene(world1, dev)
    cam = cam.replace(image_width=GRAD_W, image_height=GRAD_H, sqrt_spp=2,
                      bounce_limit=8).to(dev)
    R = GRAD_W * GRAD_H
    pix = torch.arange(R, device=dev)
    ro, rd, tme = get_rays_soa(cam, derive_basis(cam), SEED, pix,
                               torch.zeros_like(pix))
    rays = ch.stack_rays(ro, rd, tme)
    fwd = ch._launch(s1.packed["none"], rays, T_MIN)
    args = bwd_args(s1, rays, fwd, *random_cotangents(R, dev, 9))
    e, rel, r64, p64 = compare_bwd("scene1 grad/bwd", args)
    err = max(err, e)
    log(f"bwd parity scene1 grad: max |diff| / sum|terms| {rel:.3e} from "
        f"the plain version; from the float64 sums: kernels {r64:.3e}, "
        f"plain {p64:.3e}")
    ms = time_ms(lambda: ch._launch_bwd(*args))
    ms_b2b = time_ms(lambda: ch._launch_bwd(*args), calls=10)
    plain = time_ms(lambda: ch.closest_hit_bwd_reference(*args), reps=5,
                    warmup=1)
    ordered = time_ms(lambda: ch.closest_hit_bwd_ordered(*args), reps=3,
                      warmup=1)
    b, by = bwd_bound_ms(args)
    runs, run_bytes = bwd_runs(args)
    log(f"bwd kernels scene1 grad, device us a call under torch.profiler: "
        + ", ".join(f"{k} {v:.2f}" for k, v in device_split(lambda: ch._launch_bwd(*args),
                                 "closest_hit_bwd_").items()))
    hits = int((args[1] > 0).sum())
    ground = int((args[2][args[1] == K_SPHERE] == int(torch.argmax(
        s1.data.sph_radius))).sum())
    log(f"bwd timing scene1 grad R={R} ({hits} hits, {ground} on the ground "
        f"sphere), random cotangents: kernels {ms:.4f} ms, back to back "
        f"{ms_b2b:.4f} ms, plain {plain:.4f} ms, ordered mirror "
        f"{ordered:.4f} ms, bound {b:.4f} ms by {by}; {runs} runs, "
        f"{run_bytes / 1e6:.3f} MB of run traffic beside the bound | {card}")
    # a bounce of a real step: its cotangents are zero on ended paths
    step = capture_step_bounce(dev)
    # a real bounce's cotangents share a sign over many lanes of a key, and
    # the plain version's one float32 accumulator rounds them with a bias
    # that the pairwise trees do not have (PERF.md): both are held to
    # the float64 sums here, only the kernels within BWD_SUM_RTOL
    e, rel, r64, p64 = compare_bwd("scene1 step bounce/bwd", step,
                                   plain=False)
    ms_step = time_ms(lambda: ch._launch_bwd(*step), calls=10)
    b_step, by_step = bwd_bound_ms(step)
    runs_step, bytes_step = bwd_runs(step)
    live = int(((step[3] != 0) | (step[4] != 0).any(dim=0))[
        step[1] > 0].sum())
    log(f"bwd timing scene1 step bounce R={step[0].shape[1]} "
        f"({int((step[1] > 0).sum())} hits, {live} with a nonzero "
        f"cotangent): back to back {ms_step:.4f} ms, bound {b_step:.4f} ms "
        f"by {by_step}; {runs_step} runs, {bytes_step / 1e6:.3f} MB of run "
        f"traffic; three launches bit-identical and bit-equal to the "
        f"ordered mirror; max |diff| / sum|terms| from the float64 sums: "
        f"kernels {r64:.3e}, plain {p64:.3e}; kernels from the plain version "
        f"{rel:.3e} | {card}")
    return {"err": err, "ms": ms, "ms_back_to_back": ms_b2b,
            "plain_ms": plain, "bound_ms": b, "bound_by": by,
            "bit_equal_ordered": True, "deterministic": True}


def step_grads_ok(loss, grads, need=()):
    assert bool(torch.isfinite(loss)), f"loss {float(loss)}"
    for k, g in grads.items():
        assert bool(torch.isfinite(g).all()), f"non-finite grad {k}"
    for k in need:
        assert bool((grads[k] != 0).any()), f"zero grad {k}"


def train_step_main_path(dev, card):
    """Phase 10: the scene-1 train step at bench.py --grad's config;
    returns the launch counts and the median step wall."""
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
    graphs = read_step_graphs("train step scene1")
    peak = torch.cuda.max_memory_allocated()
    step_grads_ok(loss, grads, ("sph_center", "mat_albedo", "tex_color"))
    assert counts["none"] == steps_per_run * per_step, counts
    assert counts["bwd"] == steps_per_run * per_step, counts
    # one capture (the first call), a replay for every later step
    assert graphs["captures"] == 1 and graphs["recaptures"] == 0, graphs
    assert graphs["replays"] == steps_per_run - 1, graphs
    wall = statistics.median(walls)
    log(f"main path train step scene1 {GRAD_W}x{GRAD_H} @ "
        f"{cam.sqrt_spp ** 2}spp depth {cam.bounce_limit}: median wall "
        f"{wall:.3f} s ({', '.join(f'{w:.3f}' for w in walls)}), "
        f"{n_paths / wall:.1f} grad paths/s, loss {float(loss):.6f}, "
        f"launches per step none {counts['none'] // steps_per_run} bwd "
        f"{counts['bwd'] // steps_per_run} ({steps_per_run} steps), peak "
        f"memory {peak / 2 ** 30:.3f} GiB, step graphs {graphs} | {card}")
    return counts, wall


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
    lock = read_lockstep("lockstep scene1 200x112 16spp")
    assert counts["none"] > 0, "the lockstep render launched no kernel"
    assert lock["replays"] > 0 and counts["none"] == lock["bounces"], lock
    b = render(data, meta, cam, seed=SEED, use_kernel=False)
    c = render_wavefront(data, meta, cam, dev, seed=SEED)
    a, b, c = (x.cpu().numpy() for x in (a, b, c))
    assert np.isfinite(a).all(), "non-finite pixels"
    fp, mp = assert_images_close(a, b)
    fw, mw = assert_images_close(a, c)
    log(f"lockstep render scene1 200x112 @ 16spp depth 20: kernel "
        f"({counts['none']} launches, lockstep graphs {lock}) vs plain "
        f"frac_within={fp:.5f}, mean_abs={mp:.3e}; vs render_wavefront "
        f"frac_within={fw:.5f}, mean_abs={mw:.3e}")


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


def read_png(path):
    """[H, W, 3] uint8 of an 8-bit RGB PNG, decoded with zlib (the card's
    machine has no PIL): the chunks, the IDAT stream and the five row
    filters."""
    with open(path, "rb") as f:
        buf = f.read()
    assert buf[:8] == b"\x89PNG\r\n\x1a\n", f"{path}: not a PNG"
    pos, idat, w, h = 8, b"", None, None
    while pos < len(buf):
        n, tag = struct.unpack(">I4s", buf[pos:pos + 8])
        body = buf[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h, depth, color = struct.unpack(">IIBB", body[:10])
            assert (depth, color) == (8, 2), f"{path}: not 8-bit RGB"
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, 1 + 3 * w)
    img = np.zeros((h, 3 * w), np.int64)
    for y in range(h):
        f, x = raw[y, 0], raw[y, 1:].astype(np.int64)
        up = img[y - 1] if y else np.zeros(3 * w, np.int64)
        if f in (0, 2):
            img[y] = (x + (up if f == 2 else 0)) % 256
            continue
        for i in range(3 * w):
            left = img[y, i - 3] if i >= 3 else 0
            ul = up[i - 3] if i >= 3 else 0
            if f == 1:
                pred = left
            elif f == 3:
                pred = (left + up[i]) // 2
            else:
                pa, pb = abs(up[i] - ul), abs(left - ul)
                pc = abs(left + up[i] - 2 * ul)
                pred = (left if pa <= pb and pa <= pc
                        else up[i] if pb <= pc else ul)
            img[y, i] = (x[i] + pred) % 256
    return img.astype(np.uint8).reshape(h, w, 3)


def render_pair(data, meta, cam, dev):
    """The kernel's and the plain closest hit's image of one config, and
    the kernel launches per mode of the first."""
    reset_counts()
    a = render_wavefront(data, meta, cam, dev, seed=SEED)
    counts = read_counts()
    b = render_wavefront(data, meta, cam, dev, seed=SEED, use_kernel=False)
    assert bool(torch.isfinite(a).all()), "non-finite pixels"
    return a.cpu().numpy(), b.cpu().numpy(), counts


def main_path(name, world, cam, dev, card, accel=None, profiled=False,
              profile_tasks=None):
    """Drive ``render_wavefront`` once at ``cam``'s config (``accel``: the
    closest-hit mode, None for the auto policy); returns the launch counts
    per mode, the image, the wall seconds and the span graph counts.
    ``profiled``: then render
    the same frame, or the task range ``profile_tasks`` (a window, timed
    once unprofiled, whose profile is summarised in a fraction of a whole
    frame's time), once more under ``torch.profiler`` and print the
    closest-hit kernels' share of device time and the device's idle share
    of the unprofiled wall."""
    data, meta = world.compile()
    spp = cam.sqrt_spp ** 2
    n_paths = cam.image_width * cam.image_height * spp
    reset_counts()
    t0 = time.perf_counter()
    img, stats = render_wavefront(data, meta, cam, dev, seed=SEED,
                                  return_stats=True, accel=accel)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    graphs = read_graphs(name)
    assert sum(counts.values()) > 0, f"{name}: the kernel never launched"
    # one capture a key: the key's first round runs eagerly, every later
    # round (of every span) replays; a kept key captures nothing
    assert graphs["captures"] <= 1 and graphs["replays"] == \
        stats["iterations"] - graphs["captures"], \
        f"{name}: a round after the key's first was not a replay: {graphs}"
    assert img.shape == (cam.image_height, cam.image_width, 3)
    assert bool(torch.isfinite(img).all()), "non-finite pixels"
    mean = float(img.mean())
    assert 0.01 < mean < 2.0, f"implausible image mean {mean}"
    segs = stats["useful_segments"]
    log(f"main path {name} {cam.image_width}x{cam.image_height} @ {spp}spp "
        f"depth {cam.bounce_limit}: wall {wall:.3f} s, "
        f"{n_paths / wall:.1f} paths/s, {segs / wall:.1f} segments/s, "
        f"occupancy {segs / stats['slots_executed']:.4f}, "
        f"{stats['iterations']} rounds, kernel launches {counts}, span "
        f"graphs {graphs}, image mean {mean:.5f} | {card}")
    if profiled:
        kw, what, p_wall = {}, "frame", wall
        if profile_tasks is not None:
            kw = {"task_range": profile_tasks}
            what = f"tasks [{profile_tasks[0]}, {profile_tasks[1]})"
            t0 = time.perf_counter()
            render_wavefront(data, meta, cam, dev, seed=SEED, accel=accel,
                             **kw)
            torch.cuda.synchronize()
            p_wall = time.perf_counter() - t0
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            render_wavefront(data, meta, cam, dev, seed=SEED, accel=accel,
                             **kw)
            torch.cuda.synchronize()
        _, busy_us, n_launch, modes = device_times(prof)
        assert busy_us > 0, f"{name}: the profiler saw no device time"
        if profile_tasks is None:
            # device_times's one pass over the raw events against the
            # profiler's own table, on this frame's few ten thousand
            # kernels (the table takes ~0.1 ms an event)
            busy_k, n_k = key_average_times(prof)
            assert n_k == n_launch and abs(busy_k - busy_us) <= 1e-6 * \
                busy_us, (busy_k, n_k, busy_us, n_launch)
            log(f"main path {name}: device_times {busy_us:.1f} us over "
                f"{n_launch} kernels, key_averages {busy_k:.1f} us over "
                f"{n_k}")
        log(f"main path {name} profiled ({what}): device busy "
            f"{busy_us / 1e6:.4f} s (idle share "
            f"{1 - busy_us / 1e6 / p_wall:.4f} of the unprofiled wall "
            f"{p_wall:.3f} s), {n_launch} device kernels; closest-hit share "
            f"of device time " + ", ".join(
                f"{m} {us / busy_us:.4f} ({us / 1e3:.3f} ms)"
                for m, us in modes.items() if us)
            + f" | {card}")
    return counts, img, wall, graphs


def key_average_times(prof):
    """(busy us, launches) of a profiled window by ``key_averages()``."""
    rows = [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]
    return sum(_device_us(e) for e in rows), sum(e.count for e in rows)


def out_dir():
    """A directory for the files the phases below write, under the
    checkout's git-ignored build/."""
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                     "chip_smoke")
    os.makedirs(d, exist_ok=True)
    return d


def cli_main_path(dev, card, aaq):
    """The CLI main path: ``cli render 5`` at scene 5's code-true config
    (400x400, 100 spp, depth 50, auto accel "none") in-process, launch
    counts reset just before and read just after; then the same command as
    ``python -m mort_tpu_torch.cli`` in a subprocess (exit 0), both files
    read back, the NPZ held against an in-process ``render_wavefront`` of
    the same seed by the image rule; then ``cli bench 5 --frames 2``.
    Returns the launches of the in-process render."""
    from mort_tpu_torch import cli

    d = out_dir()
    png, npz = os.path.join(d, "scene5.png"), os.path.join(d, "scene5.npz")
    for f in (png, npz):
        if os.path.exists(f):
            os.unlink(f)
    world, cam = sc.build_scene(5)       # 400x400, 100 spp, depth 50
    W, H = cam.image_width, cam.image_height
    reset_counts()
    rec = cli.main(["render", "5", "--out", png])
    counts = read_counts()
    graphs = read_graphs("cli render 5")
    assert graphs["replays"] > 0, f"cli render: no graph replay {graphs}"
    assert counts["none"] > 0, "cli render: the none kernel never launched"
    assert (rec["width"], rec["height"], rec["spp"], rec["bounce_limit"]) \
        == (W, H, cam.sqrt_spp ** 2, cam.bounce_limit), rec
    u8 = read_png(png)
    assert u8.shape == (H, W, 3) and u8.max() > 0, u8.shape
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "mort_tpu_torch.cli", "render", "5", "--out",
         npz], cwd=os.path.dirname(os.path.abspath(__file__)),
        capture_output=True, text=True, timeout=600)
    sub_s = time.perf_counter() - t0
    assert res.returncode == 0, f"cli subprocess: {res.returncode}\n" \
        f"{res.stdout}{res.stderr}"
    img = np.load(npz)["image"]
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    data, meta = world.compile()
    want = render_wavefront(data, meta, cam, dev, seed=SEED).cpu().numpy()
    frac, mdiff = assert_images_close(img, want)
    R, (n_s, n_q, n_b, n_a, _) = aaq["R"], aaq["tests"]
    log(f"main path cli render 5 {W}x{H} @ {rec['spp']}spp depth "
        f"{rec['bounce_limit']} (in-process): "
        f"wall {rec['wall_s']:.3f} s, {rec['paths_per_s']:.1f} paths/s, "
        f"{rec['ray_segments_per_s']:.1f} segments/s, none launches "
        f"{counts['none']}, span graphs {graphs}; on phase 4's scene5 rays "
        f"{n_a / R:.2f} axis-aligned and {n_q / R:.2f} general quad tests a "
        f"ray; PNG "
        f"read back {u8.shape}, mean {u8.mean():.2f} | {card}")
    log(f"cli subprocess: rc 0 in {sub_s:.2f} s; "
        + " | ".join(res.stderr.strip().splitlines()) + f"; NPZ vs "
        f"in-process render_wavefront frac_within={frac:.5f}, "
        f"mean_abs={mdiff:.3e}")
    bench = cli.main(["bench", "5", "--frames", "2"])
    log(f"cli bench 5: {json.dumps(bench)} | {card}")
    return counts


PROG_SQRT_SPP, PROG_SPT = 6, 12     # scene 6 cut to 36 spp: three layers


def progressive_main_path(dev, card):
    """The progressive wavefront on scene 6 (cornell_box) at its own
    600x600 and depth 50, spp cut to 36, spt 12: once uninterrupted
    (launch counts reset just before and read just after), then
    interrupted after two steps with a checkpoint and resumed from
    ``load_state`` in a fresh call: the two framebuffers are equal bit for
    bit.  Returns the launches of the uninterrupted run."""
    from mort_tpu_torch.render.progressive import (
        load_state, render_progressive_wavefront,
    )

    world, cam = sc.build_scene(6)
    data, meta = world.compile()
    own_spp = cam.sqrt_spp ** 2
    cam = cam.replace(sqrt_spp=PROG_SQRT_SPP)
    spp = PROG_SQRT_SPP ** 2
    n_layers = spp // PROG_SPT
    steps = []
    reset_counts()
    t0 = time.perf_counter()
    full = render_progressive_wavefront(
        data, meta, cam, seed=SEED, spt=PROG_SPT,
        on_step=lambda st: steps.append(time.perf_counter()))
    wall = time.perf_counter() - t0
    counts = read_counts()
    graphs = read_graphs("progressive scene6")
    assert counts["none"] > 0, "progressive: the none kernel never launched"
    # one capture a key over every layer (a span each)
    assert graphs["captures"] == 1 < graphs["spans"] and \
        graphs["replays"] == graphs["rounds"] - 1, f"progressive: {graphs}"
    assert full.samples_done == spp and len(steps) == n_layers
    assert np.isfinite(full.fb).all() and 0.01 < float(full.fb.mean()) < 2

    class Interrupted(BaseException):
        pass

    def stop_after_two(state):
        if state.samples_done >= 2 * PROG_SPT:
            raise Interrupted

    ckpt = os.path.join(out_dir(), "scene6_progressive.npz")
    try:
        render_progressive_wavefront(data, meta, cam, seed=SEED,
                                     spt=PROG_SPT, checkpoint_path=ckpt,
                                     on_step=stop_after_two)
        raise AssertionError("progressive: the interruption did not happen")
    except Interrupted:
        pass
    state = load_state(ckpt)
    assert state.samples_done == 2 * PROG_SPT, state.samples_done
    reset_counts()
    resumed = render_progressive_wavefront(data, meta, cam, seed=SEED,
                                           spt=PROG_SPT, state=state)
    resumed_graphs = read_graphs()
    assert resumed_graphs["captures"] == 0, resumed_graphs
    assert np.array_equal(resumed.fb, full.fb), \
        "progressive: the resumed render differs from the uninterrupted one"
    per_layer = np.diff([t0] + steps)
    n_paths = cam.image_width * cam.image_height * spp
    log(f"main path progressive scene6 {cam.image_width}x{cam.image_height} "
        f"@ {spp}spp (cut from {own_spp}) depth {cam.bounce_limit}, spt "
        f"{PROG_SPT}: {wall:.3f} s, s a layer "
        f"{', '.join(f'{x:.3f}' for x in per_layer)}, "
        f"{n_paths / wall:.1f} paths/s, none launches {counts['none']}, "
        f"span graphs {graphs}; interrupted after 2 layers, resumed from "
        f"the checkpoint: bit-equal, span captures of the resumed call "
        f"{resumed_graphs['captures']} | {card}")
    return counts


def viewer_path(dev):
    """``view`` on scene 6 at 64x64, 4 spp: a frame, a key, a drag, a
    frame, a key, a frame, each frame saved as PNG and read back."""
    from mort_tpu_torch.interactive import view

    world, cam = sc.build_scene(6)
    data, meta = world.compile()
    cam = cam.replace(image_width=64, image_height=64, sqrt_spp=2)
    pattern = os.path.join(out_dir(), "view{}.png")
    for k in (1, 2, 3):
        if os.path.exists(pattern.format(k)):
            os.unlink(pattern.format(k))
    buf = io.StringIO()
    reset_counts()
    frame = view(data, meta, cam, [("frame",), ("key", "w"),
                                   ("mouse", 30.0, -10.0), ("frame",),
                                   ("key", "d"), ("frame",)], seed=SEED,
                 out_pattern=pattern, log=buf)
    counts = read_counts()
    assert counts["none"] > 0 and np.isfinite(frame).all()
    means = [float(read_png(pattern.format(k)).mean()) for k in (1, 2, 3)]
    assert buf.getvalue().count("Avg. time per frame:") == 3
    log(f"viewer scene6 64x64 @ 4spp: 3 frames written and read back (u8 "
        f"means {', '.join(f'{m:.2f}' for m in means)}), none launches "
        f"{counts['none']}; {buf.getvalue().strip().splitlines()[-1]}")


# Phase 17's configs.  Scene 1 cut to 300x169, 16 spp (depth 20, its own)
# and the train step to 300x169 (4 spp, depth 8) for two ranks sharing the
# one card; spread16k at phase 8's 160x90, 4 spp, depth 4 (its "bvh" path);
# scene 6 at 200x200, 9 spp, spt 3 (three layers), depth 50 (its own).
SHARD_W, SHARD_H, SHARD_SQRT_SPP = 300, 169, 4
SHARD_PROG_W, SHARD_PROG_SQRT_SPP, SHARD_PROG_SPT = 200, 3, 3
SHARD_WORLD = 2
WORKER_TIMEOUT_S = 420      # a worker's own limit: start, build, run, write
BVH_SIZES = (1, 2, 3, 7, 64, 499)


class _Interrupted(BaseException):
    pass


def shard_configs():
    """The scenes and cameras of phase 17 (b), the same on every rank."""
    w1, c1 = sc.random_spheres()
    d1, m1 = w1.compile()
    w16, c16 = sc.spread_spheres()
    d16, m16 = w16.compile()
    w6, c6 = sc.build_scene(6)
    d6, m6 = w6.compile()
    return {
        "scene1": (d1, m1, c1.replace(image_width=SHARD_W,
                                      image_height=SHARD_H,
                                      sqrt_spp=SHARD_SQRT_SPP)),
        "spread16k": (d16, m16, c16.replace(image_width=160, image_height=90,
                                            sqrt_spp=2, bounce_limit=4)),
        "grad": (d1, m1, c1.replace(image_width=SHARD_W,
                                    image_height=SHARD_H, sqrt_spp=2,
                                    bounce_limit=8)),
        "scene6": (d6, m6, c6.replace(image_width=SHARD_PROG_W,
                                      image_height=SHARD_PROG_W,
                                      sqrt_spp=SHARD_PROG_SQRT_SPP)),
    }


def sharded_runs(mesh, ckpt, resume):
    """Every sharded entry point on ``mesh`` at phase 17 (b)'s configs, the
    launch counts of each reset just before and read just after; returns
    numpy results.  ``resume`` False interrupts the progressive scene-6
    render after its first step, checkpointing to ``ckpt`` (rank 0 writes);
    True renders it uninterrupted and resumes it from ``ckpt``."""
    from mort_tpu_torch.render.progressive import (
        load_state, render_progressive_wavefront,
    )

    cfg = shard_configs()
    out = {}
    span_core = wf._span_core
    for name, mode in (("scene1", "none"), ("spread16k", "bvh")):
        data, meta, cam = cfg[name]
        rounds, slot = [], {}

        def recorded_span(*a, **kw):
            # this rank's rounds a span, and the slots a round
            res = span_core(*a, **kw)
            rounds.append(res[0])
            slot["size"] = kw["window"] * kw["pool"]
            return res
        wf._span_core = recorded_span
        reset_counts()
        t0 = time.perf_counter()
        try:
            img, stats = render_wavefront(data, meta, cam, seed=SEED,
                                          mesh=mesh, return_stats=True)
        finally:
            wf._span_core = span_core
        out[f"wf_{name}_s"] = time.perf_counter() - t0
        out[f"wf_{name}_rounds"] = np.asarray(rounds)
        out[f"wf_{name}_slot_size"] = slot["size"]
        for k in ("iterations", "slots_executed"):
            out[f"wf_{name}_{k}"] = stats[k]
        out[f"wf_{name}"] = img.cpu().numpy()
        out[f"wf_{name}_launches"] = read_counts()[mode]
        out[f"wf_{name}_captures"] = read_graphs()["captures"]
        out[f"wf_{name}_useful"] = np.asarray(stats["per_shard_useful"])
        out[f"wf_{name}_collectives"] = sum(stats["collectives"].values())
        out[f"wf_{name}_span_collectives"] = stats["collectives"]["spans"]
    data, meta, cam = cfg["scene1"]
    reset_counts()
    out["sharded"] = render_sharded(data, meta, cam, mesh, seed=SEED)
    out["sharded_launches"] = read_counts()["none"]
    out["sharded_replays"] = read_lockstep()["replays"]
    data, meta, cam = cfg["grad"]
    step = make_train_step(meta, mesh)
    target = np.zeros((cam.image_height, cam.image_width, 3), np.float32)
    reset_counts()
    loss, grads = step(data, cam, target, SEED)
    counts = read_counts()
    out["step_launches"] = counts["none"]
    out["step_bwd_launches"] = counts["bwd"]
    out["step_all_reduce"] = step.collectives["all_reduce"]
    out["loss"] = loss.cpu().numpy()
    out.update({f"grad_{k}": g.cpu().numpy() for k, g in grads.items()})
    data, meta, cam = cfg["scene6"]
    kw = dict(seed=SEED, spt=SHARD_PROG_SPT, mesh=mesh)
    reset_counts()
    if resume:
        out["prog_full"] = render_progressive_wavefront(data, meta, cam,
                                                        **kw).fb
        state = load_state(ckpt)
        assert state.samples_done == SHARD_PROG_SPT, state.samples_done
        out["prog_resumed"] = render_progressive_wavefront(
            data, meta, cam, state=state, **kw).fb
    else:
        def stop(state):
            raise _Interrupted
        try:
            render_progressive_wavefront(data, meta, cam, checkpoint_path=ckpt,
                                         on_step=stop, **kw)
            raise AssertionError("progressive: no interruption")
        except _Interrupted:
            pass
    out["prog_launches"] = read_counts()["none"]
    return out


def shard_worker(argv):
    """One rank of phase 17 (b): ``chip_smoke.py --rank r --world n --store
    FILE --out DIR --ckpt FILE`` on a gloo group whose ranks share the one
    card (NCCL refuses two ranks on one GPU); writes DIR/shard_rank{r}.npz."""
    p = argparse.ArgumentParser()
    for flag in ("--rank", "--world"):
        p.add_argument(flag, type=int, required=True)
    for flag in ("--store", "--out", "--ckpt"):
        p.add_argument(flag, required=True)
    a = p.parse_args(argv)
    import torch.distributed as dist

    dev = require_cuda()
    dist.init_process_group(
        "gloo", init_method=f"file://{a.store}", rank=a.rank,
        world_size=a.world,
        timeout=datetime.timedelta(seconds=WORKER_TIMEOUT_S))
    try:
        mesh = make_mesh(a.world, devices=[dev] * a.world)
        t0 = time.perf_counter()
        out = sharded_runs(mesh, a.ckpt, resume=False)
        out["seconds"] = time.perf_counter() - t0
        np.savez(os.path.join(a.out, f"shard_rank{a.rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def run_shard_workers(d, ckpt):
    """Start the SHARD_WORLD ranks of phase 17 (b) and wait for them; a
    rank that fails or outlives WORKER_TIMEOUT_S fails the run.  Returns
    each rank's results and the seconds they took together."""
    tag = f"{os.getpid()}_{time.time_ns()}"
    store = os.path.join(d, f"store_gloo_{tag}")
    for f in [ckpt] + [os.path.join(d, f"shard_rank{r}.npz")
                       for r in range(SHARD_WORLD)]:
        if os.path.exists(f):
            os.unlink(f)
    try:
        seconds = run_ranks(
            [[sys.executable, os.path.abspath(__file__), "--rank", r,
              "--world", SHARD_WORLD, "--store", store, "--out", d,
              "--ckpt", ckpt] for r in range(SHARD_WORLD)],
            [os.path.join(d, f"shard_rank{r}.log")
             for r in range(SHARD_WORLD)],
            WORKER_TIMEOUT_S, cwd=os.path.dirname(os.path.abspath(__file__)))
    except RuntimeError as e:
        raise AssertionError(f"phase 17: worker {e}") from None
    return [dict(np.load(os.path.join(d, f"shard_rank{r}.npz")))
            for r in range(SHARD_WORLD)], seconds


def bvh_leaves(n, seed):
    """tests/test_native.py's leaves: n spheres and max(1, n // 3) quads."""
    from mort_tpu_torch.scene.types import OBJ_QUAD, OBJ_SPHERE

    g = np.random.RandomState(seed)
    centers = (g.randn(n, 3) * 10).astype(np.float32)
    radii = g.uniform(0.1, 2.0, n).astype(np.float32)
    nq = max(1, n // 3)
    qq = (g.randn(nq, 3) * 5).astype(np.float32)
    qu = g.randn(nq, 3).astype(np.float32)
    qv = g.randn(nq, 3).astype(np.float32)
    leaves = ([(OBJ_SPHERE, i) for i in range(n)]
              + [(OBJ_QUAD, i) for i in range(nq)])
    return leaves, centers, radii, np.zeros((n, 3), np.float32), qq, qu, qv


def host_bvh_builder():
    """Phase 17 (c): the C++ BVH builder builds (g++) and equals the numpy
    builder bit for bit on every array; returns the build seconds."""
    from mort_tpu_torch import native
    from mort_tpu_torch.scene.bvh import build_bvh_numpy, build_bvh_via_native

    t0 = time.perf_counter()
    assert native.have_native(), f"native BVH builder: {native.build_error()}"
    build_s = time.perf_counter() - t0
    for n in BVH_SIZES:
        args = bvh_leaves(n, seed=n)
        got = build_bvh_via_native(*args)
        want = build_bvh_numpy(*args)
        assert got is not None and len(got) == len(want) == 7, n
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w), n
    return build_s


def sharded_paths(dev, card, scene1_img, scene1_wall, step_wall):
    """Phase 17: the sharded paths.  (a) on a 1-rank NCCL group, the main
    paths at full width: ``render_wavefront(mesh=make_mesh(1))`` on scene 1
    at its bench config beside phase 5, and the train step at bench.py
    --grad's config against ``mesh=None``'s; (b) two gloo ranks on the one
    card against the 1-rank mesh, and the 1-rank mesh bit-equal to the
    render without a mesh over the same layer-aligned spans at (b)'s
    scene-1 config; (c) the host BVH builder.  Returns the
    ``{"sharding": ...}`` record."""
    import torch.distributed as dist

    t_phase = time.perf_counter()
    d = out_dir()
    ckpt = os.path.join(d, "shard_scene6.npz")
    store = os.path.join(d, f"store_nccl_{os.getpid()}_{time.time_ns()}")
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=600))
    rec = {}
    try:
        mesh = make_mesh(1)
        assert mesh.device == dev and mesh.groups == (None,), mesh
        # ---- (a) scene 1 at its bench config through the 1-rank mesh ----
        world1, cam1 = sc.random_spheres()
        data1, meta1 = world1.compile()
        spp = cam1.sqrt_spp ** 2
        n_paths = cam1.image_width * cam1.image_height * spp
        reset_counts()
        t0 = time.perf_counter()
        img, stats = render_wavefront(data1, meta1, cam1, seed=SEED,
                                      mesh=mesh, return_stats=True)
        torch.cuda.synchronize()
        mesh_wall = time.perf_counter() - t0
        counts = read_counts()
        graphs = read_graphs("scene1 1-rank mesh")
        assert counts["none"] > 0, "1-rank mesh: the none kernel never ran"
        # one capture for the call's 13 layer-aligned spans
        assert graphs["captures"] == 1 < graphs["spans"] and \
            graphs["replays"] == graphs["rounds"] - 1, \
            f"1-rank mesh: {graphs}"
        assert bool(torch.isfinite(img).all()), "non-finite pixels"
        frac, mdiff = assert_images_close(img.cpu().numpy(), scene1_img)
        log(f"main path scene1 1-rank NCCL mesh {cam1.image_width}x"
            f"{cam1.image_height} @ {spp}spp depth {cam1.bounce_limit}: wall "
            f"{mesh_wall:.3f} s ({n_paths / mesh_wall:.1f} paths/s, "
            f"{stats['iterations']} rounds in one layer-aligned span a "
            f"layer) beside phase 5's {scene1_wall:.3f} s; none launches "
            f"{counts['none']}; span graphs {graphs}; collectives "
            f"{stats['collectives']}; against "
            f"phase 5's image frac_within={frac:.5f}, mean_abs={mdiff:.3e} "
            f"| {card}")
        assert stats["collectives"] == {"spans": 0, "gather": 1, "stats": 1}
        rec.update(scene1_wall_s=scene1_wall, scene1_mesh1_wall_s=mesh_wall,
                   scene1_mesh1_launches=counts["none"],
                   scene1_mesh1_collectives=stats["collectives"])
        del img

        # ---- (a) the train step at bench.py --grad's config ----
        gcam = cam1.replace(image_width=GRAD_W, image_height=GRAD_H,
                            sqrt_spp=2, bounce_limit=8)
        target = np.zeros((GRAD_H, GRAD_W, 3), np.float32)
        steps = {"mesh": make_train_step(meta1, mesh),
                 "none": make_train_step(meta1)}
        walls = {"mesh": [], "none": []}
        counts = dict.fromkeys(ch.launch_count, 0)
        step_graphs = dict.fromkeys(sharding.step_graph_count, 0)

        def run(kind, seed):
            # the mesh step's launches and step graphs are counted from
            # just before to just after each of its calls; the mesh=None
            # steps are not counted
            reset_counts()
            t0 = time.perf_counter()
            loss, grads = steps[kind](data1, gcam, target, seed)
            float(loss)
            torch.cuda.synchronize()
            walls[kind].append(time.perf_counter() - t0)
            if kind == "mesh":
                for mode, n in read_counts().items():
                    counts[mode] += n
                for k, n in read_step_graphs().items():
                    step_graphs[k] += n
            return loss, grads

        for kind in ("mesh", "none"):       # warm-up: the operands' upload
            run(kind, GRAD_SEEDS[0])
            walls[kind].clear()
        # the two steps in turns, each first in every other pair: the
        # order of the runs cancels from the comparison
        for i, seed in enumerate(GRAD_SEEDS[1:]):
            for kind in (("none", "mesh") if i % 2 == 0
                         else ("mesh", "none")):
                res = run(kind, seed)
                if kind == "mesh":
                    loss, grads = res
                else:
                    w_loss, w_grads = res
        per_step = gcam.sqrt_spp ** 2 * gcam.bounce_limit
        assert counts["none"] == counts["bwd"] == len(GRAD_SEEDS) * per_step
        STEP_GRAPHS["train step scene1 1-rank mesh"] = step_graphs
        assert step_graphs["captures"] == 1, step_graphs
        assert step_graphs["replays"] == len(GRAD_SEEDS) - 1, step_graphs
        coll = steps["mesh"].collectives["all_reduce"]
        assert coll == 1, steps["mesh"].collectives
        step_grads_ok(loss, grads, ("sph_center", "mat_albedo", "tex_color"))
        torch.testing.assert_close(loss, w_loss, rtol=1e-4, atol=0.0)
        scale = max(float(g.abs().max()) for g in w_grads.values())
        for k, g in grads.items():
            torch.testing.assert_close(g, w_grads[k], rtol=1e-3,
                                       atol=1e-5 * scale,
                                       msg=lambda m, k=k: f"{k}: {m}")
        step_equal = bool(torch.equal(loss, w_loss)) and all(
            torch.equal(g, w_grads[k]) for k, g in grads.items())
        wall = statistics.median(walls["mesh"])
        none_wall = statistics.median(walls["none"])
        g_paths = GRAD_W * GRAD_H * gcam.sqrt_spp ** 2
        log(f"main path train step scene1 1-rank NCCL mesh {GRAD_W}x{GRAD_H}"
            f" @ 4spp depth 8: median wall {wall:.3f} s ("
            f"{', '.join(f'{w:.3f}' for w in walls['mesh'])}) against "
            f"mesh=None {none_wall:.3f} s ("
            f"{', '.join(f'{w:.3f}' for w in walls['none'])}) in turns "
            f"(phase 10: {step_wall:.3f} s), {g_paths / wall:.1f} grad "
            f"paths/s, launches per step none "
            f"{counts['none'] // len(GRAD_SEEDS)} bwd "
            f"{counts['bwd'] // len(GRAD_SEEDS)}, all-reduces a step {coll} "
            f"(one flat bucket: the loss and the ten gradients); loss and "
            f"grads bit-equal to mesh=None {step_equal} | {card}")
        rec.update(step_wall_s=step_wall, step_none_turns_wall_s=none_wall,
                   step_mesh1_wall_s=wall,
                   step_mesh1_grad_paths_per_s=g_paths / wall,
                   step_mesh1_launches={"none": counts["none"],
                                        "bwd": counts["bwd"]},
                   step_mesh1_all_reduce=coll,
                   step_mesh1_bit_equal=step_equal)
        del grads, w_grads

        # ---- (b) two gloo ranks on the one card against one rank ----
        torch.cuda.empty_cache()
        two, workers_s = run_shard_workers(d, ckpt)
        t0 = time.perf_counter()
        one = sharded_runs(mesh, ckpt, resume=True)
        one_s = time.perf_counter() - t0
        # the 1-rank mesh against the render without a mesh over the same
        # spans, one a layer (spt = min(spp, 8): the default at depth 20);
        # the full-size render would cost phase 5's wall again
        data, meta, cam = shard_configs()["scene1"]
        spp = cam.sqrt_spp ** 2
        t0 = time.perf_counter()
        ref = render_wavefront(data, meta, cam, dev, seed=SEED,
                               layer_range=(0, -(-spp // min(spp, 8))))
        torch.cuda.synchronize()
        layers_wall = time.perf_counter() - t0
        mesh1_equal = bool(np.array_equal(ref.cpu().numpy(),
                                          one["wf_scene1"]))
        log(f"scene1 {SHARD_W}x{SHARD_H} @ {spp}spp depth 20: 1-rank mesh "
            f"{float(one['wf_scene1_s']):.3f} s, without a mesh over the "
            f"same layer-aligned spans {layers_wall:.3f} s, bit-equal "
            f"{mesh1_equal} | {card}")
        assert mesh1_equal, "1-rank mesh render differs from the render " \
            "without a mesh over the same spans"
        rec.update(scene1_reduced_mesh1_wall_s=float(one["wf_scene1_s"]),
                   scene1_reduced_layer_spans_wall_s=layers_wall,
                   mesh1_bit_equal_layer_spans=mesh1_equal)
        for r, res in enumerate(two):
            for key in ("wf_scene1_launches", "wf_spread16k_launches",
                        "sharded_launches", "step_launches",
                        "step_bwd_launches", "prog_launches"):
                assert res[key] > 0, f"rank {r}: {key} {res[key]}"
            assert res["step_all_reduce"] == 1
            assert res["wf_scene1_span_collectives"] == 0
        for r, res in enumerate(two + [one]):
            assert res["sharded_replays"] > 0, \
                f"render_sharded replayed no lockstep graph ({r})"
        # the mesh stats' rule (the JAX package's): iterations is the sum
        # over spans of the largest rank's rounds, slots count every rank's
        span_rounds = {}
        for name in ("scene1", "spread16k"):
            span_rounds[name] = {}
            for label, ranks in (("two_rank", two), ("one_rank", [one])):
                rounds = np.stack([res[f"wf_{name}_rounds"]
                                   for res in ranks])      # [rank, span]
                iters = int(rounds.max(0).sum())
                slots = int(rounds.sum()) * int(ranks[0][
                    f"wf_{name}_slot_size"])
                for r, res in enumerate(ranks):
                    got = (int(res[f"wf_{name}_iterations"]),
                           int(res[f"wf_{name}_slots_executed"]))
                    assert got == (iters, slots), \
                        f"phase 17: {name} rank {r}/{len(ranks)}: " \
                        f"(iterations, slots) {got}, per-span rounds " \
                        f"{rounds.tolist()} give {(iters, slots)}"
                span_rounds[name].update({f"{label}_rounds": rounds.tolist(),
                                          f"{label}_iterations": iters})
        wf_equal = {name: all(np.array_equal(res[f"wf_{name}"],
                                             one[f"wf_{name}"])
                              for res in two)
                    for name in ("scene1", "spread16k")}
        frac, mdiff = assert_images_close(two[0]["sharded"], one["sharded"])
        sharded_equal = all(np.array_equal(res["sharded"], one["sharded"])
                            for res in two)
        np.testing.assert_allclose(two[0]["loss"], one["loss"], rtol=1e-4)
        worst = 0.0
        for k in [k for k in one if k.startswith("grad_")]:
            np.testing.assert_allclose(two[0][k], one[k], rtol=5e-3,
                                       atol=1e-5, err_msg=k)
            assert np.array_equal(two[1][k], two[0][k]), k
            worst = max(worst, float(np.abs(two[0][k] - one[k]).max()))
        prog_equal = bool(np.array_equal(one["prog_resumed"],
                                         one["prog_full"]))
        useful = two[0]["wf_scene1_useful"]
        log(f"sharded 2 gloo ranks on one card vs 1 rank: wavefront bit-equal"
            f" scene1 {SHARD_W}x{SHARD_H} @ {SHARD_SQRT_SPP ** 2}spp depth 20 "
            f"{wf_equal['scene1']}, spread16k 160x90 @ 4spp depth 4 (bvh) "
            f"{wf_equal['spread16k']}; per-rank useful segments scene1 "
            f"{useful.tolist()}; per-span rounds [rank][span] and "
            f"iterations (the sum of each span's largest) "
            + ", ".join(f"{name} {v['two_rank_rounds']} -> "
                        f"{v['two_rank_iterations']} (1 rank "
                        f"{v['one_rank_rounds'][0]} -> "
                        f"{v['one_rank_iterations']})"
                        for name, v in span_rounds.items())
            + f"; render_sharded frac_within={frac:.5f}, "
            f"mean_abs={mdiff:.3e} (bit-equal {sharded_equal}); train step "
            f"{SHARD_W}x{SHARD_H} loss {float(two[0]['loss']):.7f} vs "
            f"{float(one['loss']):.7f}, grads max |diff| {worst:.3e}; "
            f"scene 6 progressive {SHARD_PROG_W}x{SHARD_PROG_W} @ "
            f"{SHARD_PROG_SQRT_SPP ** 2}spp spt {SHARD_PROG_SPT} "
            f"checkpointed after one step on 2 ranks, resumed on 1: "
            f"bit-equal {prog_equal}; launches per rank "
            + "; ".join(f"rank {r}: none {res['wf_scene1_launches']}, bvh "
                        f"{res['wf_spread16k_launches']} (span captures "
                        f"{res['wf_scene1_captures']}, "
                        f"{res['wf_spread16k_captures']}), render_sharded "
                        f"{res['sharded_launches']} (lockstep replays "
                        f"{res['sharded_replays']}), step none "
                        f"{res['step_launches']} bwd "
                        f"{res['step_bwd_launches']}, progressive "
                        f"{res['prog_launches']}"
                        for r, res in enumerate(two))
            + f"; 1 rank's span captures {one['wf_scene1_captures']}, "
            f"{one['wf_spread16k_captures']}"
            + f"; workers {workers_s:.1f} s (rank 0's checks "
            f"{float(two[0]['seconds']):.1f} s), 1-rank side {one_s:.1f} s")
        assert all(wf_equal.values()), wf_equal
        assert prog_equal, "phase 17: the resumed render differs"
        rec.update(two_rank_wavefront_bit_equal=wf_equal,
                   two_rank_render_sharded_bit_equal=sharded_equal,
                   two_rank_grads_max_abs_diff=worst,
                   two_rank_resume_bit_equal=prog_equal,
                   two_rank_launches=[{
                       k[:-len("_launches")]: int(res[k]) for k in res
                       if k.endswith("_launches")} for res in two],
                   two_rank_render_sharded_replays=[
                       int(res["sharded_replays"]) for res in two],
                   one_rank_render_sharded_replays=int(
                       one["sharded_replays"]),
                   two_rank_step_all_reduce=int(two[0]["step_all_reduce"]),
                   two_rank_wavefront_collectives=int(
                       two[0]["wf_scene1_collectives"]),
                   two_rank_per_shard_useful=useful.tolist(),
                   span_rounds=span_rounds)
    finally:
        dist.destroy_process_group()

    # ---- (c) the host BVH builder ----
    build_s = host_bvh_builder()
    log(f"host BVH builder: g++ build/load {build_s:.2f} s; native equals "
        f"numpy bit for bit on all seven arrays for n in {BVH_SIZES}")
    rec.update(bvh_native_equals_numpy=True, bvh_build_s=build_s,
               seconds=time.perf_counter() - t_phase)
    return rec



# Phase 19's cut: 1 spp of config #5's 16, and a 4096-task warm-up span
# in place of a whole warm-up frame (the run's time limit)
CONFIG5_SPP, CONFIG5_WARMUP_TASKS = 1, 4096
BENCH_LINE_KEYS = {"metric", "value", "unit", "vs_baseline"}


@contextlib.contextmanager
def span_calls(module):
    """Within it, each call of ``module.render_wavefront`` (a tool's own
    name for it) appends the span graph counts it added to the list
    yielded."""
    calls, fn = [], module.render_wavefront

    def counted(*args, **kw):
        before = dict(wf.graph_count)
        res = fn(*args, **kw)
        calls.append({k: wf.graph_count[k] - n for k, n in before.items()})
        return res
    module.render_wavefront = counted
    try:
        yield calls
    finally:
        module.render_wavefront = fn


def parity_phase(dev, card):
    """Phase 18: every config of the parity gate on the card against the
    committed JAX references; fails the run if one fails.  Returns the
    record and the launches of each mode over the phase."""
    from mort_tpu_torch import parity

    reset_counts()
    rec = parity.run(dev, log=log)
    counts = read_counts()
    log(json.dumps({"parity": rec}))
    bad = [r["label"] for r in rec["scenes"] if not r["ok"]]
    assert rec["ok"] and not bad, f"phase 18: parity fails on {bad}"
    for mode in ch.ACCELS:
        assert counts[mode] > 0, f"phase 18: no {mode} launch"
    log(f"parity: {len(rec['scenes'])} configs OK against the JAX package's "
        f"CPU references (worst cross/noise "
        f"{max(r['cross_over_noise'] for r in rec['scenes']):.3f}, worst "
        f"channel error "
        f"{max(r['channel_mean_rel_err'] for r in rec['scenes']):.5f}); "
        f"launches none {counts['none']}, bvh {counts['bvh']}, cull "
        f"{counts['cull']} | {card}")
    return rec, counts


def config5_phase(dev, card):
    """Phase 19: BASELINE config #5 through ``config5.run_device`` with
    spp cut to CONFIG5_SPP, launch counts reset just before and read just
    after.  Returns the record and the counts."""
    from mort_tpu_torch import config5

    reset_counts()
    with span_calls(config5) as calls:
        rec = config5.run_device(dev, spp=CONFIG5_SPP,
                                 warmup_tasks=CONFIG5_WARMUP_TASKS, log=log)
    counts = read_counts()
    graphs = read_step_graphs("config5 train step")
    assert counts["none"] > 0 and counts["bwd"] > 0, counts
    assert graphs["captures"] == 1 and graphs["replays"] > 0, graphs
    # the warm-up span and the frame share one key: the frame replays
    spans = read_graphs("config5 forward")
    assert [c["captures"] for c in calls] == [1, 0], calls
    log(f"config5: final_scene 1920x1080 depth {rec['depth']}, spp cut from "
        f"16 to {rec['spp']} for the run's time, warm-up span "
        f"{CONFIG5_WARMUP_TASKS} tasks: {json.dumps(rec)}; launches none "
        f"{counts['none']}, bwd {counts['bwd']}; step graphs {graphs}; span "
        f"captures warm-up {calls[0]['captures']}, frame "
        f"{calls[1]['captures']} (span graphs {spans})")
    return rec, counts


def bench_phase(dev, card):
    """Phase 20: ``mort_tpu_torch.bench`` for scene 5 (2 frames) and
    ``--grad``, their summary lines checked for bench.py's keys.  Returns
    the records (scene 5's, the grad step's) and the launches of each."""
    from mort_tpu_torch import bench

    recs, counts = [], []
    for argv in (["--scene", "5", "--frames", "2"], ["--grad"]):
        out = io.StringIO()
        reset_counts()
        with contextlib.redirect_stdout(out), span_calls(bench) as calls:
            (rec,) = bench.main(argv)
        counts.append(read_counts())
        graphs = read_step_graphs(f"bench {' '.join(argv)}")
        # the warm-up span and the frames share one key: compile_s holds
        # the capture, the frames replay
        captures = [c["captures"] for c in calls]
        assert captures == ([1, 0, 0] if calls else []), captures
        line = json.loads(out.getvalue().strip().splitlines()[-1])
        assert set(line) == BENCH_LINE_KEYS, line
        assert line["unit"] == "paths/s/chip" and line["value"] > 0, line
        log(f"bench {' '.join(argv)}: {json.dumps(rec)}; summary line "
            f"{json.dumps(line)}; launches none {counts[-1]['none']}, bwd "
            f"{counts[-1]['bwd']}; step graphs {graphs}; span captures "
            f"(warm-up, then each frame) {captures}")
        recs.append(rec)
    assert counts[0]["none"] > 0 and counts[1]["bwd"] > 0, counts
    assert STEP_GRAPHS["bench --grad"]["replays"] > 0, STEP_GRAPHS
    return recs, counts


def tool_phases(dev, card, t_start):
    """Phases 18-20, each timed; returns their record."""
    out = {}
    t0 = time.perf_counter()
    parity, counts18 = parity_phase(dev, card)
    out["parity_s"] = time.perf_counter() - t0
    log(f"phase 18 took {out['parity_s']:.1f} s, done at "
        f"{time.perf_counter() - t_start:.1f} s")
    t0 = time.perf_counter()
    c5, counts19 = config5_phase(dev, card)
    out["config5_s"] = time.perf_counter() - t0
    log(f"phase 19 took {out['config5_s']:.1f} s, done at "
        f"{time.perf_counter() - t_start:.1f} s")
    t0 = time.perf_counter()
    (b5, bgrad), counts20 = bench_phase(dev, card)
    out["bench_s"] = time.perf_counter() - t0
    log(f"phase 20 took {out['bench_s']:.1f} s, done at "
        f"{time.perf_counter() - t_start:.1f} s")
    out.update({
        "parity_ok": parity["ok"],
        "parity_ratio": {r["label"]: r["cross_over_noise"]
                         for r in parity["scenes"]},
        "parity_launches": {m: counts18[m] for m in ch.ACCELS},
        "config5": c5, "config5_launches": {k: counts19[k]
                                            for k in ("none", "bwd")},
        "bench5": b5, "bench_grad": bgrad,
        "bench_launches": [{k: c[k] for k in ("none", "bwd")}
                           for c in counts20],
        "card": card})
    return out


@contextlib.contextmanager
def eager_spans(eager=True):
    """With ``eager``, every span's rounds run eagerly on the card
    (``_span_core``'s private ``eager``), to compare with the graph
    route."""
    core = wf._span_core
    if eager:
        wf._span_core = functools.partial(core, eager=True)
    try:
        yield
    finally:
        wf._span_core = core


def on_route(fn, eager):
    """``fn()`` on the graph route or the eager one: its result, the
    closest-hit launches and span graph counts it added, its wall seconds
    and its peak device memory (bytes)."""
    with eager_spans(eager):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return (res, read_counts(), read_graphs(), wall,
                torch.cuda.max_memory_allocated())


def routes_bit_equal(dev):
    """Phase 21 (a): each config through both routes over layer-aligned
    spans, the graph route from a new key: the images bit-equal (raw int32
    views), rounds, useful segments, slots and launches equal, one capture
    over the call's spans and every round after the key's first a replay
    on the graph route, none on the eager one."""
    from mort_tpu_torch.render.progressive import (
        render_progressive_wavefront,
    )

    world9, cam9 = sc.final_scene(400, 250, 4)
    data9, meta9 = world9.compile()
    cam9 = cam9.replace(image_width=100, image_height=100, sqrt_spp=4)
    world16, cam16 = sc.spread_spheres()
    data16, meta16 = world16.compile()
    cam16 = cam16.replace(image_width=160, image_height=90, sqrt_spp=2,
                          bounce_limit=4)
    world6, cam6 = sc.build_scene(6)
    data6, meta6 = world6.compile()
    cam6 = cam6.replace(image_width=48, image_height=48, sqrt_spp=3,
                        bounce_limit=8)

    def wave(data, meta, cam, layers, accel=None):
        return lambda: render_wavefront(data, meta, cam, dev, seed=SEED,
                                        accel=accel, layer_range=layers,
                                        return_stats=True)

    def progressive():
        st = render_progressive_wavefront(data6, meta6, cam6, seed=SEED,
                                          spt=3, device=dev)
        return torch.from_numpy(st.fb), {}

    cases = [(f"scene9 100x100 16spp {m}", wave(data9, meta9, cam9, (0, 2),
                                                m), m) for m in ch.ACCELS]
    cases += [("spread16k 160x90 4spp depth 4",
               wave(data16, meta16, cam16, (0, 1)), "bvh"),
              ("progressive scene6 48x48 9spp spt 3", progressive, "none")]
    out = {}
    for name, fn, mode in cases:
        wf.drop_graph()
        (g_img, g_stats), g_l, g_g, _, _ = on_route(fn, False)
        (e_img, e_stats), e_l, e_g, _, _ = on_route(fn, True)
        equal = bool(torch.equal(g_img.view(torch.int32),
                                 e_img.view(torch.int32)))
        log(f"routes {name}: graph vs eager bit-equal {equal}; stats "
            f"{g_stats}; launches {g_l}; graph route {g_g}; eager route "
            f"rounds {e_g['rounds']}, replays {e_g['replays']}")
        assert equal, f"phase 21: {name}: the routes' images differ"
        assert g_stats == e_stats and g_l == e_l and g_l[mode] > 0, name
        assert g_g["rounds"] == e_g["rounds"] and e_g["replays"] == 0, name
        assert g_g["captures"] == 1 and g_g["recaptures"] == 0, name
        assert g_g["replays"] == g_g["rounds"] - 1 > 0, name
        out[name] = {"bit_equal": equal, "launches": g_l[mode],
                     "rounds": g_g["rounds"], "replays": g_g["replays"],
                     "spans": g_g["spans"], "captures": g_g["captures"]}
    return out


def routes_frame(name, world, cam, dev, card):
    """Phase 21 (b): one config's frame on both routes in the order graph,
    eager, graph (the eager route, ~4-7x slower, once, between the other's
    two runs; the second graph frame replays the first's kept capture),
    with the wall, peak memory, rounds, host reads, captures and capture
    seconds of each; the same rounds, useful segments and launches on
    every run, the images by the image rule (over default spans
    index_add_'s atomic order may differ); then the frame once more on
    each route under ``torch.profiler``: the device's busy seconds, its
    idle share of the route's mean unprofiled wall and the kernels a
    bounce step."""
    data, meta = world.compile()

    def frame():
        return render_wavefront(data, meta, cam, dev, seed=SEED,
                                return_stats=True)

    wf.drop_graph()
    runs = {False: [], True: []}
    for eager in (False, True, False):
        (img, stats), launches, graphs, wall, peak = on_route(frame, eager)
        runs[eager].append((img, stats, launches, graphs, wall, peak))
        log(f"routes {name} {cam.image_width}x{cam.image_height} @ "
            f"{cam.sqrt_spp ** 2}spp depth {cam.bounce_limit}, "
            f"{'eager' if eager else 'graph'}: wall {wall:.3f} s, peak "
            f"memory {peak / 2 ** 30:.4f} GiB, {stats['iterations']} rounds, "
            f"launches {launches}, span graphs {graphs} | {card}")
    first = runs[True][0]
    for img, stats, launches, _, _, _ in runs[False]:
        assert stats == first[1] and launches == first[2], name
    frac, mdiff = assert_images_close(runs[False][0][0].cpu().numpy(),
                                      first[0].cpu().numpy())
    rec = {"config": f"{cam.image_width}x{cam.image_height} "
                     f"{cam.sqrt_spp ** 2}spp depth {cam.bounce_limit}",
           "rounds": first[1]["iterations"]}
    for eager, key in ((False, "graph"), (True, "eager")):
        walls = [r[4] for r in runs[eager]]
        rec[key] = {
            "wall_s": walls, "peak_gib": max(r[5] for r in runs[eager])
            / 2 ** 30, "host_reads": runs[eager][0][3]["syncs"],
            "captures": [r[3]["captures"] for r in runs[eager]],
            "replays": [r[3]["replays"] for r in runs[eager]],
            "capture_s": [r[3]["capture_s"] for r in runs[eager]]}
    del runs
    for eager, key in ((False, "graph"), (True, "eager")):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            _, launches, _, p_wall, _ = on_route(frame, eager)
        t0 = time.perf_counter()
        _, busy_us, n_kernels, _ = device_times(prof)
        summarise = time.perf_counter() - t0
        del prof
        assert busy_us > 0, f"{name} {key}: the profiler saw no device time"
        steps = sum(launches.values())
        wall = statistics.mean(rec[key]["wall_s"])
        rec[key].update(busy_s=busy_us / 1e6,
                        idle_share=1 - busy_us / 1e6 / wall,
                        kernels=n_kernels, kernels_per_step=n_kernels / steps)
        log(f"routes {name} profiled frame, {key}: device busy "
            f"{busy_us / 1e6:.4f} s, idle share {1 - busy_us / 1e6 / wall:.4f}"
            f" of the mean unprofiled wall {wall:.3f} s (profiled "
            f"{p_wall:.3f} s), {n_kernels} device kernels = "
            f"{n_kernels / steps:.1f} a bounce step ({steps} steps); "
            f"summarised in {summarise:.1f} s | {card}")
    g, e = rec["graph"], rec["eager"]
    log(f"routes {name}: mean wall graph "
        f"{statistics.mean(g['wall_s']):.3f} s, eager "
        f"{statistics.mean(e['wall_s']):.3f} s; idle share graph "
        f"{g['idle_share']:.4f}, eager {e['idle_share']:.4f}; peak memory "
        f"graph {g['peak_gib']:.4f} GiB, eager {e['peak_gib']:.4f} GiB; "
        f"capture {', '.join(f'{c:.4f}' for c in g['capture_s'])} s; host "
        f"reads a frame graph {g['host_reads']}, eager {e['host_reads']}; "
        f"graph vs eager image frac_within={frac:.5f}, mean_abs={mdiff:.3e}"
        f" | {card}")
    return rec


def kept_memory():
    """(allocated, reserved) bytes that the kept span program holds: what
    dropping it frees (``wavefront.drop_graph``: its graph, the graph's
    memory pool and its static tensors)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    alloc, reserved = torch.cuda.memory_allocated(), \
        torch.cuda.memory_reserved()
    wf.drop_graph()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return (alloc - torch.cuda.memory_allocated(),
            reserved - torch.cuda.memory_reserved())


def kept_key_frames(dev, card):
    """Phase 21 (c): three frames of one key on the graph route, for each
    of scene 9 at 100x100, 16 spp, depth 4 over its two layer-aligned
    spans; spread16k at its own 400x225, 4 spp, depth 8 (one chunk a
    pixel); scene 1 at its bench config through ``make_mesh(1)`` (13
    layer-aligned spans): the first frame captures once, the second and
    third capture nothing and run no eager round (every round a replay),
    and the three are bit-equal (each pixel deposits once a span) with
    equal stats and launches.  Prints each frame's wall, captures and
    replays and the memory the kept program holds after the third."""
    world9, cam9 = sc.final_scene(400, 250, 4)
    data9, meta9 = world9.compile()
    cam9 = cam9.replace(image_width=100, image_height=100, sqrt_spp=4)
    world16, cam16 = sc.spread_spheres()
    data16, meta16 = world16.compile()
    world1, cam1 = sc.random_spheres()
    data1, meta1 = world1.compile()
    mesh = make_mesh(1)
    cases = [
        (f"scene9 100x100 16spp depth {cam9.bounce_limit}", lambda:
         render_wavefront(data9, meta9, cam9, dev, seed=SEED,
                          layer_range=(0, 2), return_stats=True)),
        (f"spread16k {cam16.image_width}x{cam16.image_height} "
         f"{cam16.sqrt_spp ** 2}spp depth {cam16.bounce_limit}", lambda:
         render_wavefront(data16, meta16, cam16, dev, seed=SEED,
                          return_stats=True)),
        (f"scene1 make_mesh(1) {cam1.image_width}x{cam1.image_height} "
         f"{cam1.sqrt_spp ** 2}spp depth {cam1.bounce_limit}", lambda:
         render_wavefront(data1, meta1, cam1, seed=SEED, mesh=mesh,
                          return_stats=True))]
    out = {}
    for name, fn in cases:
        wf.drop_graph()
        frames = [on_route(fn, False) for _ in range(3)]
        (img0, stats0), launches0 = frames[0][0], frames[0][1]
        for k, ((img, stats), launches, graphs, _, _) in enumerate(frames):
            assert torch.equal(img.view(torch.int32),
                               img0.view(torch.int32)), f"{name}: frame {k}"
            assert stats == stats0 and launches == launches0, name
            assert graphs["captures"] == (0 if k else 1), (name, graphs)
            assert graphs["replays"] == graphs["rounds"] - \
                graphs["captures"] > 0, (name, graphs)
        alloc, reserved = kept_memory()
        rec = {"wall_s": [f[3] for f in frames],
               "captures": [f[2]["captures"] for f in frames],
               "replays": [f[2]["replays"] for f in frames],
               "rounds": stats0["iterations"],
               "spans": frames[0][2]["spans"],
               "capture_s": frames[0][2]["capture_s"],
               "peak_gib": [f[4] / 2 ** 30 for f in frames],
               "kept_allocated_gib": alloc / 2 ** 30,
               "kept_reserved_gib": reserved / 2 ** 30, "bit_equal": True}
        out[name] = rec
        walls = ", ".join(f"{w:.3f}" for w in rec["wall_s"])
        log(f"kept key {name}: walls {walls} s, captures "
            f"{rec['captures']}, replays {rec['replays']} of "
            f"{rec['rounds']} rounds a frame over {rec['spans']} spans, "
            f"capture {rec['capture_s']:.4f} s; three frames bit-equal; the "
            f"kept program held {rec['kept_allocated_gib']:.4f} GiB "
            f"allocated, {rec['kept_reserved_gib']:.4f} GiB reserved after "
            f"the third; peak {', '.join(f'{p:.4f}' for p in rec['peak_gib'])}"
            f" GiB | {card}")
    return out


def span_graph_phase(dev, card):
    """Phase 21: the spans' CUDA graphs against the eager rounds.  Returns
    the ``{"span_graph": ...}`` record: (a) the bit-equality set, (b)
    scene 1 at its bench config cut to 36 spp, depth 8, (c) three frames
    of one key, and the graph counts of the main paths of phases 5-19.
    (b)'s scene-9 frames (400x400, 16 spp: 73-100 s of the run on an H100
    80GB HBM3 at 700 W) were cut to make room for phase 23; phase 6 still
    renders scene 9 at its code-true config on the graph route, and (a)
    holds its routes bit-equal at 100x100."""
    t0 = time.perf_counter()
    rec = {"bit_equal": routes_bit_equal(dev)}
    log(f"phase 21 (a) took {time.perf_counter() - t0:.1f} s")
    # scene 1 at its bench config cut from 100 spp and depth 20 to 36 spp
    # and depth 8: its eager frames took 17-25 s each (PR 12), phase 21
    # 236-321 s of the run
    world1, cam1 = sc.random_spheres()
    cam1 = cam1.replace(sqrt_spp=6, bounce_limit=8)
    t0 = time.perf_counter()
    rec["scene1"] = routes_frame("scene1", world1, cam1, dev, card)
    log(f"phase 21 (b) scene1 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rec["kept_key"] = kept_key_frames(dev, card)
    log(f"phase 21 (c) took {time.perf_counter() - t0:.1f} s")
    rec["main_paths"] = dict(GRAPHS)
    for name, g in GRAPHS.items():
        log(f"span graphs of the main path {name}: {g}")
    return rec


def same_bits(a, b):
    """Whether two steps' (loss, grads) are equal bit for bit."""
    (a_loss, a_grads), (b_loss, b_grads) = a, b
    return torch.equal(a_loss.view(torch.int32),
                       b_loss.view(torch.int32)) and all(
        torch.equal(g.view(torch.int32), b_grads[k].view(torch.int32))
        for k, g in a_grads.items())


def step_graph_phase(dev, card):
    """Phase 22: the train step's CUDA graph against the eager step at
    phase 10's config.  Each route's first call (the graph route's warm-up
    step and capture), then three seeds on both routes in turns (graph,
    eager; eager, graph; graph, eager): wall, grad paths/s, peak memory and
    launches a step, and the memory each route's first call leaves reserved
    (on the graph route, the graph's pool, which keeps the step's
    intermediates); one more eager step at the last seed shows whether
    two eager steps are bit-equal, and the routes are held bit-equal if
    they are, else within phase 17's tolerance; then one step of each route
    under ``torch.profiler``: device busy seconds, idle share of the
    route's median wall, kernels a bounce.  Returns the ``{"step_graph":
    ...}`` record."""
    world, cam = sc.random_spheres()
    data, meta = world.compile()
    cam = cam.replace(image_width=GRAD_W, image_height=GRAD_H, sqrt_spp=2,
                      bounce_limit=8)
    target = np.zeros((GRAD_H, GRAD_W, 3), np.float32)
    per_step = cam.sqrt_spp ** 2 * cam.bounce_limit
    n_paths = GRAD_W * GRAD_H * cam.sqrt_spp ** 2
    steps = {False: make_train_step(meta),
             True: make_train_step(meta, _eager=True)}
    names = {False: "graph", True: "eager"}
    rec = {k: {"wall_s": [], "peak_gib": []} for k in names.values()}
    results = {}

    def call(eager, seed):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        res = steps[eager](data, cam, target, seed)
        float(res[0])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, graphs = read_counts(), read_step_graphs()
        assert counts["none"] == counts["bwd"] == per_step, counts
        return res, wall, torch.cuda.max_memory_allocated(), graphs

    for eager in (False, True):
        # what the first call leaves reserved, cached blocks released: the
        # graph's private pool on the graph route
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        _, wall, peak, graphs = call(eager, GRAD_SEEDS[0])
        torch.cuda.empty_cache()
        assert graphs["captures"] == (0 if eager else 1), graphs
        rec[names[eager]].update(
            first_call_s=wall, capture_s=graphs["capture_s"],
            first_peak_gib=peak / 2 ** 30,
            kept_gib=(torch.cuda.memory_reserved() - reserved) / 2 ** 30)
    for i, seed in enumerate(GRAD_SEEDS[1:]):
        for eager in ((False, True) if i % 2 == 0 else (True, False)):
            res, wall, peak, graphs = call(eager, seed)
            assert graphs["captures"] == graphs["recaptures"] == 0, graphs
            assert graphs["replays"] == (0 if eager else 1), graphs
            results[eager, seed] = res
            rec[names[eager]]["wall_s"].append(wall)
            rec[names[eager]]["peak_gib"].append(peak / 2 ** 30)
            log(f"step routes scene1 {GRAD_W}x{GRAD_H} @ 4spp depth 8, "
                f"{names[eager]}, seed {seed}: wall {wall:.4f} s, "
                f"{n_paths / wall:.1f} grad paths/s, peak memory "
                f"{peak / 2 ** 30:.4f} GiB, loss {float(res[0]):.7f} | "
                f"{card}")
    again = call(True, GRAD_SEEDS[-1])[0]
    deterministic = same_bits(again, results[True, GRAD_SEEDS[-1]])
    equal = all(same_bits(results[False, s], results[True, s])
                for s in GRAD_SEEDS[1:])
    worst = 0.0
    for s in GRAD_SEEDS[1:]:
        (g_loss, g_grads), (e_loss, e_grads) = results[False, s], \
            results[True, s]
        step_grads_ok(g_loss, g_grads, ("sph_center", "mat_albedo",
                                        "tex_color"))
        torch.testing.assert_close(g_loss, e_loss, rtol=1e-4, atol=0.0)
        scale = max(float(g.abs().max()) for g in e_grads.values())
        for k, g in g_grads.items():
            torch.testing.assert_close(g, e_grads[k], rtol=1e-3,
                                       atol=1e-5 * scale,
                                       msg=lambda m, k=k: f"{k}: {m}")
            worst = max(worst, float((g - e_grads[k]).abs().max()) / scale)
    if deterministic:
        assert equal, "phase 22: the routes differ where eager steps do not"
    del results, again
    for eager in (False, True):
        key = names[eager]
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            call(eager, GRAD_SEEDS[1])
        kernels, busy_us, n_kernels, modes = device_times(prof)
        del prof
        assert busy_us > 0, f"step {key}: the profiler saw no device time"
        bwd_us = sum(_device_us(e) for e in kernels
                     if "closest_hit_bwd_" in e.key)
        wall = statistics.median(rec[key]["wall_s"])
        rec[key].update(busy_s=busy_us / 1e6,
                        idle_share=1 - busy_us / 1e6 / wall,
                        kernels_per_bounce=n_kernels / per_step,
                        closest_hit_fwd_s=modes["none"] / 1e6,
                        closest_hit_bwd_s=bwd_us / 1e6)
        log(f"step routes profiled step, {key}: device busy "
            f"{busy_us / 1e6:.4f} s, idle share "
            f"{1 - busy_us / 1e6 / wall:.4f} of the median unprofiled wall "
            f"{wall:.4f} s, {n_kernels} device kernels = "
            f"{n_kernels / per_step:.1f} a bounce ({per_step} bounces), "
            f"closest hit forward {modes['none'] / 1e6:.4f} s, backward "
            f"{bwd_us / 1e6:.4f} s | {card}")
    g, e = rec["graph"], rec["eager"]
    rec.update(config=f"{GRAD_W}x{GRAD_H} 4spp depth 8", bit_equal=equal,
               eager_deterministic=deterministic, grads_max_rel_diff=worst,
               recaptures=0, grad_paths_per_s={
                   k: n_paths / statistics.median(rec[k]["wall_s"])
                   for k in names.values()},
               main_paths=dict(STEP_GRAPHS))
    log(f"step routes scene1: median wall graph "
        f"{statistics.median(g['wall_s']):.4f} s, eager "
        f"{statistics.median(e['wall_s']):.4f} s; grad paths/s graph "
        f"{rec['grad_paths_per_s']['graph']:.1f}, eager "
        f"{rec['grad_paths_per_s']['eager']:.1f}; idle share graph "
        f"{g['idle_share']:.4f}, eager {e['idle_share']:.4f}; first call "
        f"graph {g['first_call_s']:.3f} s (capture {g['capture_s']:.3f} s), "
        f"eager {e['first_call_s']:.3f} s; peak memory of a step graph "
        f"{max(g['peak_gib']):.4f} GiB, eager {max(e['peak_gib']):.4f} GiB, "
        f"of the first call graph {g['first_peak_gib']:.4f} GiB, eager "
        f"{e['first_peak_gib']:.4f} GiB; kept reserved after the first call "
        f"(the graph's pool) graph {g['kept_gib']:.4f} GiB, eager "
        f"{e['kept_gib']:.4f} GiB; "
        f"recaptures across seeds 0; two eager steps bit-equal "
        f"{deterministic}, graph vs eager bit-equal {equal} (grads max "
        f"|diff| / max|g| {worst:.3e}) | {card}")
    for name, graphs in STEP_GRAPHS.items():
        log(f"step graphs of the main path {name}: {graphs}")
    return rec


def on_lockstep_route(fn, eager):
    """``fn(eager)`` on the lockstep graph route or the eager one: its
    result, the closest-hit launches and lockstep counts it added, its wall
    seconds, its peak allocated and the reserved device memory (bytes)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = fn(eager)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (torch.as_tensor(res), read_counts(), read_lockstep(), wall,
            torch.cuda.max_memory_allocated(), torch.cuda.memory_reserved())


def lockstep_routes_bit_equal(dev):
    """Phase 23 (a): each lockstep config through both routes: the images
    bit-equal (raw int32 views), launches, bounces and host reads equal,
    replays on the graph route and none on the eager one."""
    from mort_tpu_torch.render.progressive import render_progressive
    from mort_tpu_torch.render.renderer import (
        _pick_ray_batch, radiance_batches,
    )

    world9, cam9 = sc.final_scene(400, 250, 4)
    data9, meta9 = world9.compile()
    data9 = data9.to(dev)
    cam9 = cam9.replace(image_width=100, image_height=100,
                        sqrt_spp=4).to(dev)
    pix9 = torch.arange(100 * 100, device=dev)
    world6, cam6 = sc.build_scene(6)
    data6, meta6 = world6.compile()
    box = cam6.replace(image_width=48, image_height=48, sqrt_spp=4,
                       bounce_limit=8)
    # its own 600x600: batches of 2^17 pixels, the last of 97,856
    prog = cam6.replace(sqrt_spp=2, bounce_limit=8)
    world1, cam1 = sc.random_spheres()
    data1, meta1 = world1.compile()
    cam1 = cam1.replace(image_width=200, image_height=112, sqrt_spp=4)
    mesh = make_mesh(1)

    def lock9(mode):
        return lambda eager: radiance_batches(
            data9, meta9, cam9, SEED, pix9, _pick_ray_batch(meta9, 10000),
            accel=mode, eager=eager)

    def sharded(differentiable):
        return lambda eager: render_sharded(
            data1, meta1, cam1, mesh, seed=SEED,
            differentiable=differentiable, _eager=eager)

    cases = [(f"render scene9 100x100 16spp depth 4 {m}", lock9(m), m)
             for m in ch.ACCELS]
    cases += [
        ("render(use_kernel=False) cornell 48x48 16spp depth 8",
         lambda eager: render(data6, meta6, box, seed=SEED, use_kernel=False,
                              _eager=eager), None),
        ("render_progressive cornell 600x600 4spp depth 8 steps 3+1",
         lambda eager: render_progressive(data6, meta6, prog, seed=SEED,
                                          samples_per_step=3,
                                          _eager=eager).fb, "none"),
        ("render_sharded make_mesh(1) scene1 200x112 16spp depth 20",
         sharded(False), "none"),
        ("render_sharded(differentiable=True) make_mesh(1) scene1 200x112 "
         "16spp depth 20", sharded(True), "none")]
    out = {}
    for name, fn, mode in cases:
        g_img, g_l, g_c, g_wall, _, _ = on_lockstep_route(fn, False)
        e_img, e_l, e_c, e_wall, _, _ = on_lockstep_route(fn, True)
        equal = bool(torch.equal(g_img.view(torch.int32),
                                 e_img.view(torch.int32)))
        log(f"lockstep routes {name}: graph vs eager bit-equal {equal}; "
            f"launches {g_l}; graph route {g_c} ({g_wall:.3f} s); eager "
            f"route bounces {e_c['bounces']}, host reads {e_c['syncs']}, "
            f"replays {e_c['replays']} ({e_wall:.3f} s)")
        assert equal, f"phase 23: {name}: the routes' images differ"
        assert g_l == e_l, name
        assert (g_c["bounces"], g_c["syncs"]) == (e_c["bounces"],
                                                  e_c["syncs"]), name
        assert g_c["replays"] > 0 and e_c["replays"] == e_c["captures"] == 0
        if mode is None:
            assert sum(g_l.values()) == 0, name
        else:
            assert g_l[mode] > 0, name
        out[name] = {"bit_equal": equal,
                     "launches": g_l[mode] if mode else 0,
                     "bounces": g_c["bounces"], "syncs": g_c["syncs"],
                     "captures": g_c["captures"],
                     "replays": g_c["replays"]}
    return out


def lockstep_frame(dev, card):
    """Phase 23 (b): scene 1 at 1200x675, depth 20, spp cut to 4, through
    ``render`` on both routes in the order graph, eager, graph, then one
    frame of each under ``torch.profiler``.  Returns its record."""
    world, cam = sc.random_spheres()
    data, meta = world.compile()
    cam = cam.replace(sqrt_spp=2)
    n_paths = cam.image_width * cam.image_height * cam.sqrt_spp ** 2

    def frame(eager):
        return render(data, meta, cam, seed=SEED, _eager=eager)

    runs = {False: [], True: []}
    for eager in (False, True, False):
        img, launches, counts, wall, peak, reserved = on_lockstep_route(
            frame, eager)
        runs[eager].append((img, launches, counts, wall, peak, reserved))
        log(f"lockstep routes scene1 {cam.image_width}x{cam.image_height} @ "
            f"{cam.sqrt_spp ** 2}spp depth {cam.bounce_limit}, "
            f"{'eager' if eager else 'graph'}: wall {wall:.3f} s, "
            f"{n_paths / wall:.1f} paths/s, peak allocated "
            f"{peak / 2 ** 30:.4f} GiB, reserved {reserved / 2 ** 30:.4f} "
            f"GiB, launches {launches}, lockstep graphs {counts} | {card}")
    first = runs[True][0]
    for img, launches, counts, _, _, _ in runs[False]:
        assert launches == first[1], "phase 23: the routes' launches differ"
        assert (counts["bounces"], counts["syncs"]) == (
            first[2]["bounces"], first[2]["syncs"])
        assert torch.equal(img.view(torch.int32),
                           first[0].view(torch.int32)), \
            "phase 23: scene 1's graph and eager images differ"
    assert bool(torch.isfinite(first[0]).all()), "non-finite pixels"
    assert runs[False][1][2]["captures"] == 0 < runs[False][1][2]["replays"]
    rec = {"config": f"{cam.image_width}x{cam.image_height} "
                     f"{cam.sqrt_spp ** 2}spp depth {cam.bounce_limit}",
           "bit_equal": True, "launches": first[1]["none"],
           "bounces": first[2]["bounces"], "host_reads": first[2]["syncs"]}
    for eager, key in ((False, "graph"), (True, "eager")):
        r = runs[eager]
        rec[key] = {"wall_s": [x[3] for x in r],
                    "paths_per_s": [n_paths / x[3] for x in r],
                    "captures": [x[2]["captures"] for x in r],
                    "replays": [x[2]["replays"] for x in r],
                    "capture_s": [x[2]["capture_s"] for x in r],
                    "peak_gib": [x[4] / 2 ** 30 for x in r],
                    "reserved_gib": [x[5] / 2 ** 30 for x in r]}
    del runs, first
    bounces = rec["bounces"]
    for eager, key in ((False, "graph"), (True, "eager")):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            _, _, _, p_wall, _, _ = on_lockstep_route(frame, eager)
        t0 = time.perf_counter()
        _, busy_us, n_kernels, _ = device_times(prof)
        summarise = time.perf_counter() - t0
        del prof
        assert busy_us > 0, f"lockstep {key}: the profiler saw no device time"
        # a replayed frame on the graph route (its second run)
        wall = rec[key]["wall_s"][0 if eager else 1]
        rec[key].update(busy_s=busy_us / 1e6,
                        idle_share=1 - busy_us / 1e6 / wall,
                        kernels=n_kernels,
                        kernels_per_bounce=n_kernels / bounces)
        log(f"lockstep routes scene1 profiled frame, {key}: device busy "
            f"{busy_us / 1e6:.4f} s, idle share {1 - busy_us / 1e6 / wall:.4f}"
            f" of the unprofiled wall {wall:.3f} s (profiled "
            f"{p_wall:.3f} s), {n_kernels} device kernels = "
            f"{n_kernels / bounces:.1f} a bounce step ({bounces} steps); "
            f"summarised in {summarise:.1f} s | {card}")
    g, e = rec["graph"], rec["eager"]
    log(f"lockstep routes scene1: wall graph "
        f"{', '.join(f'{w:.3f}' for w in g['wall_s'])} s (first call "
        f"capture {g['capture_s'][0]:.4f} s), eager {e['wall_s'][0]:.3f} s;"
        f" idle share graph {g['idle_share']:.4f}, eager "
        f"{e['idle_share']:.4f}; kernels a bounce step graph "
        f"{g['kernels_per_bounce']:.1f}, eager {e['kernels_per_bounce']:.1f};"
        f" {bounces} bounce steps, {rec['host_reads']} host reads, "
        f"{rec['launches']} none launches on both routes; images bit-equal"
        f" | {card}")
    return rec


def lockstep_graph_phase(dev, card):
    """Phase 23: the lockstep forward's CUDA graphs against its eager
    route.  Returns the ``{"lockstep_graph": ...}`` record: (a) the
    bit-equality set, (b) scene 1 at 1200x675, 4 spp, depth 20, and the
    lockstep counts of the main paths of phases 11 and 17."""
    t0 = time.perf_counter()
    rec = {"bit_equal": lockstep_routes_bit_equal(dev)}
    log(f"phase 23 (a) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rec["scene1"] = lockstep_frame(dev, card)
    log(f"phase 23 (b) took {time.perf_counter() - t0:.1f} s")
    rec["main_paths"] = dict(LOCK_GRAPHS)
    for name, counts in LOCK_GRAPHS.items():
        log(f"lockstep graphs of the main path {name}: {counts}")
    return rec


def precision_record(kern, rows_hits):
    """The card counterpart of tools/mosaic_check.py: TF32 off for matmuls
    and cuDNN, float32 matmul precision "highest", every kernel's largest
    error against its float32 plain version (0 for every forward mode),
    and the emitted rows equal to the joined table's rows on hit lanes (the
    one-hot gather's counterpart; checked in phase 4).  Fails the run if
    one of them is violated."""
    rec = {
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "float32_matmul_precision": torch.get_float32_matmul_precision(),
        "max_abs_err": {k: v["err"] for k, v in kern.items()},
        # phase 9: the backward's tables bit-equal to the plain mirror of
        # its order on every set, three launches bit-identical, and within
        # BWD_SUM_RTOL of each entry's sum of |terms| of the plain version
        "bwd_sum_rtol": BWD_SUM_RTOL,
        "bwd_bit_equal_ordered": kern["bwd"].pop("bit_equal_ordered"),
        "bwd_deterministic": kern["bwd"].pop("deterministic"),
        "rows_bit_equal_hit_lanes": rows_hits,
    }
    assert rec["matmul_allow_tf32"] is False, rec
    assert rec["cudnn_allow_tf32"] is False, rec
    assert rec["float32_matmul_precision"] == "highest", rec
    assert all(kern[k]["err"] == 0.0 for k in ("none", "cull", "bvh",
                                               "aaq")), rec
    assert rec["bwd_bit_equal_ordered"] is True, rec
    assert rec["bwd_deterministic"] is True, rec
    return rec


@contextlib.contextmanager
def counted_values():
    """Every ``metrics.count`` call meanwhile, in order, as (name, n), the
    counters counting as ever."""
    seen = []
    real = metrics.count

    def count(name, n=1):
        seen.append((name, n))
        real(name, n)
    metrics.count = count
    try:
        yield seen
    finally:
        metrics.count = real


def timed_pairs(seen, device, period):
    """(device ns, period ns) of each unit from ``counted_values``' calls,
    which count a unit's device time and then its period."""
    dev_ns = [n for k, n in seen if k == device]
    per_ns = [n for k, n in seen if k == period]
    assert len(dev_ns) == len(per_ns), (len(dev_ns), len(per_ns))
    return list(zip(dev_ns, per_ns))


def spans_phase(dev, card):
    """Phase 24 (the module docstring); returns the ``{"spans": ...}``
    record."""
    from mort_tpu_torch.interactive import view

    rec = {"card": card}
    # (a) the round graph's timing events, one layer of scene 1
    world1, cam1 = sc.random_spheres()
    data1, meta1 = world1.compile()
    cam = cam1.replace(sqrt_spp=2)

    def frame():
        return render_wavefront(data1, meta1, cam, dev, seed=SEED,
                                layer_range=(0, 1), return_stats=True)

    wf.drop_graph()
    on_route(frame, False)                 # the key's warm round, capture
    metrics.reset_spans()
    with counted_values() as seen:
        (g_img, g_stats), _, g_graphs, g_wall, _ = on_route(frame, False)
    totals = metrics.span_totals()
    (e_img, e_stats), _, _, _, _ = on_route(frame, True)
    pairs = timed_pairs(seen, "wavefront.round_device_ns",
                        "wavefront.round_period_ns")
    reads = metrics.total_of(totals, "wavefront.read").count
    launches = metrics.total_of(totals, "wavefront.launch").count
    equal = bool(torch.equal(g_img.view(torch.int32),
                             e_img.view(torch.int32)))
    assert equal and g_stats == e_stats, "phase 24: the routes' images differ"
    assert len(pairs) == launches == g_graphs["replays"] \
        == g_stats["iterations"] > 0, (len(pairs), launches, g_graphs)
    assert reads == g_graphs["rounds"] + g_graphs["spans"], (reads, g_graphs)
    assert all(0 < d <= p for d, p in pairs), pairs
    rec["rounds"] = {
        "config": "scene1 1200x675 4spp depth 20, layer 0",
        "rounds": len(pairs), "wall_s": g_wall, "bit_equal": equal,
        "device_ms": [d / 1e6 for d, _ in pairs],
        "period_ms": [p / 1e6 for _, p in pairs],
        "launch_ms": metrics.total_of(totals, "wavefront.launch").ns
        / launches / 1e6}
    gap = 1 - sum(d for d, _ in pairs) / sum(p for _, p in pairs)
    log(f"spans (a) scene1 1200x675 @ 4spp depth 20, one layer: "
        f"{len(pairs)} replayed rounds, device ms a round "
        f"{statistics.median(rec['rounds']['device_ms']):.4f} (median), "
        f"period ms {statistics.median(rec['rounds']['period_ms']):.4f}, "
        f"every round 0 < device <= period, round gap {100 * gap:.3f}%, "
        f"launch {rec['rounds']['launch_ms']:.4f} ms; image bit-equal to "
        f"the eager route {equal} | {card}")

    # (b) the step graph's timing events, phase 10's config
    cam = cam1.replace(image_width=GRAD_W, image_height=GRAD_H, sqrt_spp=2,
                       bounce_limit=8)
    target = np.zeros((GRAD_H, GRAD_W, 3), np.float32)
    graph, eager = make_train_step(meta1), make_train_step(meta1,
                                                           _eager=True)
    float(graph(data1, cam, target, GRAD_SEEDS[0])[0])
    metrics.reset_spans()
    got = {}
    with counted_values() as seen:
        for seed in GRAD_SEEDS[1:] + (GRAD_SEEDS[0],):
            got[seed] = graph(data1, cam, target, seed)
            float(got[seed][0])
    steps = timed_pairs(seen, "train.step_device_ns", "train.step_period_ns")
    counts = metrics.counters()
    step_total = metrics.total_of(metrics.span_totals(), "train.step")
    assert len(steps) == len(GRAD_SEEDS) - 1, steps
    assert not counts.get("train.step_device_unread"), counts
    assert all(0 < d <= p for d, p in steps), steps
    want = {s: eager(data1, cam, target, s) for s in GRAD_SEEDS[1:]}
    deterministic = same_bits(eager(data1, cam, target, GRAD_SEEDS[1]),
                              want[GRAD_SEEDS[1]])
    equal = all(same_bits(got[s], want[s]) for s in want)
    if deterministic:
        assert equal, "phase 24: the step routes differ"
    for s in want:
        (g_loss, g_grads), (e_loss, e_grads) = got[s], want[s]
        torch.testing.assert_close(g_loss, e_loss, rtol=1e-4, atol=0.0)
        scale = max(float(g.abs().max()) for g in e_grads.values())
        for k, g in g_grads.items():
            torch.testing.assert_close(g, e_grads[k], rtol=1e-3,
                                       atol=1e-5 * scale)
    rec["steps"] = {
        "config": f"scene1 {GRAD_W}x{GRAD_H} 4spp depth 8",
        "device_ms": [d / 1e6 for d, _ in steps],
        "period_ms": [p / 1e6 for _, p in steps],
        "bit_equal": equal, "eager_deterministic": deterministic,
        "step_host_ms": step_total.ns / step_total.count / 1e6}
    log(f"spans (b) train step scene1 {GRAD_W}x{GRAD_H} @ 4spp depth 8: "
        f"{len(steps)} read replays, device ms "
        f"{', '.join(f'{x:.3f}' for x in rec['steps']['device_ms'])}, "
        f"period ms "
        f"{', '.join(f'{x:.3f}' for x in rec['steps']['period_ms'])}, host "
        f"ms a step {rec['steps']['step_host_ms']:.3f}; bit-equal to the "
        f"eager route {equal} (two eager steps bit-equal {deterministic}) "
        f"| {card}")

    # (c) one viewer call under metrics.trace, scene 1's preview
    cam = cam1
    view(data1, meta1, cam, [("frame",), ("key", "w"), ("frame",),
                             ("frame",)], seed=SEED, preview_spt=1,
         device=dev, log=io.StringIO())
    torch.cuda.synchronize()
    d = os.path.join(out_dir(), "spans_trace")
    events = [("key", "a")] + [("frame",)] * 8
    t0 = time.perf_counter()
    with metrics.trace(d) as prof:
        view(data1, meta1, cam, events, seed=SEED, preview_spt=1,
             device=dev, log=io.StringIO())
    wall = time.perf_counter() - t0
    mirrored = sum(1 for e in prof.profiler.kineto_results.events()
                   if e.device_type() != DeviceType.CPU
                   and SPAN_NAME.match(e.name()))
    idle, long = idle_by_span(prof)
    with open(os.path.join(d, "trace.json")) as f:
        trace = json.load(f)
    names = {}
    for e in trace.get("traceEvents", []):
        if SPAN_NAME.match(str(e.get("name", ""))):
            names[e["name"]] = names.get(e["name"], 0) + 1
    assert mirrored == 0, f"phase 24: {mirrored} device events of spans"
    for name in ("viewer.frame", "viewer.copy_out", "viewer.finish",
                 "wavefront.call", "wavefront.read", "wavefront.launch"):
        assert names.get(name), f"phase 24: no {name} in trace.json"
    rec["viewer_trace"] = {
        "events": "a camera event and 8 one-sample frames, scene1 "
                  "1200x675 depth 20", "wall_s": wall,
        "idle_s_by_span": idle, "spans_in_trace": names,
        "gaps_over_1ms": [{"ms": n / 1e6, "spans": {k: v / 1e6
                                                    for k, v in p.items()}}
                          for _, n, p in long]}
    log(f"spans (c) one viewer call under metrics.trace (wall {wall:.3f} "
        f"s): device idle s by innermost span "
        + ", ".join(f"{k} {v:.6f}" for k, v in
                    sorted(idle.items(), key=lambda kv: -kv[1]))
        + f"; {len(long)} gaps over 1 ms; span events in trace.json "
        f"{names} | {card}")
    for g in rec["viewer_trace"]["gaps_over_1ms"]:
        log(f"  gap {g['ms']:.3f} ms: " + ", ".join(
            f"{k} {v:.3f}" for k, v in g["spans"].items()))
    assert not any(OUTSIDE in p for _, _, p in long), \
        "phase 24: a device gap over 1 ms outside the viewer's spans"

    # (d) the recorder's cost on this host
    rec["span_ns"] = span_cost()
    log(f"spans (d) ns a span on this host: {rec['span_ns']}")
    return rec


def span_cost(n=100_000):
    """ns a ``metrics.span`` takes on this host, recorded (no profiler)
    and forwarded (under a CPU profiler), each over ``n`` spans."""
    out = {}
    for mode in ("recorded", "forwarded"):
        prof = (torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU])
            if mode == "forwarded" else contextlib.nullcontext())
        with prof:
            t0 = time.perf_counter_ns()
            for _ in range(n):
                with metrics.span("cost.span"):
                    pass
            out[mode] = (time.perf_counter_ns() - t0) / n
    metrics.reset_spans()
    return out


PHILOX_R = (1 << 18, 1 << 16, GRAD_W * GRAD_H)   # scene 1, 9, fit lanes
# bytes a lane of a draw whose pixel, sample and bounce are int64 lane
# tensors: three words read, four float32 written
PHILOX_LANE_BYTES = 3 * 8 + 4 * 4


def philox_lanes(R, dev, seed=0):
    """Pixel, sample and bounce lane words at R lanes, the first ones at
    the edges of the u32 range and beyond it (a word is its low 32 bits).
    Phase 3's lanes and tests/test_torch_cuda.py's."""
    g = np.random.RandomState(seed)
    edge = np.array([0, 1, 2 ** 32 - 1, 2 ** 32 - 2, -1, -7, 2 ** 32,
                     2 ** 33 + 5, 2 ** 62, -2 ** 63, 2 ** 63 - 1], np.int64)
    pix = g.randint(0, 1 << 31, R, dtype=np.int64)
    smp = g.randint(0, 1 << 12, R, dtype=np.int64)
    pix[:len(edge)], smp[:len(edge)] = edge, edge[::-1]
    bnc = g.randint(1, 50, R, dtype=np.int64)
    return tuple(torch.from_numpy(x).to(dev) for x in (pix, smp, bnc))


def _host_us(fn, reps=400, warmup=20):
    """Median host microseconds of ``fn()`` by ``perf_counter_ns``, the
    card left to run what it queues."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter_ns()
        fn()
        times.append(time.perf_counter_ns() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) / 1e3


def philox_host_parts(dev, R=PHILOX_R[0]):
    """The host time of one ``rng.uniform4`` call on scene 1's lane words
    (three int64 lane tensors, a device seed, an int slot), part by part,
    each timed alone on the call's own operands: the operands' sorting
    (``rng._operand``), the output's allocation, the device context and
    stream, the ctypes call, the rows' views; "rest" is the call less the
    parts.  Beside it, CUDA events around the bare ctypes call (the
    ``ms`` of one call with no Python wrapper).  Returns the record (us)."""
    pix, smp, bnc = philox_lanes(R, dev, seed=R)
    key = torch.tensor([SEED], device=dev)
    words = [rng._operand(x, (R,)) for x in (pix, smp, bnc, 1)]
    out = torch.empty((4, R), dtype=torch.float32, device=dev)
    base = out.data_ptr()
    lib = _build.load_library("philox")
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = [a for value, t, stride in words
            for a in (None if t is None else t.data_ptr(), value, stride)]
    args += [key.data_ptr(), 0, rng.SEED2, R,
             *(base + 4 * R * k for k in range(4)), stream]

    def device_and_stream():
        with torch.cuda.device(dev):
            return torch.cuda.current_stream(dev).cuda_stream

    parts = {
        "operands": lambda: ([rng._operand(x, (R,))
                              for x in (pix, smp, bnc, 1)],
                             rng._operand(key, ())),
        "empty": lambda: torch.empty((4, R), dtype=torch.float32,
                                     device=dev),
        "device_and_stream": device_and_stream,
        "ctypes_call": lambda: lib.mort_philox_uniform4(*args),
        "views": lambda: out.view(4, R).unbind(0),
    }
    rec = {"R": R, "call": _host_us(
        functools.partial(rng.uniform4, key, pix, smp, bnc, 1))}
    rec.update({k: _host_us(fn) for k, fn in parts.items()})
    rec["rest"] = rec["call"] - sum(rec[k] for k in parts)
    rec["bare_call_event_us"] = 1e3 * time_ms(
        lambda: lib.mort_philox_uniform4(*args))
    rec["call_event_us"] = 1e3 * time_ms(
        functools.partial(rng.uniform4, key, pix, smp, bnc, 1))
    log("philox host us a call (R=%d): %s" % (R, ", ".join(
        f"{k} {v:.2f}" for k, v in rec.items() if k != "R")))
    return rec


def philox_kernels_a_call(dev, R=PHILOX_R[0]):
    """Device kernels one draw dispatches on each route, under
    ``torch.profiler``, with each caller's operands: the wavefront's
    shading draw (pixel, sample and bounce lane tensors), the lockstep's
    (its bounce a 0-dim device tensor), the camera's (bounce 0), each with
    a device seed.  Returns {route: {caller: kernels}}."""
    pix, smp, bnc = philox_lanes(R, dev, seed=R)
    key = torch.tensor([SEED], device=dev)
    callers = {"shading": (pix, smp, 1 + bnc, rng.SLOT_MAT_DIR),
               "lockstep": (pix, smp,
                            1 + torch.tensor(3, device=dev),
                            rng.SLOT_MAT_DIR),
               "camera": (pix, smp, 0, rng.SLOT_CAM_PIXEL)}
    rec = {}
    for route, fn in (("plain", rng.uniform4_plain),
                      ("kernel", rng.uniform4)):
        rec[route] = {}
        for caller, words in callers.items():
            fn(key, *words)
            torch.cuda.synchronize()
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                fn(key, *words)
                torch.cuda.synchronize()
            rec[route][caller] = device_times(prof)[2]
    log(f"philox device kernels a draw (torch.profiler, R={R}): {rec}")
    assert all(n == 1 for n in rec["kernel"].values()), rec
    return rec


def philox_phase(dev, card):
    """Phase 3: the Philox kernel's build, the pinned vector, the kernel
    bit-equal to the plain version on CPU copies of its operands (the seed
    an int and a device tensor, the bounce an int, a 0-dim tensor and a
    lane tensor, slots 0-8), its time one call and back to back at the
    pools' lane counts beside its bound and the plain version's on the
    card, the wrapper's host parts (``philox_host_parts``), the device
    kernels a draw on each route (``philox_kernels_a_call``), and
    ``rng.launch_count`` after one scene-1 frame at its bench config and
    one train step at phase 10's config.  Returns the record."""
    t0 = time.perf_counter()
    built = _build.library_path("philox").exists()
    _build.load_library("philox")
    log(f"build: philox {'loaded from cache' if built else 'compiled'} in "
        f"{time.perf_counter() - t0:.2f} s")
    for line in ptxas_report("philox"):
        log(f"ptxas {line}")
    u = rng.uniform4(SEED, torch.tensor([123], device=dev),
                     torch.tensor([4], device=dev), 2, 1)
    got = [float(x[0]) for x in u]
    want = [0.7667282223701477, 0.9874579310417175,
            0.48183852434158325, 0.6557576656341553]
    assert got == want, f"philox on the card: {got} != {want}"
    log(f"philox: pinned vector reproduced bit for bit on {dev}")

    pix, smp, bnc = philox_lanes(PHILOX_R[0], dev)
    seeds = (2 ** 31 + 977, torch.tensor([-12345], device=dev))
    bounces = (3, torch.tensor(6, device=dev), bnc)
    before = dict(rng.launch_count)
    cases = 0
    for seed in seeds:
        for bounce in bounces:
            for slot in range(9):
                got = rng.uniform4(seed, pix, smp, bounce, slot)
                cpu = [x.cpu() if isinstance(x, torch.Tensor) else x
                       for x in (seed, pix, smp, bounce)]
                want = rng.uniform4_plain(*cpu, slot)
                for g, w in zip(got, want):
                    assert torch.equal(g.cpu().view(torch.int32),
                                       w.view(torch.int32)), (seed, slot)
                cases += 1
    moved = {k: rng.launch_count[k] - before[k] for k in before}
    assert moved == {"kernel": cases, "plain": 0}, moved
    log(f"philox kernel: bit-equal to the plain version on CPU copies in "
        f"{cases} cases of {PHILOX_R[0]} lanes (seed int and device tensor; "
        f"bounce int, 0-dim and lanes; slots 0-8)")

    rec = {"card": card, "times": []}
    for R in PHILOX_R:
        pix, smp, bnc = philox_lanes(R, dev, seed=R)
        key = torch.tensor([SEED], device=dev)
        kern = functools.partial(rng.uniform4, key, pix, smp, bnc, 1)
        plain = functools.partial(rng.uniform4_plain, key, pix, smp, bnc, 1)
        row = {"R": R, "ms": time_ms(kern),
               "ms_back_to_back": time_ms(kern, calls=10),
               "plain_ms": time_ms(plain),
               "plain_ms_back_to_back": time_ms(plain, calls=10),
               "bound_ms": R * PHILOX_LANE_BYTES / HBM_BYTES_PER_S * 1e3}
        row["roofline"] = row["bound_ms"] / row["ms_back_to_back"]
        rec["times"].append(row)
        log(f"philox R={R}: kernel one call {row['ms'] * 1e3:.2f} us, back "
            f"to back {row['ms_back_to_back'] * 1e3:.2f} us, bound "
            f"{row['bound_ms'] * 1e3:.2f} us (bytes, "
            f"{PHILOX_LANE_BYTES} B a lane; {100 * row['roofline']:.1f}% of "
            f"it); plain one call {row['plain_ms'] * 1e3:.1f} us, back to "
            f"back {row['plain_ms_back_to_back'] * 1e3:.1f} us | {card}")

    rec["host_us"] = philox_host_parts(dev)
    rec["kernels_a_call"] = philox_kernels_a_call(dev)

    world, cam = sc.random_spheres()
    data, meta = world.compile()
    before = dict(rng.launch_count)
    render_wavefront(data, meta, cam, dev, seed=SEED)
    torch.cuda.synchronize()
    frame = {k: rng.launch_count[k] - before[k] for k in before}
    wf.drop_graph()   # phase 5 renders this key from its first round
    cam = cam.replace(image_width=GRAD_W, image_height=GRAD_H, sqrt_spp=2,
                      bounce_limit=8)
    target = np.zeros((GRAD_H, GRAD_W, 3), np.float32)
    before = dict(rng.launch_count)
    loss, _ = make_train_step(meta)(data, cam, target, SEED)
    float(loss)
    step = {k: rng.launch_count[k] - before[k] for k in before}
    assert frame["plain"] == step["plain"] == 0, (frame, step)
    assert frame["kernel"] > 0 and step["kernel"] > 0, (frame, step)
    rec["launch_count"] = {"frame": frame, "step": step}
    log(f"philox rng.launch_count: scene-1 frame {frame} (its key's eager "
        f"round and capture; replays launch without a call), first train "
        f"step {step} (eager, its checkpoint recompute and the capture), "
        f"total {rng.launch_count}")
    return rec


# scene 9's pool and scene 1's: the lanes the noise kernel is timed at
NOISE_R = (1 << 16, 1 << 18)
# operations a noise lane costs in csrc/noise.cu whatever the data: an
# octave's floors, fractions and twice-smoothed weights (30), lattice
# products (9), the corners' six distinct weights (24), eight coefficients
# (12), six offsets (6), eight hashes (60: two xors and the avalanche's
# six), eight gradient dots (112) and their weighted sums (16), the
# octave's weight and doubling (6): 275, seven octaves; then the lane's
# scale, turbulence's abs, the marble and its sinf (~50)
NOISE_LANE_OPS = 7 * 275 + 50
# the rate those operations issue at: one instruction a float32 lane a
# clock (128 lanes an SM, 132 SMs, 1.98 GHz), half FP32_OPS_PER_S, which
# counts an FMA as two and the kernel has none; its u32 multiplies and
# logic issue at half this rate again, so the bound is still a low one
NOISE_OPS_PER_S = FP32_OPS_PER_S / 2
# bytes a lane moves: its texture row (8), point (12), colour in and out
# (24); the texture table, a few entries, stays in cache
NOISE_LANE_BYTES = 8 + 12 + 24
NOISE_SCALES = (0.5, 40.0, 900.0)


def noise_lattice(n, seed=0):
    """Random int32 lattice points, negative ones and the int32 extremes
    included: phase 25's and ``tests/test_torch_textures.py``'s."""
    g = np.random.RandomState(seed)
    edge = np.array([[0, 0, 0], [-1, -1, -1], [2 ** 31 - 1, -2 ** 31, 1],
                     [-2 ** 31, 2 ** 31 - 1, -1], [1, -1, 0], [-7, 3, -11]])
    ijk = g.randint(-2 ** 31, 2 ** 31 - 1, size=(n, 3), dtype=np.int64)
    ijk[: n // 2] = g.randint(-300, 300, size=(n // 2, 3))
    ijk[:len(edge)] = edge[:n]
    return ijk.astype(np.int32)


def noise_lanes(R, dev, data, row, scale, seed=0):
    """(tid, p, out) of R lanes on texture row ``row`` (a noise texture):
    points whose scaled point s = scale_row * p lies at ``scale`` (normal,
    that standard deviation) or, for "lattice", on ``noise_lattice``'s
    points plus a fraction; random colours.  Phase 25's lanes and
    tests/test_torch_cuda.py's."""
    g = np.random.RandomState(seed)
    if scale == "lattice":
        s = noise_lattice(R, seed).astype(np.float64) + g.uniform(
            0, 1, (R, 3))
    else:
        s = g.randn(R, 3) * scale
    p = s / float(data.tex_noise_scale[row])
    tid = torch.full((R,), row, dtype=torch.int64, device=dev)
    return (tid, torch.from_numpy(p.astype(np.float32)).to(dev),
            torch.from_numpy(g.rand(R, 3).astype(np.float32)).to(dev))


def noise_off(got, want):
    """(lanes whose bits differ, largest |difference|) of two results; a
    NaN against a number differs by inf."""
    got, want = got.cpu(), want.cpu()
    same = (got.view(torch.int32) == want.view(torch.int32)) | (
        got.isnan() & want.isnan())
    diff = torch.where(same, 0.0, (got - want).abs().nan_to_num(
        nan=float("inf")))
    return (int((~same.all(-1)).sum()),
            float(diff.max()) if diff.numel() else 0.0)


def noise_rows(meta, R, dev, seed=0):
    """(tid, u, v, p) of R lanes on every texture row of a scene, at
    points spread over +-300."""
    g = np.random.RandomState(seed)
    return tuple(torch.from_numpy(x).to(dev) for x in (
        g.randint(0, len(meta.tex_kind), R).astype(np.int32),
        g.uniform(-0.1, 1.1, R).astype(np.float32),
        g.uniform(-0.1, 1.1, R).astype(np.float32),
        (g.randn(R, 3) * 300.0).astype(np.float32)))


def texture_by(route, data, meta, tid, u, v, p):
    """``texture_value`` by the kernel's route (no gradient recorded) or by
    the plain route (``textures._card`` taken as False for the call), on
    the same card operands."""
    if route == "kernel":
        with torch.no_grad():
            return ttx.texture_value(data, meta, tid, u, v, p)
    card = ttx._card
    ttx._card = lambda t: False
    try:
        return ttx.texture_value(data, meta, tid, u, v, p)
    finally:
        ttx._card = card


def noise_kernels_a_call():
    """Device kernels one call dispatches on each route
    (``torch.profiler``): ``marble_plain`` and ``marble_kernel`` at
    R_SCENE9 lanes on scene 9's noise row, ``texture_value`` on scene 9's
    rows.  Phase 25 runs it in a process of its own."""
    dev = require_cuda()
    world9, _ = sc.final_scene(400, 250, 4)
    cpu9, meta9 = world9.compile()
    data9 = cpu9.to(dev)
    kind9 = torch.tensor(meta9.tex_kind, dtype=torch.int32, device=dev)
    row9 = list(meta9.tex_kind).index(TEX_NOISE)
    tid, p, out = noise_lanes(R_SCENE9, dev, data9, row9, 40.0)
    lanes = noise_rows(meta9, R_SCENE9, dev, 9)
    calls = {"marble.plain": functools.partial(
        ttx.marble_plain, data9, kind9[tid], tid, p, out,
        int(cpu9.tex_image_id[row9])),
        "marble.kernel": functools.partial(ttx.marble_kernel, data9, kind9,
                                           tid, p, out)}
    for route in ("plain", "kernel"):
        calls[f"texture_value.{route}"] = functools.partial(
            texture_by, route, data9, meta9, *lanes)
    rec = {}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rec[name] = device_times(prof)[2]
    return rec


def noise_phase(dev, card):
    """Phase 25: the noise kernel's build; the kernel against the plain
    route on the card (``marble_plain`` on the same card operands) on
    scene 9's noise row at the lattice extremes and at scales 0.5, 40 and
    900, and against the CPU's plain route; ``texture_value`` on every
    texture row of scenes 4 and 9 on both routes; its time one call and
    back to back at NOISE_R lanes beside its bound and the plain route's;
    the device kernels one call dispatches on each route
    (``noise_kernels_a_call``, in a process of its own);
    ``textures.launch_count`` after one scene-9 frame at its bench config
    from a new graph key.  Returns the record."""
    t0 = time.perf_counter()
    built = _build.library_path("noise").exists()
    _build.load_library("noise")
    log(f"build: noise {'loaded from cache' if built else 'compiled'} in "
        f"{time.perf_counter() - t0:.2f} s")
    for line in ptxas_report("noise"):
        log(f"ptxas {line}")
    world9, cam9 = sc.final_scene(400, 250, 4)
    cpu9, meta9 = world9.compile()
    data9 = cpu9.to(dev)
    kind9 = torch.tensor(meta9.tex_kind, dtype=torch.int32, device=dev)
    row9 = list(meta9.tex_kind).index(TEX_NOISE)
    nid9 = int(cpu9.tex_image_id[row9])

    rec = {"card": card, "marble": {}, "texture_value": {}, "times": []}
    before = dict(ttx.launch_count)
    for scale in ("lattice",) + NOISE_SCALES:
        tid, p, out = noise_lanes(R_SCENE9, dev, data9, row9, scale)
        got = ttx.marble_kernel(data9, kind9, tid, p, out)
        want = ttx.marble_plain(data9, kind9[tid], tid, p, out, nid9)
        cpu = ttx.marble_plain(cpu9, kind9.cpu()[tid.cpu()], tid.cpu(),
                               p.cpu(), out.cpu(), nid9)
        rec["marble"][str(scale)] = {"card_plain": noise_off(got, want),
                                     "cpu_plain": noise_off(got, cpu)}
    for idx in (4, 9):
        world, _ = sc.build_scene(idx) if idx != 9 else (world9, None)
        data, meta = world.compile()
        data = data.to(dev)
        lanes = noise_rows(meta, R_SCENE9, dev, idx)
        got, want = (texture_by(route, data, meta, *lanes)
                     for route in ("kernel", "plain"))
        rec["texture_value"][f"scene{idx}"] = noise_off(got, want)
    moved = {k: ttx.launch_count[k] - before[k] for k in before}
    assert moved == {"kernel": 6, "plain": 2}, moved
    off = [r["card_plain"] for r in rec["marble"].values()]
    off += list(rec["texture_value"].values())
    rec["bit_equal"] = all(n == 0 for n, _ in off)
    rec["max_abs_err"] = max(err for _, err in off)
    log(f"noise kernel against the plain route on the card (lanes off, "
        f"max |diff|): {json.dumps(rec['marble'])}, texture_value "
        f"{json.dumps(rec['texture_value'])}; bit-equal "
        f"{rec['bit_equal']}")
    # the kernel is held to the bits the card has shown (its sinf and
    # floorf are torch's), and within the texture tests' 1e-6 besides
    assert rec["bit_equal"] and rec["max_abs_err"] <= 1e-6, rec

    for R in NOISE_R:
        tid, p, out = noise_lanes(R, dev, data9, row9, 40.0, seed=R)
        kinds = kind9[tid]
        kern = functools.partial(ttx.marble_kernel, data9, kind9, tid, p,
                                 out)
        plain = functools.partial(ttx.marble_plain, data9, kinds, tid, p,
                                  out, nid9)
        ops_ms = R * NOISE_LANE_OPS / NOISE_OPS_PER_S * 1e3
        bytes_ms = R * NOISE_LANE_BYTES / HBM_BYTES_PER_S * 1e3
        row = {"R": R, "ms": time_ms(kern),
               "ms_back_to_back": time_ms(kern, calls=10),
               "plain_ms": time_ms(plain, reps=5),
               "plain_ms_back_to_back": time_ms(plain, reps=3, calls=10),
               "bound_ms": max(ops_ms, bytes_ms),
               "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}
        row["roofline"] = row["bound_ms"] / row["ms_back_to_back"]
        rec["times"].append(row)
        log(f"noise R={R} (every lane on the noise row): kernel one call "
            f"{row['ms'] * 1e3:.2f} us, back to back "
            f"{row['ms_back_to_back'] * 1e3:.2f} us, bound "
            f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}, "
            f"{NOISE_LANE_OPS} operations and {NOISE_LANE_BYTES} B a lane; "
            f"{100 * row['roofline']:.1f}% of it); plain one call "
            f"{row['plain_ms']:.3f} ms, back to back "
            f"{row['plain_ms_back_to_back']:.3f} ms | {card}")

    # in a new process: after phases 1-24 the profiler loses some of a
    # session's device events on the H100, a lone kernel's included; a new
    # process loses none
    res = subprocess.run(
        [sys.executable, "-c", "import json, chip_smoke as c; "
         "print(json.dumps(c.noise_kernels_a_call()))"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=600)
    if res.returncode:
        raise RuntimeError(f"phase 25: noise_kernels_a_call failed:\n"
                           f"{res.stderr[-4000:]}")
    rec["kernels_a_call"] = json.loads(res.stdout.strip().splitlines()[-1])
    log(f"noise device kernels a call (torch.profiler, R={R_SCENE9}; "
        f"texture_value on scene 9's rows): {rec['kernels_a_call']}")
    assert rec["kernels_a_call"]["marble.kernel"] == 1, rec

    wf.drop_graph()   # a new key: its eager round and capture call
    counts = dict(wf.graph_count)
    before = dict(ttx.launch_count)
    t0 = time.perf_counter()
    render_wavefront(data9, meta9, cam9, dev, seed=SEED)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    frame = {k: ttx.launch_count[k] - before[k] for k in before}
    graphs = {k: wf.graph_count[k] - counts[k] for k in counts}
    assert frame["plain"] == 0 and frame["kernel"] > 0, frame
    rec["launch_count"] = {"frame": frame, "graph_count": graphs,
                           "wall_s": wall}
    log(f"noise textures.launch_count: scene-9 frame {frame} (its key's "
        f"eager round and capture; replays launch without a call), graph "
        f"counts {graphs}, wall {wall:.2f} s (with the capture), total "
        f"{ttx.launch_count}")
    return rec


def phase_done(n, t_phase, t_start):
    """Logs phase ``n``'s seconds; returns the clock for the next phase."""
    now = time.perf_counter()
    log(f"phase {n} took {now - t_phase:.1f} s, done at "
        f"{now - t_start:.1f} s")
    return now


def main():
    t_start = t_phase = time.perf_counter()
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
    t_phase = phase_done(1, t_phase, t_start)

    # ---- 2. build ----
    t0 = time.perf_counter()
    built = _build.library_path("closest_hit").exists()
    _build.load_library("closest_hit")
    build_s = time.perf_counter() - t0
    log(f"build: closest_hit {'loaded from cache' if built else 'compiled'}"
        f" in {build_s:.2f} s -> {_build.library_path('closest_hit')}")
    for line in ptxas_report("closest_hit"):
        log(f"ptxas {line}")
    atomics = float_atomics("closest_hit")
    assert len(atomics) == 6 and not any(atomics.values()), atomics
    log(f"sass: no float atomic in the backward's kernels "
        f"({', '.join(atomics)})")
    atomics = float_atomics("closest_hit", "closest_hit_cull_")
    assert len(atomics) == 8 and not any(atomics.values()), atomics
    log(f"sass: no float atomic in the \"cull\" kernels "
        f"({', '.join(atomics)})")
    for kernel in ("closest_hit_none_kernel<false",
                   "closest_hit_bvh_kernel<false",
                   "closest_hit_cull_test_kernel<false"):
        for (label, part), counts in sass_mix("closest_hit", kernel).items():
            log(f"sass {label} {part}: " + ", ".join(
                f"{k} {v}" for k, v in counts.items() if v))
    t_phase = phase_done(2, t_phase, t_start)

    # ---- 3. philox ----
    philox = philox_phase(dev, card)
    t_phase = phase_done(3, t_phase, t_start)

    # ---- 4. every mode vs the plain version, and timings ----
    kern, sets = parity_and_timing(dev, card)
    t_phase = phase_done(4, t_phase, t_start)

    # ---- 5. main path: scene 1 at its bench config ----
    world1, cam1 = sc.random_spheres()
    counts1, img1, wall1, _ = main_path("scene1", world1, cam1, dev, card)
    img1 = img1.cpu().numpy()
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
    t_phase = phase_done(5, t_phase, t_start)

    # ---- 6. main path: scene 9 at its code-true config ----
    world9, cam9 = sc.final_scene(400, 250, 4)
    counts9 = main_path("scene9", world9, cam9, dev, card)[0]
    assert counts9["none"] > 0, "scene 9's auto accel should be none"
    t_phase = phase_done(6, t_phase, t_start)

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
    t_phase = phase_done(7, t_phase, t_start)

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
                          profiled=True)[0]
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
    t_phase = phase_done(8, t_phase, t_start)

    # ---- 9. the backward kernel vs its plain version, and timings ----
    kern["bwd"] = backward_parity_and_timing(dev, card, sets)
    del sets
    t_phase = phase_done(9, t_phase, t_start)

    # ---- 10. main path: the scene-1 train step ----
    counts10, wall10 = train_step_main_path(dev, card)
    t_phase = phase_done(10, t_phase, t_start)

    # ---- 11. the lockstep render on the card ----
    lockstep_render(dev)
    t_phase = phase_done(11, t_phase, t_start)

    # ---- 12. the Cornell train step, card against CPU ----
    train_step_card_vs_cpu(dev)
    t_phase = phase_done(12, t_phase, t_start)

    # ---- 13. main path: the CLI, scene 5 at its code-true config ----
    counts13 = cli_main_path(dev, card, kern["aaq"])
    t_phase = phase_done(13, t_phase, t_start)

    # ---- 14. main path: progressive checkpoint/resume, scene 6 ----
    counts14 = progressive_main_path(dev, card)
    t_phase = phase_done(14, t_phase, t_start)

    # ---- 15. the viewer ----
    viewer_path(dev)
    t_phase = phase_done(15, t_phase, t_start)

    # ---- 16. main path, forced "cull": scene 9 at 400x400, 16 spp ----
    cam9c = cam9.replace(sqrt_spp=4)
    WH = cam9c.image_width * cam9c.image_height
    runs = {}
    # none, cull, cull, none: each mode once before and once after the
    # other, so that the order of the runs cancels from the comparison; the
    # second "cull" run is profiled over WH tasks from WH / 2 (the second
    # half of layer 0 and the first of layer 1: every pixel once, and more
    # than the 2^16-lane pool holds).  The span program is kept by key, so
    # the second "cull" run replays the first's capture; a fifth run, none
    # again, does the same for "none"
    for k, mode in enumerate((None, "cull", "cull", None, None)):
        runs.setdefault(mode, []).append(main_path(
            "scene9 16spp" + (" accel=cull" if mode else ""), world9, cam9c,
            dev, card, accel=mode, profiled=k == 2,
            profile_tasks=(WH // 2, WH // 2 + WH)))
    counts9c, counts9n = runs["cull"][0][0], runs[None][0][0]
    assert counts9c["cull"] > 0 and counts9c["none"] == counts9c["bvh"] == 0
    assert counts9n["cull"] == 0 and counts9n["none"] > 0
    assert runs["cull"][1][0] == counts9c
    assert runs[None][1][0] == runs[None][2][0] == counts9n
    captures = {m: [g["captures"] for *_, g in runs[m]] for m in runs}
    assert captures == {None: [1, 1, 0], "cull": [1, 0]}, captures
    # both modes give the plain scan's hits bit for bit and the rest of the
    # render is the same; a pixel deposits at most once a round (a task
    # lives at most 8 samples x 5 segments = 5 rounds, and its pixel's next
    # task comes WH tasks later), so index_add_ adds in one order
    imgs = [img for mode in (None, "cull") for _, img, _, _ in runs[mode]]
    diff = max(float((img - imgs[0]).abs().max()) for img in imgs[1:])
    walls = {m: [r[2] for r in runs[m]] for m in runs}
    log(f"phase 16 none / cull walls (s), in run order none, cull, cull, "
        f"none, none: {walls[None][0]:.3f}, {walls['cull'][0]:.3f}, "
        f"{walls['cull'][1]:.3f}, {walls[None][1]:.3f}, "
        f"{walls[None][2]:.3f} (span captures 1, 1, 0, 1, 0: the third "
        f"and fifth replay the key kept from the run before); with the "
        f"capture none {statistics.mean(walls[None][:2]):.3f}, cull "
        f"{walls['cull'][0]:.3f}; kept key none {walls[None][2]:.3f}, cull "
        f"{walls['cull'][1]:.3f}; five images bit-equal "
        f"{all(torch.equal(img, imgs[0]) for img in imgs[1:])} (max |diff| "
        f"{diff:.3e}) | {card}")
    assert all(torch.equal(img, imgs[0]) for img in imgs[1:]), \
        "phase 16: the none and cull renders differ"
    del runs, imgs
    t_phase = phase_done(16, t_phase, t_start)

    # ---- 17. the sharded paths and the host BVH builder ----
    sharding = sharded_paths(dev, card, img1, wall1, wall10)
    t_phase = phase_done(17, t_phase, t_start)

    # ---- 18-20. the parity gate, config #5 and the bench entry ----
    tools = tool_phases(dev, card, t_start)
    t_phase = time.perf_counter()

    # ---- 21. the spans' CUDA graphs against the eager rounds ----
    span_graph = span_graph_phase(dev, card)
    t_phase = phase_done(21, t_phase, t_start)

    # ---- 22. the train step's CUDA graph against the eager step ----
    step_graph = step_graph_phase(dev, card)
    t_phase = phase_done(22, t_phase, t_start)

    # ---- 23. the lockstep forward's CUDA graphs against its eager route
    lockstep_graph = lockstep_graph_phase(dev, card)
    t_phase = phase_done(23, t_phase, t_start)

    # ---- 24. the program's spans and its graphs' timing events ----
    spans = spans_phase(dev, card)
    t_phase = phase_done(24, t_phase, t_start)

    # ---- 25. the marble noise kernel ----
    noise = noise_phase(dev, card)
    phase_done(25, t_phase, t_start)

    launches = {"none": counts9["none"], "bvh": counts16m["bvh"],
                "cull": counts9c["cull"], "bwd": counts10["bwd"],
                "aaq": counts13["none"]}
    log(f"launches: none {counts9['none']} (scene 9 main path; scene 1 main "
        f"path {counts1['none']}), bvh {launches['bvh']} (spread16k main "
        f"path; scene 9 four-way {four_counts['bvh']}, spread16k 160x90 "
        f"{counts16['bvh']}), cull {launches['cull']} (the forced-cull "
        f"scene 9 main path, 400x400 16 spp; scene 9 four-way "
        f"{four_counts['cull']}), "
        f"bwd {launches['bwd']} (the train step main path, "
        f"{len(GRAD_SEEDS)} steps), none with the axis-aligned path "
        f"{launches['aaq']} (the cli render 5 main path; progressive scene "
        f"6 {counts14['none']})")
    log(f"launches of phases 18-20: parity "
        f"{json.dumps(tools['parity_launches'])}, config5 "
        f"{json.dumps(tools['config5_launches'])}, bench scene 5 and --grad "
        f"{json.dumps(tools['bench_launches'])}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"spans": spans}))
    log(json.dumps({"noise": noise}))
    log(json.dumps({"philox": philox}))
    log(json.dumps({"lockstep_graph": lockstep_graph}))
    log(json.dumps({"step_graph": step_graph}))
    log(json.dumps({"span_graph": span_graph}))
    log(json.dumps({"tools": tools}))
    log(json.dumps({"sharding": sharding}))
    rows_hits = kern.pop("rows_hits")
    log(json.dumps({"precision": precision_record(kern, rows_hits)}))
    names = {"none": "closest_hit", "bvh": "closest_hit_bvh",
             "cull": "closest_hit_cull", "bwd": "closest_hit_bwd",
             "aaq": "closest_hit_aaq"}
    replaces = dict.fromkeys(ch.ACCELS,
                             "mort_tpu/render/pallas_intersect.py:1215")
    replaces["bwd"] = "mort_tpu/render/pallas_intersect.py:1305"
    replaces["aaq"] = "mort_tpu/render/pallas_intersect.py:690"
    shapes = dict.fromkeys(ch.ACCELS, f"scene9 R={R_SCENE9}")
    shapes["bwd"] = f"scene1 grad R={GRAD_W * GRAD_H}"
    shapes["aaq"] = f"scene5 R={kern['aaq']['R']}"
    p18 = philox["times"][0]
    philox_row = {
        "name": "philox_uniform4", "route": "cuda",
        "source": "mort_tpu_torch/csrc/philox.cu",
        "replaces": "none (plain XLA in mort_tpu/rng.py)",
        "launches": sum(philox["launch_count"][k]["kernel"]
                        for k in ("frame", "step")),
        "max_abs_err": 0.0, "ms": p18["ms"],
        "ms_back_to_back": p18["ms_back_to_back"],
        "plain_ms": p18["plain_ms"], "bound_ms": p18["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "shape": f"scene1 R={p18['R']}"}
    n16 = noise["times"][0]
    noise_row = {
        "name": "noise_marble", "route": "cuda",
        "source": "mort_tpu_torch/csrc/noise.cu",
        "replaces": "none (plain XLA in mort_tpu/render/textures.py)",
        "launches": noise["launch_count"]["frame"]["kernel"],
        "max_abs_err": noise["max_abs_err"], "ms": n16["ms"],
        "ms_back_to_back": n16["ms_back_to_back"],
        "plain_ms": n16["plain_ms"], "bound_ms": n16["bound_ms"],
        "bound_by": n16["bound_by"], "library_ms": None,
        "shape": f"scene9 noise row R={n16['R']}"}
    log(json.dumps({"kernels": [{
        "name": names[k], "route": "cuda",
        "source": "mort_tpu_torch/csrc/closest_hit.cu",
        "replaces": replaces[k], "launches": launches[k],
        "max_abs_err": kern[k]["err"], "ms": kern[k]["ms"],
        "ms_back_to_back": kern[k]["ms_back_to_back"],
        "plain_ms": kern[k]["plain_ms"], "bound_ms": kern[k]["bound_ms"],
        "bound_by": kern[k]["bound_by"], "library_ms": None,
        "shape": shapes[k]} for k in ch.ACCELS + ("bwd", "aaq")]
        + [philox_row, noise_row]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if len(sys.argv) > 1:
        shard_worker(sys.argv[1:])
    else:
        main()
