"""The yardstick's peaks and the bytes and operations of the kernels.

Peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet):
3.35 TB/s of HBM3 and 67 TFLOP/s of float32 outside the tensor cores.
A card set below 700 W runs slower under load; every result line carries
the card's name, and PERF.md its power limit.

The closest hit's forward is counted at its entry
(``mort_tpu_torch.render.closest_hit.closest_hit``), by bytes alone: the
[8, R] rays read and the [32, R] rows written once a call, and the
scene's sphere, quad and joined shading records read once a call.  The
mode's own tables (boxes, trees, bins) are left out, so the count is the
same whatever mode or design serves the call.  Its operations are left
out too: the tests a ray needs depend on the design (a cull tests less
than a scan), so a count of one design's tests would let a later design
that tests less read past 100%.

The backward (``closest_hit_bwd_*``) is counted per call by the larger of
its bytes and its operations, which are fixed by the inputs: every lane
reads its kind and writes its 8 rows of ray cotangent; a lane that hit
reads its 7 ray rows, index, dt and the joined row's cotangents it uses;
the records are read and the three gradient tables written once; a
sphere lane takes 130 float32 operations (the ray terms, the root and its
partials, the nine record terms, the ray cotangent) and a quad lane 32.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

RAY_ROWS = 8        # ray stack in: origin, direction, time, pad
OUT_ROWS = 32       # row out: the joined row, t, kind, index, pad
SPH_RECORD = 10     # center, motion, c.c - r^2, 2 c.cv, cv.cv, surface
QUAD_RECORD = 13    # normal, D, v x w, qa, w x u, qb, surface
JOINED_ROW = 27     # material, texture and geometry columns a primitive
BWD_SPHERE_OPS, BWD_QUAD_OPS = 130, 32


def fwd_bytes(rays: int, n_spheres: int, n_quads: int) -> int:
    """Bytes one forward closest-hit call of ``rays`` rays must move."""
    return 4 * (rays * (RAY_ROWS + OUT_ROWS)
                + n_spheres * SPH_RECORD + n_quads * QUAD_RECORD
                + (n_spheres + n_quads) * JOINED_ROW)


def fwd_bound_s(calls: int, rays: int, n_spheres: int, n_quads: int):
    """Least device seconds of ``calls`` forward calls (bytes-bound)."""
    return calls * fwd_bytes(rays, n_spheres, n_quads) / HBM_BYTES_PER_S


def bwd_bound_s(rays: int, sph_hits: int, quad_hits: int, n_spheres: int,
                n_quads: int) -> float:
    """Least device seconds of one backward call: the larger of its bytes
    over HBM bandwidth and its operations over the float32 peak."""
    n_join = n_spheres + n_quads
    n_bytes = (4 * rays * (1 + RAY_ROWS)
               + 4 * (sph_hits + quad_hits) * (7 + 1 + 1 + JOINED_ROW + 1)
               + 4 * 2 * (n_spheres * SPH_RECORD + n_quads * QUAD_RECORD)
               + 4 * n_join * JOINED_ROW)
    n_ops = sph_hits * BWD_SPHERE_OPS + quad_hits * BWD_QUAD_OPS
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S)
