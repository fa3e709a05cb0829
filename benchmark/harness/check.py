"""How ``correct`` is decided: the numbers compared and their limits.

Each cell compares numbers that the program's timed output and the plain
reference give (``benchmark/reference``), each against its limit in
``limits/<workload>.json``, where the readings it was set from are kept
beside it: the largest that sound runs gave over a dozen seeds and more
(``lower``) and the smallest that the control or a planted fault gave
(``upper``).  A run is correct when every number is at most its limit.
"""

from __future__ import annotations

import numpy as np

# A pixel is off when it differs from the reference by more than this:
# far above float32 rounding of a mean of samples (~1e-6 relative), and
# below what one camera path that takes another way changes in a pixel of
# up to 225 samples.
PIXEL_ATOL = 1e-4
PIXEL_RTOL = 1e-3


def pixels_off(prog, ref) -> np.ndarray:
    """[K] bool: which of the pixels ([K, 3]) are off."""
    prog = np.asarray(prog, np.float64)
    ref = np.asarray(ref, np.float64)
    err = np.abs(prog - ref).max(axis=1)
    bad = err > PIXEL_ATOL + PIXEL_RTOL * np.abs(ref).max(axis=1)
    return bad | ~np.isfinite(prog).all(axis=1)


def norm_gaps(prog: dict, ref: dict, leaves) -> dict:
    """{leaf: gap}: |‖prog‖ - ‖ref‖| over the larger of the reference's
    norm of that leaf and of the median counted leaf, for the counted
    ``leaves``."""
    norms = {k: float(np.linalg.norm(ref[k])) for k in leaves}
    med = float(np.median([norms[k] for k in leaves]))
    return {k: abs(float(np.linalg.norm(prog[k])) - norms[k])
            / max(norms[k], med, 1e-30) for k in leaves}


def counted_leaves(ref_grad: dict, share: float = 1e-3) -> list:
    """The leaves whose reference gradient moves them: a norm of at least
    ``share`` of the largest leaf's.  The rest are nought to float32
    rounding (a sphere's centre moves no lambertian or metal path's
    radiance: the integrand is piecewise constant in the geometry)."""
    norms = {k: float(np.linalg.norm(v)) for k, v in ref_grad.items()}
    top = max(norms.values())
    return [k for k, n in norms.items() if n >= share * top]


def judge(limits: dict, values: dict):
    """(correct, lines): every compared number beside its limit."""
    ok = True
    lines = []
    for name, v in values.items():
        lim = float(limits["numbers"][name]["limit"])
        good = bool(np.isfinite(v)) and v <= lim
        ok = ok and good
        lines.append(f"{name} {v:.6g} limit {lim:.6g}"
                     + ("" if good else " OVER"))
    return ok, lines
