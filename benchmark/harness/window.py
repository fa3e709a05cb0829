"""What every loop shares: the run's context, seeds and the window.

A window runs whole units back to back (a frame, a train step, a viewer
frame) and never cuts one: the unit in flight when ``--seconds`` have
passed runs to its end and is counted, and the window closes at its end.
A rate is the work of all the window's units over the window's wall time,
from the first unit's start to the last unit's end; a tail is taken over
every unit of the window.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Context:
    """One run: its cell, configuration, traffic, seed and window length,
    the camera's fields after the traffic's overrides and the limits.  The
    scene is the configuration's description: the program compiles it in
    its set-up (``program_scene``), and the reference flattens it again
    on first use (``leaves``, ``meta``), once the window has closed."""
    cell: dict
    cfg: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    cam: dict
    limits: dict
    _reference: tuple = field(default=None, init=False, repr=False)

    def program_scene(self):
        """(SceneData, SceneMeta) on the host, compiled by the program."""
        from benchmark.harness import cells
        return cells.program_scene(self.cfg)

    def reference_scene(self) -> tuple:
        """(leaves, meta) of the reference's own flattening."""
        if self._reference is None:
            from benchmark.harness import cells
            self._reference = cells.scene(self.cfg)
        return self._reference

    @property
    def leaves(self) -> dict:
        return self.reference_scene()[0]

    @property
    def meta(self) -> dict:
        return self.reference_scene()[1]


def rng(seed: int, tag: str) -> np.random.Generator:
    """A generator of the run's seed and a purpose tag, so that each use
    (pixels, unit seeds, commands, target) draws its own stream."""
    return np.random.default_rng([int(seed) % (1 << 63),
                                  int.from_bytes(tag.encode(), "little")])


def unit_seeds(seed: int, tag: str, n: int = 4096) -> list:
    """``n`` 32-bit seeds, one a unit, drawn from the run's seed."""
    return [int(x) for x in rng(seed, tag).integers(0, 1 << 32, size=n,
                                                    dtype=np.uint64)]


def run_units(unit, seconds: float) -> dict:
    """Run ``unit(k)`` for k = 0, 1, ... until ``seconds`` have passed at
    a unit's end; returns the units' start and end times and the window's
    wall time (first start to last end)."""
    starts, ends = [], []
    t0 = time.perf_counter()
    k = 0
    while True:
        starts.append(time.perf_counter())
        unit(k)
        ends.append(time.perf_counter())
        k += 1
        if ends[-1] - t0 >= seconds:
            break
    return {"starts": starts, "ends": ends, "units": k,
            "wall": ends[-1] - starts[0]}


def percentile(values, q: float) -> float:
    """The q-th percentile of every value (linear between ranks)."""
    return float(np.percentile(np.asarray(values, np.float64), q))
