"""Start the ranks of a process group as local processes and wait for them.

The port is SPMD, one process a device; on one machine its ranks are
processes that the caller starts.  ``run_ranks`` is the one launcher of
the repo's tools and tests (``config5 --mesh``, ``chip_smoke.py``'s
sharded phase, ``tests/test_torch_sharding.py``): each rank's command
writes its output to its own log, and a rank that fails or outlives the
timeout fails the launch with the tail of its log, after every rank still
running has been killed.
"""

from __future__ import annotations

import os
import subprocess
import time


def run_ranks(commands, logs, timeout: float, cwd=None) -> float:
    """Run ``commands[r]`` (an argv list) for every rank r at once, its
    stdout and stderr to ``logs[r]``, and wait for all of them.  Returns the
    seconds they took; raises ``RuntimeError`` when a rank exits non-zero
    or is still running after ``timeout`` seconds."""
    t0 = time.perf_counter()
    procs = []
    try:
        for cmd, log in zip(commands, logs):
            with open(log, "w") as f:
                procs.append(subprocess.Popen(
                    [str(c) for c in cmd], cwd=cwd, stdout=f,
                    stderr=subprocess.STDOUT))
        for r, p in enumerate(procs):
            left = timeout - (time.perf_counter() - t0)
            try:
                p.wait(timeout=max(left, 0.0))
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"rank {r} still running after {timeout} "
                                   f"s:\n{_tail(logs[r])}") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} exited {p.returncode}:\n"
                               f"{_tail(logs[r])}")
    return time.perf_counter() - t0


def _tail(path, n=4000) -> str:
    if not os.path.exists(path):
        return ""
    with open(path, errors="replace") as f:
        return f.read()[-n:]
