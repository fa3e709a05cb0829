"""The forward closest-hit kernels' share of the device's busy time
in the profiled slice, in %."""

from benchmark.harness.profiling import launches


def read(obs):
    n, us = launches(obs["kernels"], "closest_hit_", exclude="_bwd_")
    if not n or not obs["busy_s"]:
        return None
    return 100.0 * (us / 1e6) / obs["busy_s"]
