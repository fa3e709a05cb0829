"""The forward closest hit's share of its roofline, in %: the least
time its calls in the profiled slice could take (``bounds.fwd_bound_s``,
bytes-bound) over the device time of its ``closest_hit_*`` kernels."""

from benchmark.harness.profiling import launches


def read(obs):
    n, us = launches(obs["kernels"], "closest_hit_", exclude="_bwd_")
    if not n or not us:
        return None
    return 100.0 * obs["fwd_bound_s"] / (us / 1e6)
