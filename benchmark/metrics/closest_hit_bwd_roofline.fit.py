"""The closest hit's backward share of its roofline, in %: the least
time of its calls in the profiled steps (``bounds.bwd_bound_s``, from the
hit lanes the reference counts on the same paths) over the device time of
the ``closest_hit_bwd_*`` kernels."""

from benchmark.harness.profiling import launches


def read(obs):
    n, us = launches(obs["kernels"], "closest_hit_bwd_")
    if not n or not us:
        return None
    return 100.0 * obs["bwd_bound_s"] / (us / 1e6)
