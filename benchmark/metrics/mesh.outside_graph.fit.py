"""Rank 0's train loop outside its step graph on a mesh, in %: 1 - the
device time of rank 0's replayed step graphs ("train.step_device_ns")
over the host's time from each replayed step's start to the next step's
("train.step_period_ns"), over its unprofiled steps.  On a mesh the rest
holds the gradient all-reduce and the wait for the slowest rank besides
the host's work.  None where no step was replayed."""


def read(obs):
    from mort_tpu_torch import metrics
    if not hasattr(metrics, "counters"):
        return None
    c = metrics.counters()
    period = c.get("train.step_period_ns", 0)
    if not period:
        return None
    return 100.0 * (1.0 - c.get("train.step_device_ns", 0) / period)
