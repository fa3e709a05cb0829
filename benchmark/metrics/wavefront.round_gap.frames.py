"""The round loop's wall in which no round graph ran, in %: 1 - the
device time of the replayed rounds (timing events captured into each
round graph, the program's counter "wavefront.round_device_ns") over their
periods on the host's clock, each from the end of the loop read before its
launch to the end of the read after it ("wavefront.round_period_ns"),
over the run's unprofiled rounds.  None where no round was replayed."""


def read(obs):
    from mort_tpu_torch import metrics
    if not hasattr(metrics, "counters"):
        return None
    c = metrics.counters()
    period = c.get("wavefront.round_period_ns", 0)
    if not period:
        return None
    return 100.0 * (1.0 - c.get("wavefront.round_device_ns", 0) / period)
