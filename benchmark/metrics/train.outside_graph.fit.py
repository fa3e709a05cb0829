"""The train loop's wall outside the step graph, in %: 1 - the device
time of the replayed steps (timing events captured into the step graph,
the program's counter "train.step_device_ns") over the host's time from
each replayed step's start to the next step's ("train.step_period_ns"),
over the run's unprofiled steps.  None where no step was replayed."""


def read(obs):
    from mort_tpu_torch import metrics
    if not hasattr(metrics, "counters"):
        return None
    c = metrics.counters()
    period = c.get("train.step_period_ns", 0)
    if not period:
        return None
    return 100.0 * (1.0 - c.get("train.step_device_ns", 0) / period)
