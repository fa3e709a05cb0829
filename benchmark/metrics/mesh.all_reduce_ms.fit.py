"""Device time of a train step's gradient all-reduce on rank 0, in ms: the
mean time between the timing events around the flat bucket's all-reduce
(``torch.cat`` to its split, on the step's stream; the program's counters
"train.all_reduce_device_ns" and "train.all_reduce_device_count") over
rank 0's unprofiled replayed steps.  It holds the wait for the slowest
rank.  None where the program times no all-reduce."""


def read(obs):
    from mort_tpu_torch import metrics
    if not hasattr(metrics, "counters"):
        return None
    c = metrics.counters()
    n = c.get("train.all_reduce_device_count", 0)
    if not n:
        return None
    return c.get("train.all_reduce_device_ns", 0) / n / 1e6
