"""The spread of the ranks' step graphs, in %: the slowest rank's mean
device time of a replayed step graph less the fastest rank's (each rank's
"train.step_device_ns" over its "train.all_reduce_device_count": the
step's and the all-reduce's reads come in pairs), over rank 0's mean step
period ("train.step_period_ns" over the same count).  Every rank's
counters come in ``obs["rank_counters"]``, rank 0's first.  None where a
rank timed no all-reduce."""


def read(obs):
    ranks = (obs or {}).get("rank_counters")
    if not ranks:
        return None
    means = []
    for c in ranks:
        n = (c or {}).get("train.all_reduce_device_count", 0)
        if not n:
            return None
        means.append(c.get("train.step_device_ns", 0) / n)
    period = ranks[0].get("train.step_period_ns", 0) / \
        ranks[0]["train.all_reduce_device_count"]
    if not period:
        return None
    return 100.0 * (max(means) - min(means)) / period
