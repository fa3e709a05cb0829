"""The device's idle share of the profiled slice, in %: 1 - the
seconds in which any device operation ran over the slice's wall time,
both from the same profiled window (the profiler's own cost raises it:
compare it with itself from change to change)."""


def read(obs):
    if not obs.get("window_s") or not obs.get("busy_s"):
        return None
    return 100.0 * (1.0 - obs["busy_s"] / obs["window_s"])
