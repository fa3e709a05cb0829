"""Device operations a bounce step in the profiled slice: every device
operation over the forward closest-hit calls (one a bounce step)."""


def read(obs):
    n = sum(c for c, _ in obs["kernels"].values())
    return n / obs["fwd_calls"] if obs.get("fwd_calls") else None
