"""Device operations of the profiled train steps over their forward
closest-hit calls (one a bounce of a sample)."""


def read(obs):
    n = sum(c for c, _ in obs["kernels"].values())
    return n / obs["fwd_calls"] if obs.get("fwd_calls") else None
