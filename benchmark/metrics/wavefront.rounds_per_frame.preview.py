"""Rounds of the wavefront loop a viewer frame over the window
(``wavefront.graph_count["rounds"]`` over the frames)."""


def read(obs):
    return obs["rounds"] / obs["frames"] if obs.get("frames") else None
