"""Lane occupancy of the window's frames, in %: useful ray segments
over the pool's slots executed (``useful_segments / slots_executed``)."""


def read(obs):
    return 100.0 * obs["useful"] / obs["slots"] if obs.get("slots") else None
