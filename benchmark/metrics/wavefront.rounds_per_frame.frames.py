"""Rounds of the wavefront loop a frame, over the window's frames
(``render_wavefront(return_stats=True)["iterations"]``)."""


def read(obs):
    return obs["rounds"] / obs["frames"] if obs.get("frames") else None
