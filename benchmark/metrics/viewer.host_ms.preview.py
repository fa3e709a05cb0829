"""The viewer's own host time a frame, in ms: per span "viewer.frame"
(a frame event of ``interactive.view``), its duration less its
``render_wavefront`` call ("wavefront.call"): the image's copy to the
host, the scale, the NaN scrub, the print and the loop, over every
unprofiled viewer frame of the run's process.  None where the program has
no spans or rendered no viewer frame."""


def read(obs):
    from mort_tpu_torch import metrics
    if not hasattr(metrics, "span_totals"):
        return None
    totals = metrics.span_totals()
    frame = metrics.total_of(totals, "viewer.frame")
    if not frame.count:
        return None
    call = metrics.total_of(totals, "wavefront.call", under="viewer.frame")
    return (frame.ns - call.ns) / frame.count / 1e6
