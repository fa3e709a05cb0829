"""Host time of a ``render_wavefront`` call outside its waits on the
device, in ms: per span "wavefront.call", its duration less its loop
reads ("wavefront.read") and less its graph key's first two rounds, the
eager one and the capture with its first replay ("wavefront.warm"),
which are set-up's, over every unprofiled call of the run's process (the
window's viewer frames and set-up's warm-up).  None where the program has
no spans or made no call."""


def read(obs):
    from mort_tpu_torch import metrics
    if not hasattr(metrics, "span_totals"):
        return None
    totals = metrics.span_totals()
    call = metrics.total_of(totals, "wavefront.call")
    if not call.count:
        return None
    waits = sum(metrics.total_of(totals, name, under="wavefront.call").ns
                for name in ("wavefront.read", "wavefront.warm"))
    return (call.ns - waits) / call.count / 1e6
