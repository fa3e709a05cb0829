"""Mean duration of a round graph's launch, in ms: the program's span
"wavefront.launch" (a replay in ``render/wavefront.py::_run_kept``) over
every unprofiled span of the run's process, the window's frames and
set-up's warm-up.  None where the program has no spans or replayed no
round (the CPU)."""


def read(obs):
    from mort_tpu_torch import metrics
    if not hasattr(metrics, "span_totals"):
        return None
    t = metrics.total_of(metrics.span_totals(), "wavefront.launch")
    return t.ns / t.count / 1e6 if t.count else None
