"""Host time of a train step's call, in ms: the mean duration of the
span "train.step" (``make_train_step``'s ``run``, which returns once the
step is queued) over every unprofiled step of the run's process, its
graph key's eager first step and capture ("train.eager",
"graphs.capture") left out as set-up's.  None where the program has no
spans or replayed no step (the CPU)."""


def read(obs):
    from mort_tpu_torch import metrics
    if not hasattr(metrics, "span_totals"):
        return None
    totals = metrics.span_totals()
    if not metrics.total_of(totals, "train.launch").count:
        return None
    step = metrics.total_of(totals, "train.step")
    first = sum(metrics.total_of(totals, name, under="train.step").ns
                for name in ("train.eager", "graphs.capture"))
    return (step.ns - first) / step.count / 1e6
