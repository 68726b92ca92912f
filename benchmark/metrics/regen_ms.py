"""regen_ms: the device span ``train.regenerate`` (the second, no-gradient
forward of the updated G for the D update) a step of the traced window,
timed by the CUDA events recorded into the step's graph
(``benchmark/spans_train.py``)."""

from benchmark import spans_train


def probe(ctx, rec):
    return spans_train.per_step_ms(ctx, rec, ("train.regenerate",))


def read(rec):
    return spans_train.spans.probed(rec, "regen_ms")
