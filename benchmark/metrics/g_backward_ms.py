"""g_backward_ms: the device span ``train.g_backward`` (the G gradient: the
blocks' and VGG's recomputation, the backward through D, VGG and G) a step
of the traced window, timed by the CUDA events recorded into the step's
graph (``benchmark/spans_train.py``)."""

from benchmark import spans_train


def probe(ctx, rec):
    return spans_train.per_step_ms(ctx, rec, ("train.g_backward",))


def read(rec):
    return spans_train.spans.probed(rec, "g_backward_ms")
