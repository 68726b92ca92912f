"""g_forward_ms: the device span ``train.g_forward`` (G's output, D on fake and
real, VGG19 and the losses of the G update) a step of the traced window,
timed by the CUDA events recorded into the step's graph
(``benchmark/spans_train.py``)."""

from benchmark import spans_train


def probe(ctx, rec):
    return spans_train.per_step_ms(ctx, rec, ("train.g_forward",))


def read(rec):
    return spans_train.spans.probed(rec, "g_forward_ms")
