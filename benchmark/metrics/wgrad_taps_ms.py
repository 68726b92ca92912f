"""wgrad_taps_ms: the device spans ``train.wgrad_taps``
(``ops/conv3x3.wgrad_taps``: each 3x3 weight gradient as nine tap products,
inside the G backward), summed over a step of the traced window, timed by
the CUDA events recorded into the step's graph
(``benchmark/spans_train.py``)."""

from benchmark import spans_train


def probe(ctx, rec):
    return spans_train.per_step_ms(ctx, rec, ("train.wgrad_taps",))


def read(rec):
    return spans_train.spans.probed(rec, "wgrad_taps_ms")
