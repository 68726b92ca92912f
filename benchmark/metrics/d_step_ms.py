"""d_step_ms: the device span ``train.d_step`` (D's forward on fake and real
with one power iteration, its hinge losses and its backward) a step of the
traced window, timed by the CUDA events recorded into the step's graph
(``benchmark/spans_train.py``)."""

from benchmark import spans_train


def probe(ctx, rec):
    return spans_train.per_step_ms(ctx, rec, ("train.d_step",))


def read(rec):
    return spans_train.spans.probed(rec, "d_step_ms")
