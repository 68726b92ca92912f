"""train_cond_ms: the device span ``train.condition``
(``train/generator_trainer``: the batch's cast and the no-gradient
conditioning, the tocg, the lift and the LUT) a step of the traced window,
timed by the CUDA events recorded into the step's graph
(``benchmark/spans_train.py``)."""

from benchmark import spans_train


def probe(ctx, rec):
    return spans_train.per_step_ms(ctx, rec, ("train.condition",))


def read(rec):
    return spans_train.spans.probed(rec, "train_cond_ms")
