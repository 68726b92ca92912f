"""optim_ms: the device spans ``train.g_update`` and ``train.d_update`` (both
Adam updates, with the u/v written) a step of the traced window, timed by
the CUDA events recorded into the step's graph
(``benchmark/spans_train.py``)."""

from benchmark import spans_train


def probe(ctx, rec):
    return spans_train.per_step_ms(ctx, rec,
                                  ("train.g_update", "train.d_update"))


def read(rec):
    return spans_train.spans.probed(rec, "optim_ms")
