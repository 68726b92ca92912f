"""init_s: the program's span ``pipeline.init`` (``pipelines/tryon``: the
modules built and the host's draw of their random weights) before the
window of a traced run, in seconds (``benchmark/spans.py``)."""

from benchmark import spans


def probe(ctx, rec):
    return spans.set_up_s(ctx, rec, "pipeline.init")


def read(rec):
    return spans.probed(rec, "init_s")
