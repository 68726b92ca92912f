"""capture_s: the program's spans ``graphs.capture`` (``core/graphs``: each
graph's eager warm-up and recording) before the window of a traced run, less
the kernels' first loads inside them (``ops.load``, with any build), in
seconds (``benchmark/spans.py``)."""

from benchmark import spans


def probe(ctx, rec):
    return spans.set_up_s(ctx, rec, "graphs.capture", less="ops.load")


def read(rec):
    return spans.probed(rec, "capture_s")
