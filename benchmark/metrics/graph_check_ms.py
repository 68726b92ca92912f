"""graph_check_ms: the program's spans ``graphs.signature`` and
``graphs.weights`` (``core/graphs.Captured``: the arguments' signature and
the weights' versions and pointers), both entry points, a request of the
traced window, on the host clock (``benchmark/spans.py``)."""

from benchmark import spans


def probe(ctx, rec):
    return spans.per_request_ms(ctx, rec, ("graphs.signature", "graphs.weights"))


def read(rec):
    return spans.probed(rec, "graph_check_ms")
