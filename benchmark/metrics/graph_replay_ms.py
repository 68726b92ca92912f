"""graph_replay_ms: the program's spans ``graphs.copy_in``,
``graphs.launch`` and ``graphs.clone_out`` (``core/graphs.Captured``: the
arguments copied into the static buffers, the replay's launch, the outputs
cloned out), both entry points, a request of the traced window, on the host
clock (``benchmark/spans.py``)."""

from benchmark import spans


def probe(ctx, rec):
    return spans.per_request_ms(ctx, rec, ("graphs.copy_in", "graphs.launch",
                                           "graphs.clone_out"))


def read(rec):
    return spans.probed(rec, "graph_replay_ms")
