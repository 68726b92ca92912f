"""generator_ms: the device span ``tryon.generator`` (``pipelines/tryon``:
the generator's input concat and the SPADE generator) a request of the
traced window, timed by the CUDA events recorded into the try-on graph
(``benchmark/spans.py``)."""

from benchmark import spans


def probe(ctx, rec):
    return spans.per_request_ms(ctx, rec, ("tryon.generator",), device=True)


def read(rec):
    return spans.probed(rec, "generator_ms")
