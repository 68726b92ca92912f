"""tocg_ms: the device span ``tryon.tocg`` (``pipelines/tryon``: the
downsampling to the condition size, the tocg and the cloth-mask
composition) a request of the traced window, timed by the CUDA events
recorded into the try-on graph (``benchmark/spans.py``)."""

from benchmark import spans


def probe(ctx, rec):
    return spans.per_request_ms(ctx, rec, ("tryon.tocg",), device=True)


def read(rec):
    return spans.probed(rec, "tocg_ms")
