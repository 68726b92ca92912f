"""lift_ms: the device span ``tryon.lift`` (``pipelines/tryon``: the
resize to the fine size, the blur, argmax, lookup and one-hot, the flow's
resize, the warp and the occlusion) a request of the traced window, timed
by the CUDA events recorded into the try-on graph (``benchmark/spans.py``)."""

from benchmark import spans


def probe(ctx, rec):
    return spans.per_request_ms(ctx, rec, ("tryon.lift",), device=True)


def read(rec):
    return spans.probed(rec, "lift_ms")
