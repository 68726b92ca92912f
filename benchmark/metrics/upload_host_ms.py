"""upload_host_ms: the program's span ``to_device`` (``data/device``) a
request of the traced window, on the host clock: the pageable copies of the
request's batch to the card, with the host's wait for the stream to drain
before them (``benchmark/spans.py``)."""

from benchmark import spans


def probe(ctx, rec):
    return spans.per_request_ms(ctx, rec, ("to_device",))


def read(rec):
    return spans.probed(rec, "upload_host_ms")
