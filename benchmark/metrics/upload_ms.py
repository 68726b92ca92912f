"""upload_ms: the device time of a request's copy to the card and its
expansion graph: the union of the device operations launched inside
``to_device`` and ``prepare_batch`` in ``torch.profiler``'s trace of the
profiled requests after the window, over the requests. Nothing is read if
the forwards' kernel counts differ (the profiler lost records)."""


def read(rec):
    prof = rec.get("profile")
    if not prof or len(set(prof["forward_kernels"])) != 1:
        return None
    return prof["layer_ms"].get("upload")
