"""forward_ms: the device time of the try-on forward a request: the union of
the device operations launched inside the pipeline's call (the try-on
graph's replay and its output clones) in ``torch.profiler``'s trace of the
profiled requests after the window, over the requests. Nothing is read if
the forwards' kernel counts differ (the profiler lost records)."""


def read(rec):
    prof = rec.get("profile")
    if not prof or len(set(prof["forward_kernels"])) != 1:
        return None
    return prof["layer_ms"].get("forward")
