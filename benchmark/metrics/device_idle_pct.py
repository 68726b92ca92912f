"""device_idle_pct: 100 x (1 - busy_s / window_s) of the profiled requests
after the window of a traced run: the union of the device's kernels, copies
and sets in ``torch.profiler``'s trace over the host clock's span of those
requests."""


def read(rec):
    dev = rec["device"]
    if not dev.get("window_s") or "busy_s" not in dev:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])
