"""request_ms_p95: the 95th percentile (linear between ranks) of every
request of the window, each from its submission to its rgb on the host."""

import numpy as np


def read(rec):
    lat = rec["latencies_ms"]
    return float(np.percentile(lat, 95)) if lat else None
