"""ttft_p90_ms.hostpaced: the 90th percentile of `latency.ttft`, in ms. A
per-layer metric: a 30 s window finishes too few requests for ten
samples beyond a p90, and the host paces it."""

import numpy as np

from h100bench import latency


def read(rec):
    x = latency.ttft(rec)
    return float(np.percentile(x, 90)) if x else None
