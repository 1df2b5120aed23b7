"""ttft_p50_ms.hostpaced: the 50th percentile of `latency.ttft`, in ms.  A
per-layer metric, for the reason `tokens_per_s.hostpaced` gives."""

import numpy as np

from h100bench import latency


def read(rec):
    x = latency.ttft(rec)
    return float(np.percentile(x, 50)) if x else None
