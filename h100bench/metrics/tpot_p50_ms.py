"""tpot_p50_ms: the 50th percentile of `latency.tpot`, in ms."""

import numpy as np

from h100bench import latency


def read(rec):
    x = latency.tpot(rec)
    return float(np.percentile(x, 50)) if x else None
