"""batch_p95_ms: the 95th percentile of every window batch's latency,
from submission until its ids are on the host (the host clock; linear
interpolation between order statistics)."""

import numpy as np

UNIT = "ms"


def read(run):
    if not run.latencies_s:
        return None
    return float(np.percentile(np.asarray(run.latencies_s) * 1e3, 95))
