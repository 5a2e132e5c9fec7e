"""serve_p95_ms: the 95th percentile of every batch's latency in the
window, from taking its host input to its outputs on the host.  Host
clock."""

import numpy as np


def read(ctx):
    return float(np.percentile(np.asarray(ctx.window.latencies), 95)) * 1e3
