"""denoise_p95_ms: the 95th percentile of every request of the window,
from its start to its audio being ready (a synchronize)."""

import numpy as np


def read(ctx):
    return float(np.percentile(ctx.window["latencies"], 95)) * 1e3
