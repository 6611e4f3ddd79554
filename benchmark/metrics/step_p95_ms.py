"""step_p95_ms: the 95th percentile of every step of the window, each from
its start to its results being ready (a synchronize), on rank 0."""

import numpy as np


def read(ctx):
    return float(np.percentile(ctx.window["latencies"], 95)) * 1e3
