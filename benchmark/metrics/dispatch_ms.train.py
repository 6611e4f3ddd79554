"""dispatch_ms.train: host milliseconds to enqueue one train step (rows,
STFTs, the program's step), before the synchronize; the mean over the
traced run's timed stretch."""

import numpy as np


def read(ctx):
    return float(np.mean(ctx.timed["dispatch"])) * 1e3
