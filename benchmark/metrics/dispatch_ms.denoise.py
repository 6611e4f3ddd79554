"""dispatch_ms.denoise: host milliseconds to enqueue one request (STFT,
model, mask, iSTFT), before the synchronize; the mean over the
traced run's timed stretch."""

import numpy as np


def read(ctx):
    return float(np.mean(ctx.timed["dispatch"])) * 1e3
