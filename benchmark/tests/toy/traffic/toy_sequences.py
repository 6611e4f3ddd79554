"""Generator ``toy_sequences``: a pool of sequences of shape (L, 1) with
an integer label each, made on the device from the seed, and the order in
which a run takes them. No audio.

A mix gives ``pool_rows``, ``length``, ``classes``, ``batch`` and
``ranks``."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness.seeds import derive, rng


@torch.no_grad()
def make_pool(mix: dict, seed: int, device):
    """(inputs (pool_rows, length, 1) float32, labels (pool_rows,) int64)."""
    g = torch.Generator(device=device).manual_seed(derive(seed, "traffic"))
    n = mix["pool_rows"]
    x = torch.randn((n, mix["length"], 1), generator=g, device=device)
    y = torch.randint(0, mix["classes"], (n,), generator=g, device=device)
    return x, y


def schedule(mix: dict, seed: int, steps: int) -> np.ndarray:
    """Rows of each step, (steps, batch): distinct rows within a step."""
    r = rng(seed, "schedule")
    order = np.argsort(r.random((steps, mix["pool_rows"])), axis=1)
    return order[:, :mix["batch"] * mix.get("ranks", 1)]
