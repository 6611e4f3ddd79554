"""Random weights made on the device from the seed: one normal and one
uniform draw of a ``torch.Generator`` on the device, each as long as all
the leaves together, cut into the leaves in their order. A task lists its
leaves and sets what a draw does not (``benchmark/tasks/<task>.py``);
both sides of the check get the same dict."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from benchmark.harness.seeds import derive

# (name, shape, kind, a, b): normal a + b * N(0, 1); uniform in [a, b);
# loguniform exp(U[log a, log b))
Leaf = Tuple[str, tuple, str, float, float]


@torch.no_grad()
def draw(spec: List[Leaf], seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf of ``spec`` from ``seed``, in float32 on ``device``."""
    sizes = [math.prod(s) for _, s, _, _, _ in spec]
    g = torch.Generator(device=device).manual_seed(derive(seed, "weights"))
    normal = torch.randn(sum(sizes), generator=g, device=device)
    unif = torch.rand(sum(sizes), generator=g, device=device)
    w, at = {}, 0
    for (name, shape, kind, a, b), n in zip(spec, sizes):
        if kind == "normal":
            v = a + b * normal[at:at + n]
        elif kind == "uniform":
            v = a + (b - a) * unif[at:at + n]
        else:
            v = torch.exp(math.log(a) + (math.log(b) - math.log(a))
                          * unif[at:at + n])
        w[name] = v.reshape(shape).clone()
        at += n
    return w
