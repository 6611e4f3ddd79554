"""The generator of the benchmark's Path-X traffic: images like LRA's
Path-X (128 x 128, flattened row by row to 16 384 steps of one feature)
made on the device from the seed, a label each, and the order in which a
run takes them.

An image is a dark background with ``strokes`` bright dashed curves and
two endpoint marks (3 x 3 squares). Each curve is a quadratic Bezier
curve with its three control points uniform over the image, sampled at
``samples_per_side`` points per image side so that no pixel of a curve is
skipped, cut into dashes of ``dash`` samples with a uniform phase, at a
brightness uniform in ``stroke_level``. The labels are balanced (a seeded
permutation of alternating 0 and 1): a label-1 image has its marks at
both ends of its first curve, a label-0 image at the start of its first
curve and the end of its second. Pixels in [0, 1] are normalized to
[-1, 1] (``2 x - 1``), as S5's Path-X loader normalizes them. Every
quantity is one call of a ``torch.Generator`` on the device for the whole
pool.

A mix (``benchmark/traffic/<name>.json``) gives: ``side``, ``pool``
(images made at set-up), ``classes``, ``batch`` (images a step takes, per
rank), ``ranks``, ``loop``, and the drawing's numbers above.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from benchmark.harness.seeds import derive
from benchmark.traffic import synthetic_ndns


@torch.no_grad()
def make_pool(mix: dict, seed: int, device
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(inputs (pool, side * side, 1) float32 in [-1, 1], labels (pool,)
    int64), on ``device``."""
    n, side, k = mix["pool"], mix["side"], mix["strokes"]
    if mix["classes"] != 2 or k < 2:
        raise ValueError("the Path-X images take 2 classes and at least "
                         "2 strokes")
    g = torch.Generator(device=device).manual_seed(derive(seed, "traffic"))
    ctrl = torch.rand((n, k, 3, 2), generator=g, device=device) * (side - 1)
    phase = torch.rand((n, k, 1), generator=g, device=device)
    lo, hi = mix["stroke_level"]
    level = lo + (hi - lo) * torch.rand((n, k, 1), generator=g,
                                        device=device)
    labels = torch.randperm(n, generator=g, device=device) % 2
    s = mix["samples_per_side"] * side
    t = torch.linspace(0.0, 1.0, s, device=device)[:, None]
    pts = ((1 - t) ** 2 * ctrl[:, :, None, 0] + 2 * (1 - t) * t
           * ctrl[:, :, None, 1] + t ** 2 * ctrl[:, :, None, 2])
    pix = pts.round().long()                              # (n, k, s, 2)
    flat = pix[..., 1] * side + pix[..., 0]
    dash = mix["dash"]
    pos = torch.arange(s, device=device) + (phase * 2 * dash).long()
    on = (pos // dash) % 2 == 0
    off = side * side                       # a spare pixel, cut below
    img = torch.zeros((n, side * side + 1), device=device)
    img.scatter_reduce_(1, torch.where(on, flat, off).reshape(n, -1),
                        level.expand(n, k, s).reshape(n, -1), "amax")
    first = pix[:, 0]                                     # (n, s, 2)
    second = torch.where(labels[:, None, None].bool(), pix[:, 0], pix[:, 1])
    ends = torch.stack([first[:, 0], second[:, -1]], 1)   # (n, 2, 2)
    d = torch.arange(-1, 2, device=device)
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    sq = torch.stack([dx.reshape(-1), dy.reshape(-1)], -1)  # (9, 2)
    marks = (ends[:, :, None] + sq).clamp(0, side - 1)    # (n, 2, 9, 2)
    mflat = (marks[..., 1] * side + marks[..., 0]).reshape(n, -1)
    img.scatter_(1, mflat, 1.0)
    inputs = (2.0 * img[:, :off] - 1.0)[..., None].contiguous()
    return inputs, labels.to(torch.int64)


def schedule(mix: dict, seed: int, steps: int) -> np.ndarray:
    """Rows of the pool that each of ``steps`` steps takes, (steps, ranks *
    batch): passes over the pool in seeded orders
    (``synthetic_ndns.schedule``)."""
    return synthetic_ndns.schedule(
        {"batch": mix["batch"], "ranks": mix.get("ranks", 1),
         "pool_clips": mix["pool"]}, seed, steps)
