"""The general generator of the benchmark's audio traffic: synthetic
N-DNS denoising pairs made on the device from the seed, and the order in
which a run takes them.

The pairs follow the program's ``data/ndns.SyntheticNDNS`` (frozen here so
that the yardstick does not move with the program): clean speech stands
in as a sum of ``sinusoids`` amplitude-modulated sinusoids (frequency,
amplitude, modulation rate and both phases uniform in the mix's ranges);
the noise is white noise through the two-tap low-pass
``n'_t = a n_{t-1} + (1 - a) n_t`` with ``a`` uniform in ``lowpass_alpha``,
scaled to an SNR uniform in ``snr_db``. Every draw is one call of a
``torch.Generator`` on the device per quantity for the whole pool, made in
slices of ``make_clips`` clips to bound the memory it takes.

A mix (``benchmark/traffic/<name>.json``) gives: ``clip_seconds``,
``sample_rate``, ``pool_clips`` (clips made at set-up), ``batch`` (clips
a step or request takes, per rank), ``ranks``, ``loop`` ("closed": one
request in flight), the signal ranges above, and ``calibration`` where the
configuration calibrates (clips and frame slices of its input).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from benchmark.harness.seeds import derive, rng

MAKE_CLIPS = 16


@torch.no_grad()
def make_pool(mix: dict, seed: int, device, n_clips: int = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(noisy, clean), each (pool_clips, T) float32 on ``device``."""
    n = mix["pool_clips"] if n_clips is None else n_clips
    sr = mix["sample_rate"]
    t_len = int(round(mix["clip_seconds"] * sr))
    g = torch.Generator(device=device).manual_seed(derive(seed, "traffic"))
    k = mix["sinusoids"]

    def unif(shape, lo_hi):
        lo, hi = lo_hi
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=device)

    f0 = unif((n, k, 1), mix["f0_hz"])
    amp = unif((n, k, 1), mix["amp"])
    mod = unif((n, k, 1), mix["mod_hz"])
    mod_ph = unif((n, k, 1), (0.0, 2 * math.pi))
    ph = unif((n, k, 1), (0.0, 2 * math.pi))
    alpha = unif((n, 1), mix["lowpass_alpha"])
    snr_db = unif((n, 1), mix["snr_db"])
    t = torch.arange(t_len, device=device, dtype=torch.float32) / sr
    noisy = torch.empty((n, t_len), device=device)
    clean = torch.empty((n, t_len), device=device)
    for s in range(0, n, MAKE_CLIPS):
        e = min(n, s + MAKE_CLIPS)
        sl = slice(s, e)
        env = 0.5 * (1.0 + torch.sin(2 * math.pi * mod[sl] * t + mod_ph[sl]))
        c = (amp[sl] * env * torch.sin(2 * math.pi * f0[sl] * t + ph[sl])
             ).sum(1)
        del env
        w = torch.randn((e - s, t_len), generator=g, device=device)
        a = alpha[sl]
        w = torch.cat([w[:, :1], a * w[:, :-1] + (1.0 - a) * w[:, 1:]], 1)
        p_c = (c * c).mean(1, keepdim=True) + 1e-9
        p_n = (w * w).mean(1, keepdim=True) + 1e-9
        w = w * torch.sqrt(p_c / (p_n * 10.0 ** (snr_db[sl] / 10.0)))
        clean[sl] = c
        noisy[sl] = c + w
    return noisy, clean


def schedule(mix: dict, seed: int, steps: int) -> np.ndarray:
    """Rows of the pool that each of ``steps`` steps takes, (steps, ranks *
    batch): passes over the pool in seeded orders, so that consecutive
    steps take distinct rows until the pool is spent."""
    per = mix["batch"] * mix.get("ranks", 1)
    n = mix["pool_clips"]
    if per > n:
        raise ValueError(f"a step takes {per} clips of a pool of {n}")
    r = rng(seed, "schedule")
    per_pass = n // per
    order = [r.permutation(n)[:per_pass * per].reshape(per_pass, per)
             for _ in range(-(-steps // per_pass))]
    return np.concatenate(order)[:steps]
