"""Activation top-k sparsification (counterpart of
``sparsernns_tpu/ops/topk.py``).

The JAX package thresholds against the k-th value of
``jax.lax.approx_max_k``, which is exact on the CPU and approximate only on
a TPU. The port computes the exact k-th value with ``torch.topk``: values
equal to it are kept, so ties keep more than k entries, as in the JAX
package. No kernel of its own: the JAX package runs this as an XLA op.
Its ``jump_relu`` has no caller in either package and is not ported.
"""

from __future__ import annotations

import torch


def top_k_sparsity(x: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the entries of ``x`` at or above its k-th largest value along
    the last axis, zero the rest. Any leading shape; ``k >= n`` passes
    ``x`` through."""
    if k >= x.shape[-1]:
        return x
    threshold = torch.topk(x, k, dim=-1, sorted=True).values[..., -1:]
    return torch.where(x >= threshold, x, torch.zeros_like(x))


def relu_top_k_sparsity(x: torch.Tensor, k: int) -> torch.Tensor:
    return torch.relu(top_k_sparsity(x, k))
