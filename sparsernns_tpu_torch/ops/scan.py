"""Diagonal linear-recurrence scans — the hot loop of every S5 model.

Computes ``x_t = λ ⊙ x_{t-1} + bu_t`` for a constant complex diagonal
``λ`` (shape (P,)) over the time axis of ``bu`` (..., L, P). Complex
numbers are carried as (re, im) pairs of real float32 tensors, the
layout the CUDA kernels read (counterpart of ``sparsernns_tpu/ops/scan.py``).

:func:`diag_ssm_scan` runs the hand-written diagonal-scan kernel
(``ops/cuda/diag_scan.py``), which takes its plain version
(:func:`sequential_diag_scan`) only for a tensor on the CPU.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

Pair = Tuple[torch.Tensor, torch.Tensor]


def complex_mul(a: Pair, b: Pair) -> Pair:
    """(a_re + i a_im) * (b_re + i b_im) as 4 real products."""
    ar, ai = a
    br, bi = b
    return ar * br - ai * bi, ar * bi + ai * br


def sequential_diag_scan(lam: Pair, bu: Pair,
                         carry_init: Optional[Pair] = None,
                         state_requant: Optional[Callable[[Pair], Pair]] = None
                         ) -> Tuple[Pair, Pair]:
    """Step-by-step scan along axis -2. Returns (all states, final state).

    ``carry_init`` (..., P): the state before the first step (streaming).
    ``state_requant`` is applied to the carried state after every step: the
    static-quant inference semantics, which no associative scan can
    express."""
    bu_r, bu_i = bu
    if carry_init is None:
        x_r = torch.zeros_like(bu_r[..., 0, :])
        x_i = torch.zeros_like(bu_i[..., 0, :])
    else:
        x_r, x_i = carry_init
    out_r = torch.empty_like(bu_r)
    out_i = torch.empty_like(bu_i)
    for t in range(bu_r.shape[-2]):
        ax_r, ax_i = complex_mul(lam, (x_r, x_i))
        x_r = ax_r + bu_r[..., t, :]
        x_i = ax_i + bu_i[..., t, :]
        if state_requant is not None:
            x_r, x_i = state_requant((x_r, x_i))
        out_r[..., t, :] = x_r
        out_i[..., t, :] = x_i
    return (out_r, out_i), (x_r, x_i)


def lambda_powers(lam: Pair, length: int) -> Pair:
    """λ^{t+1} for t in [0, length): a (length, P) pair, in polar form
    (|λ| < 1 after clip_eigs keeps every power in range)."""
    lr, li = lam
    r = torch.sqrt(lr * lr + li * li)
    theta = torch.atan2(li, lr)
    t = torch.arange(1, length + 1, dtype=lr.dtype, device=lr.device)[:, None]
    rk = torch.exp(t * torch.log(torch.clamp(r, min=1e-30)))
    ang = t * theta
    return rk * torch.cos(ang), rk * torch.sin(ang)


def diag_ssm_scan(lam: Pair, bu: Pair,
                  carry_init: Optional[Pair] = None) -> Pair:
    """Forward scan through the diagonal-scan kernel. Returns all-prefix
    states (B, L, P). The reverse scan is not ported yet."""
    from sparsernns_tpu_torch.ops.cuda.diag_scan import diag_scan
    return diag_scan(lam, bu, carry_init=carry_init)
