"""Diagonal linear-recurrence scans — the hot loop of every S5 model.

Computes ``x_t = λ ⊙ x_{t-1} + bu_t`` for a constant complex diagonal
``λ`` (shape (P,)) over the time axis of ``bu`` (..., L, P). Complex
numbers are carried as (re, im) pairs of real float32 tensors, the
layout the CUDA kernels read (counterpart of ``sparsernns_tpu/ops/scan.py``).

:func:`diag_ssm_scan` runs the hand-written diagonal-scan kernel
(``ops/cuda/diag_scan.py``), forward or reverse in time, which takes its
plain version (:func:`sequential_diag_scan`) only for a tensor on the CPU.
Without a carry the scan is differentiable (:class:`DiagScanFn`, the
counterpart of ``sparsernns_tpu/ops/pallas/scan_vjp.py``): the recurrence
is linear, so its adjoint is the same kernel run in the other direction
with conj(λ).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

Pair = Tuple[torch.Tensor, torch.Tensor]
#: (s_re, s_im, bits): the frozen grid of a blockwise state requant
BlockRequant = Tuple[float, float, int]


def complex_mul(a: Pair, b: Pair) -> Pair:
    """(a_re + i a_im) * (b_re + i b_im) as 4 real products."""
    ar, ai = a
    br, bi = b
    return ar * br - ai * bi, ar * bi + ai * br


def quant_codes(x: torch.Tensor, spec: Tuple[float, int]) -> torch.Tensor:
    """Integer codes (as float32) of x on a frozen (scale, bits) grid:
    round half to even, then clip."""
    s, bits = spec
    qmax = float(2 ** (bits - 1) - 1)
    return torch.clamp(torch.round(x / s), -(qmax + 1.0), qmax)


def grid_value(x: torch.Tensor, scale: float, bits: int) -> torch.Tensor:
    """x on a frozen symmetric grid: its ``bits``-bit codes times the
    scale."""
    return quant_codes(x, (scale, bits)) * scale


def sequential_diag_scan(lam: Pair, bu: Pair,
                         carry_init: Optional[Pair] = None,
                         state_requant: Optional[Callable[[Pair], Pair]] = None,
                         reverse: bool = False,
                         block_requant: Optional[BlockRequant] = None,
                         block_t: Optional[int] = None
                         ) -> Tuple[Pair, Pair]:
    """Step-by-step scan along axis -2. Returns (all states, final state).

    ``carry_init`` (..., P): the state before the first step (streaming).
    ``reverse`` walks time from the last row down (x_t = λ x_{t+1} + bu_t;
    the final state is then the one at t = 0); it takes no carry.
    ``state_requant`` is applied to the carried state after every step: the
    static-quant inference semantics, which no associative scan can
    express.

    ``block_requant`` (s_re, s_im, bits), forward only, is the serving
    engine's blockwise requant (the JAX kernel ``pallas_diag_scan``'s
    ``block_requant``): inside a time block of ``block_t`` steps the
    recurrence runs in float32 from the block's carry, every state of the
    block is output on the frozen grid, and the carry into the next block
    (and the final state) is the requantized last state of the block."""
    bu_r, bu_i = bu
    if reverse and carry_init is not None:
        raise NotImplementedError("carry with reverse scan")
    if block_requant is not None and (reverse or not block_t
                                      or block_t < 1):
        raise ValueError("block_requant runs forward, with block_t >= 1")
    if carry_init is None:
        x_r = torch.zeros_like(bu_r[..., 0, :])
        x_i = torch.zeros_like(bu_i[..., 0, :])
    else:
        x_r, x_i = carry_init
    out_r = torch.empty_like(bu_r)
    out_i = torch.empty_like(bu_i)
    length = bu_r.shape[-2]
    for t in (range(length - 1, -1, -1) if reverse else range(length)):
        ax_r, ax_i = complex_mul(lam, (x_r, x_i))
        x_r = ax_r + bu_r[..., t, :]
        x_i = ax_i + bu_i[..., t, :]
        if state_requant is not None:
            x_r, x_i = state_requant((x_r, x_i))
        if block_requant is None:
            out_r[..., t, :] = x_r
            out_i[..., t, :] = x_i
            continue
        s_re, s_im, bits = block_requant
        q_r, q_i = grid_value(x_r, s_re, bits), grid_value(x_i, s_im, bits)
        out_r[..., t, :] = q_r
        out_i[..., t, :] = q_i
        if (t + 1) % block_t == 0 or t + 1 == length:
            x_r, x_i = q_r, q_i
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


def _kernel_operand(pair: Pair) -> Pair:
    """A (B, L, P) pair as the kernel takes it: equal strides, unit stride
    in P (the halves of one (B, L, 2P) tensor pass as they are)."""
    a, b = pair
    if a.stride() != b.stride() or a.stride(-1) != 1:
        return a.contiguous(), b.contiguous()
    return a, b


def _dlam(v: Pair, xs: Pair, reverse: bool) -> Pair:
    """dλ = Σ_{b,t} v_t ⊙ conj(x_{t∓1}), the neighbour the step read; the
    open end (t = 0 forward, t = L-1 reverse) read a zero state."""
    axes = tuple(range(v[0].dim() - 1))
    near, far = (slice(None, -1), slice(1, None))
    if not reverse:
        near, far = far, near
    v_r, v_i = v[0][..., near, :], v[1][..., near, :]
    x_r, x_i = xs[0][..., far, :], xs[1][..., far, :]
    return ((v_r * x_r + v_i * x_i).sum(dim=axes),
            (v_i * x_r - v_r * x_i).sum(dim=axes))


class DiagScanFn(torch.autograd.Function):
    """Differentiable scan without a carry, either direction. Call as
    ``DiagScanFn.apply(lam_re, lam_im, bu_re, bu_im, reverse)``; returns the
    (B, L, P) state pair. The backward runs the kernel once more, in the
    other direction with conj(λ), on the cotangents: ``v`` is the gradient
    of ``bu``, and dλ sums ``v`` against the conjugate of the state each
    step read (plain tensor ops, as in the JAX package)."""

    @staticmethod
    def forward(ctx, lam_re, lam_im, bu_re, bu_im, reverse):
        from sparsernns_tpu_torch.ops.cuda.diag_scan import diag_scan
        xs = diag_scan((lam_re, lam_im), _kernel_operand((bu_re, bu_im)),
                       reverse=reverse)
        ctx.save_for_backward(lam_re, lam_im, *xs)
        ctx.reverse = reverse
        return xs

    @staticmethod
    def backward(ctx, g_re, g_im):
        from sparsernns_tpu_torch.ops.cuda.diag_scan import diag_scan
        lam_re, lam_im, x_re, x_im = ctx.saved_tensors
        v = diag_scan((lam_re, -lam_im), _kernel_operand((g_re, g_im)),
                      reverse=not ctx.reverse)
        d_re, d_im = _dlam(v, (x_re, x_im), ctx.reverse)
        return d_re, d_im, v[0], v[1], None


def diag_ssm_scan(lam: Pair, bu: Pair, reverse: bool = False,
                  carry_init: Optional[Pair] = None,
                  block_requant: Optional[BlockRequant] = None,
                  block_t: Optional[int] = None) -> Pair:
    """Scan through the diagonal-scan kernel. Returns all-prefix states
    (B, L, P): of x_t = λ x_{t-1} + bu_t, or with ``reverse`` of
    x_t = λ x_{t+1} + bu_t.

    Without a carry and a requant the call is differentiable in λ and bu.
    With ``carry_init`` (forward only, streaming) or ``block_requant``
    (forward only, per ``block_t`` steps: the serving engine's state
    requant, see :func:`sequential_diag_scan`) it is not, as in the JAX
    package: inputs that require grad raise while grad mode is on."""
    if carry_init is None and block_requant is None:
        return DiagScanFn.apply(lam[0], lam[1], bu[0], bu[1], reverse)
    if reverse:
        raise NotImplementedError(
            "the reverse scan takes no carry and no block requant")
    operands = (*lam, *bu, *(carry_init or ()))
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        raise NotImplementedError(
            "the scan with a carry or a block requant has no gradient: call "
            "it under torch.no_grad(), or without carry_init and "
            "block_requant")
    from sparsernns_tpu_torch.ops.cuda.diag_scan import diag_scan
    return diag_scan(lam, _kernel_operand(bu), carry_init=carry_init,
                     block_requant=block_requant, block_t=block_t)
