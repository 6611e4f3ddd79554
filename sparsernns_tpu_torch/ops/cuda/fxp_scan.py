"""The fixed-point engine's integer recurrence as one CUDA kernel.

Computes what ``sparsernns_tpu/fxp/model.py`` ``FxpSSM.__call__`` runs as
``jax.lax.scan`` over ``step`` (``:362-378``; no ``pallas_call``): per
(batch row, state channel), from a zero state,

    prod_rr = (a_re * x_re) >> s_re      prod_ii = (a_im * x_im) >> s_im
    prod_ri = (a_re * x_im) >> s_re      prod_ir = (a_im * x_re) >> s_im
    acc_re  = prod_rr - prod_ii + (bu_re[t] << g)
    acc_im  = prod_ri + prod_ir + (bu_im[t] << g)
    x_re    = clip(round_half_even(acc_re >> g), lo_re, hi_re)
    x_im    = clip(round_half_even(acc_im >> g), lo_im, hi_im)

in int32 two's complement with XLA's wrap, right shifts arithmetic, where
s = a.exp - g. ``bu`` comes in already aligned to the state exponents (the
shifts of ``:331-340`` stay with the caller, as in JAX); no carry comes in
or goes out.

The CUDA source is ``csrc/fxp_scan.cu``: one thread owns one (batch row,
channel) pair, re and im together, and walks t = 0 .. L-1.
:func:`fxp_scan` launches it for CUDA tensors (or raises) and takes
:func:`fxp_scan_plain`, the step-by-step PyTorch loop, only for CPU
tensors. The two are equal bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from sparsernns_tpu_torch.fxp.array import RoundingMode, fxp_rshift_round
from sparsernns_tpu_torch.ops.cuda import build
from sparsernns_tpu_torch.utils.trace import count, traced


def _check_args(bu_r, bu_i, a_re, a_im, shifts, g, bounds_r, bounds_i):
    if bu_r.dim() != 3 or bu_r.shape != bu_i.shape:
        raise ValueError(f"bu must be two (B, L, P) tensors, got "
                         f"{tuple(bu_r.shape)} and {tuple(bu_i.shape)}")
    p = bu_r.shape[-1]
    if a_re.shape != (p,) or a_im.shape != (p,):
        raise ValueError(f"a must be two ({p},) tensors, got "
                         f"{tuple(a_re.shape)} and {tuple(a_im.shape)}")
    for t in (bu_r, bu_i, a_re, a_im):
        if t.dtype != torch.int32 or t.device != bu_r.device:
            raise ValueError("every operand must be int32 on bu's device")
    if not all(0 <= s < 32 for s in (*shifts, g)):
        raise ValueError(f"shifts {shifts} and g {g} must be in [0, 32)")
    for lo, hi in (bounds_r, bounds_i):
        if not -2 ** 31 <= lo <= hi < 2 ** 31:
            raise ValueError(f"clip bounds ({lo}, {hi}) outside int32")


def fxp_scan_plain(bu_r: torch.Tensor, bu_i: torch.Tensor,
                   a_re: torch.Tensor, a_im: torch.Tensor,
                   shifts: Tuple[int, int], g: int,
                   bounds_r: Tuple[int, int], bounds_i: Tuple[int, int]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the JAX ``step`` over t, int32 ops that
    wrap as XLA's. Returns (xs_re, xs_im), int32 (B, L, P)."""
    _check_args(bu_r, bu_i, a_re, a_im, shifts, g, bounds_r, bounds_i)
    s_re, s_im = shifts
    xr = torch.zeros_like(bu_r[:, 0])
    xi = torch.zeros_like(bu_i[:, 0])
    xs_r = torch.empty_like(bu_r)
    xs_i = torch.empty_like(bu_i)
    rnd = RoundingMode.ROUND
    for t in range(bu_r.shape[1]):
        prod_rr = (a_re * xr) >> s_re
        prod_ii = (a_im * xi) >> s_im
        prod_ri = (a_re * xi) >> s_re
        prod_ir = (a_im * xr) >> s_im
        acc_r = prod_rr - prod_ii + (bu_r[:, t] << g)
        acc_i = prod_ri + prod_ir + (bu_i[:, t] << g)
        xr = torch.clamp(fxp_rshift_round(acc_r, g, rnd), *bounds_r)
        xi = torch.clamp(fxp_rshift_round(acc_i, g, rnd), *bounds_i)
        xs_r[:, t] = xr
        xs_i[:, t] = xi
    return xs_r, xs_i


_FWD_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p]


@traced("kernel.fxp_scan")
def fxp_scan_cuda(bu_r: torch.Tensor, bu_i: torch.Tensor,
                  a_re: torch.Tensor, a_im: torch.Tensor,
                  shifts: Tuple[int, int], g: int,
                  bounds_r: Tuple[int, int], bounds_i: Tuple[int, int]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the kernel for all of (B, L, P). Same arguments as
    :func:`fxp_scan_plain`, every tensor on one CUDA device."""
    _check_args(bu_r, bu_i, a_re, a_im, shifts, g, bounds_r, bounds_i)
    if not bu_r.is_cuda:
        raise ValueError("fxp_scan_cuda needs CUDA tensors")
    bu_r, bu_i = bu_r.contiguous(), bu_i.contiguous()
    a_re, a_im = a_re.contiguous(), a_im.contiguous()
    xs_r = torch.empty_like(bu_r)
    xs_i = torch.empty_like(bu_i)
    b, length, p = bu_r.shape
    if bu_r.numel() == 0:
        return xs_r, xs_i
    err = build.entry("fxp_scan", "fxp_scan_fwd", _FWD_ARGS)(
        bu_r.data_ptr(), bu_i.data_ptr(), a_re.data_ptr(), a_im.data_ptr(),
        xs_r.data_ptr(), xs_i.data_ptr(), b, length, p, shifts[0],
        shifts[1], g, bounds_r[0], bounds_r[1], bounds_i[0], bounds_i[1],
        torch.cuda.current_stream(bu_r.device).cuda_stream)
    build.check(err, "fxp_scan")
    count("fxp_scan")
    return xs_r, xs_i


def fxp_scan(bu_r: torch.Tensor, bu_i: torch.Tensor, a_re: torch.Tensor,
             a_im: torch.Tensor, shifts: Tuple[int, int], g: int,
             bounds_r: Tuple[int, int], bounds_i: Tuple[int, int]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The integer recurrence on (B, L, P) codes. CUDA tensors launch the
    kernel (or raise); CPU tensors take the plain version."""
    fn = fxp_scan_cuda if bu_r.is_cuda else fxp_scan_plain
    return fn(bu_r, bu_i, a_re, a_im, shifts, g, bounds_r, bounds_i)
