"""Kernel K1: the diagonal complex scan x_t = λ ⊙ x_{t-1} + bu_t, and
with ``reverse`` x_t = λ ⊙ x_{t+1} + bu_t.

Replaces ``sparsernns_tpu/ops/pallas/scan_kernel.py`` ``pallas_diag_scan``
(forward with an optional ``carry_init`` and an optional
``block_requant``, and ``reverse=True`` without either). The CUDA source is ``csrc/diag_scan.cu``; its header note gives the
bound and the design. The differentiable form is
``ops/scan.py`` :class:`~sparsernns_tpu_torch.ops.scan.DiagScanFn`.

:func:`diag_scan` launches the kernel for CUDA tensors and takes the plain
version :func:`diag_scan_plain` only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from sparsernns_tpu_torch.ops.cuda import build
from sparsernns_tpu_torch.ops.scan import (BlockRequant, Pair,
                                           sequential_diag_scan)

#: kernel launches made by :func:`diag_scan` in this process: forward in
#: time, reverse, and forward with the block requant (each launch counts
#: in one of the three)
launches = 0
launches_rev = 0
launches_requant = 0

_argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
              ctypes.c_longlong] + [ctypes.c_void_p] * 6
             + [ctypes.c_int] * 5 + [ctypes.c_float] * 4 + [ctypes.c_void_p])


def _check_requant(block_requant, block_t, reverse) -> None:
    if block_requant is None:
        return
    if reverse:
        raise NotImplementedError("block_requant with reverse scan")
    if block_t is None or block_t < 1:
        raise ValueError(f"block_requant needs block_t >= 1, got {block_t}")


def diag_scan_plain(lam: Pair, bu: Pair, carry_init: Optional[Pair] = None,
                    reverse: bool = False,
                    block_requant: Optional[BlockRequant] = None,
                    block_t: Optional[int] = None) -> Pair:
    """Plain PyTorch version: the sequential recurrence."""
    _check_requant(block_requant, block_t, reverse)
    return sequential_diag_scan(lam, bu, carry_init=carry_init,
                                reverse=reverse, block_requant=block_requant,
                                block_t=block_t)[0]


def _lib():
    lib = build.load("diag_scan")
    fn = lib.diag_scan_run
    if fn.argtypes is None:
        fn.argtypes = _argtypes
        fn.restype = ctypes.c_int
    return fn


def _check_f32_cuda(name: str, t: torch.Tensor, device) -> None:
    if t.dtype != torch.float32 or t.device != device:
        raise ValueError(f"{name}: expected float32 on {device}, got "
                         f"{t.dtype} on {t.device}")


def diag_scan_cuda(lam: Pair, bu: Pair, carry_init: Optional[Pair] = None,
                   reverse: bool = False,
                   block_requant: Optional[BlockRequant] = None,
                   block_t: Optional[int] = None) -> Pair:
    """Launch the kernel. bu: (B, L, P) pair whose last axis is unit-stride
    (the halves of a (B, L, 2P) projection are taken as they are);
    lam: (P,) pair; carry_init: (B, P) pair or None, and None with
    ``reverse``; ``block_requant`` (s_re, s_im, bits) per ``block_t``
    steps, forward only. Returns contiguous (B, L, P) states."""
    global launches, launches_rev, launches_requant
    if reverse and carry_init is not None:
        raise NotImplementedError("carry with reverse scan")
    _check_requant(block_requant, block_t, reverse)
    bu_re, bu_im = bu
    dev = bu_re.device
    if bu_re.dim() != 3 or bu_re.shape != bu_im.shape:
        raise ValueError(f"bu must be a (B, L, P) pair, got "
                         f"{tuple(bu_re.shape)} / {tuple(bu_im.shape)}")
    if bu_re.stride() != bu_im.stride() or bu_re.stride(-1) != 1:
        raise ValueError("bu halves need equal strides, unit-stride in P")
    b, l, p = bu_re.shape
    lam_re = lam[0].contiguous()
    lam_im = lam[1].contiguous()
    tensors = {"bu_re": bu_re, "bu_im": bu_im, "lam_re": lam_re,
               "lam_im": lam_im}
    c_re = c_im = None
    if carry_init is not None:
        c_re = carry_init[0].contiguous()
        c_im = carry_init[1].contiguous()
        if c_re.shape != (b, p) or c_im.shape != (b, p):
            raise ValueError(f"carry_init must be ({b}, {p}) pairs")
        tensors.update(c_re=c_re, c_im=c_im)
    for name, t in tensors.items():
        _check_f32_cuda(name, t, dev)
    if lam_re.shape != (p,) or lam_im.shape != (p,):
        raise ValueError(f"lam must be ({p},) pairs")
    out_re = torch.empty((b, l, p), dtype=torch.float32, device=dev)
    out_im = torch.empty_like(out_re)
    if b == 0 or l == 0 or p == 0:
        return out_re, out_im
    rq_t, s_re, s_im, qmax = 0, 1.0, 1.0, 0.0
    if block_requant is not None:
        s_re, s_im, bits = block_requant
        rq_t, qmax = int(block_t), 2.0 ** (bits - 1) - 1
    fn = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(bu_re.data_ptr(), bu_im.data_ptr(), bu_re.stride(0),
             bu_re.stride(1), lam_re.data_ptr(), lam_im.data_ptr(),
             c_re.data_ptr() if c_re is not None else None,
             c_im.data_ptr() if c_im is not None else None,
             out_re.data_ptr(), out_im.data_ptr(), b, l, p, int(reverse),
             rq_t, float(s_re), float(s_im), -(qmax + 1.0), qmax, stream)
    build.check(err, "diag_scan")
    if reverse:
        launches_rev += 1
    elif block_requant is not None:
        launches_requant += 1
    else:
        launches += 1
    return out_re, out_im


def diag_scan(lam: Pair, bu: Pair, carry_init: Optional[Pair] = None,
              reverse: bool = False,
              block_requant: Optional[BlockRequant] = None,
              block_t: Optional[int] = None) -> Pair:
    """All-prefix states of x_t = λ x_{t-1} + bu_t over bu (B, L, P), or
    with ``reverse`` of x_t = λ x_{t+1} + bu_t (no carry then). With
    ``block_requant`` every state is output on the frozen grid and the
    carry is put on it every ``block_t`` steps
    (:func:`~sparsernns_tpu_torch.ops.scan.sequential_diag_scan`).

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version."""
    fn = diag_scan_cuda if bu[0].is_cuda else diag_scan_plain
    return fn(lam, bu, carry_init, reverse, block_requant, block_t)
