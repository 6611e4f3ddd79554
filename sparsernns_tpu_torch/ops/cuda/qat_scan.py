"""Kernel K1 in its QAT mode: the diagonal complex scan with in-scan
activation fake-quant, forward or reverse in time, with an optional carry.

Replaces ``sparsernns_tpu/ops/pallas/scan_kernel.py`` ``pallas_diag_scan``
with ``qat_bits=(a_bits, act_bits)`` (body ``scan_block_body``). Over time
blocks of ``t = min(block_t, ceil8(L))`` rows, L padded with zero rows to a
multiple of t (padded rows are numerics here: they enter the shifted
operands and the last block's output scale), per batch row and block:

1. doubling passes k = 0 … num_passes-1, d = 2^k: the block shifted down
   by d rows (d zero rows in front) is fake-quantized to ``act_bits`` on
   the absmax of the whole shifted (t, P) block (each half its own scale,
   or one given global absmax), and x += λ^(2^k) ⊙ shifted;
2. the carry fold: the carry row, fake-quantized on the absmax over its P
   channels, times the λ^(r+1) table, is added to every row r;
3. the whole folded block is fake-quantized on its own absmax; its last
   row is the carry into the next block.

The λ tables (:func:`lambda_power_tables`) are built with PyTorch ops on
the device, as the JAX package builds them outside its kernel: the powers
λ^(2^k) by repeated squaring, each fake-quantized to ``a_bits`` before it
is squared, and the carry-fold table λ^(r+1), fake-quantized as a whole.
An incoming carry c is not fake-quantized: λ·c is added to the first row
of bu before the scan, as the JAX package does. ``reverse`` scans the
flipped sequence, so blocks start at the end and the padding lies before
time 0.

:func:`qat_scan` launches the kernel (``csrc/qat_scan.cu``, whose header
note gives the bound and the design) for CUDA tensors and takes the plain
version :func:`qat_scan_plain` only for tensors on the CPU.
:func:`qat_blocks_plain` is the part shared with the mixer's QAT mode
(``ops/cuda/fused_s5.py`` ``fused_s5_qat``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from sparsernns_tpu_torch.ops.cuda import build
from sparsernns_tpu_torch.ops.cuda.diag_scan import _check_f32_cuda
from sparsernns_tpu_torch.ops.scan import Pair, QatBits, lambda_powers
from sparsernns_tpu_torch.quantize.qat import _on_grid, dyn_fake_quant

#: kernel launches made by :func:`qat_scan` in this process (one a call:
#: the passes and the carry walk)
launches = 0

#: (pow_re, pow_im (K, P), ctab_re, ctab_im (t, P))
Tables = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def scan_geometry(length: int, block_t: int) -> Tuple[int, int, int]:
    """(t, L_pad, num_passes) of a sequence of ``length`` rows: the time
    block min(block_t, ceil8(L)), L padded to a multiple of it, and the
    number of doubling passes max(1, bit_length(t - 1))."""
    if block_t is None or block_t < 1:
        raise ValueError(f"the QAT scan needs block_t >= 1, got {block_t}")
    t = min(block_t, -(-max(length, 1) // 8) * 8)
    return t, -(-length // t) * t, max(1, (t - 1).bit_length())


def _check_bits(qat_bits: QatBits) -> Tuple[Optional[int], int]:
    a_bits, act_bits = qat_bits
    if act_bits is None:
        raise ValueError("the QAT scan needs act_bits (qat_bits[1])")
    return a_bits, act_bits


def lambda_power_tables(lam: Pair, t: int, num_passes: int,
                        a_bits: Optional[int]) -> Tables:
    """The scan's λ tables: (pow_re, pow_im) (num_passes, P), row k the
    fake-quantized λ^(2^k), and (ctab_re, ctab_im) (t, P), row r the
    fake-quantized λ^(r+1). Every fake-quant is per half, on ``a_bits``."""
    lr, li = lam
    rows_re, rows_im = [], []
    for _ in range(num_passes):
        lr, li = dyn_fake_quant(lr, a_bits), dyn_fake_quant(li, a_bits)
        rows_re.append(lr)
        rows_im.append(li)
        lr, li = lr * lr - li * li, 2.0 * lr * li
    c_re, c_im = lambda_powers(lam, t)
    return (torch.stack(rows_re), torch.stack(rows_im),
            dyn_fake_quant(c_re, a_bits), dyn_fake_quant(c_im, a_bits))


def _fq(x: torch.Tensor, bits: int, dims, amax: Optional[torch.Tensor]
        ) -> torch.Tensor:
    """Fake-quant with one absmax per slice over ``dims`` (or ``amax``)."""
    if bits >= 32:
        return x
    if amax is None:
        amax = x.abs().amax(dim=dims, keepdim=True)
    return _on_grid(x, amax, bits)


def qat_blocks_plain(x: Pair, tables: Tables, t: int, act_bits: int,
                     amax: Optional[torch.Tensor] = None) -> Pair:
    """The QAT scan of zero-carry blocks (B, L_pad, P) pair, L_pad a
    multiple of ``t``: the doubling passes vectorised over (B, blocks), then
    a loop over the blocks for the carry fold and the output fake-quant.
    ``amax``: one global absmax for every state fake-quant."""
    pow_re, pow_im, ct_re, ct_im = tables
    b, l_pad, p = x[0].shape
    nb = l_pad // t
    x_re, x_im = (a.reshape(b, nb, t, p) for a in x)
    blk = (-2, -1)
    for k in range(pow_re.shape[0]):
        d = 1 << k
        sh_re = _fq(F.pad(x_re[..., :t - d, :], (0, 0, d, 0)), act_bits, blk,
                    amax)
        sh_im = _fq(F.pad(x_im[..., :t - d, :], (0, 0, d, 0)), act_bits, blk,
                    amax)
        lr, li = pow_re[k], pow_im[k]
        x_re, x_im = (x_re + (lr * sh_re - li * sh_im),
                      x_im + (lr * sh_im + li * sh_re))
    c_re = x_re.new_zeros((b, p))
    c_im = x_im.new_zeros((b, p))
    out_re, out_im = [], []
    for j in range(nb):
        cr = _fq(c_re, act_bits, (-1,), amax)[:, None, :]
        ci = _fq(c_im, act_bits, (-1,), amax)[:, None, :]
        y_re = _fq(x_re[:, j] + (ct_re * cr - ct_im * ci), act_bits, blk,
                   amax)
        y_im = _fq(x_im[:, j] + (ct_re * ci + ct_im * cr), act_bits, blk,
                   amax)
        out_re.append(y_re)
        out_im.append(y_im)
        c_re, c_im = y_re[:, -1], y_im[:, -1]
    return torch.cat(out_re, dim=1), torch.cat(out_im, dim=1)


def _check_args(bu: Pair, carry_init: Optional[Pair], reverse: bool):
    if reverse and carry_init is not None:
        raise NotImplementedError("carry with reverse scan")
    if bu[0].dim() != 3 or bu[0].shape != bu[1].shape:
        raise ValueError(f"bu must be a (B, L, P) pair, got "
                         f"{tuple(bu[0].shape)} / {tuple(bu[1].shape)}")


def qat_scan_plain(lam: Pair, bu: Pair, qat_bits: QatBits, block_t: int,
                   reverse: bool = False,
                   carry_init: Optional[Pair] = None) -> Pair:
    """Plain PyTorch version of :func:`qat_scan`."""
    _check_args(bu, carry_init, reverse)
    a_bits, act_bits = _check_bits(qat_bits)
    bu_re, bu_im = bu
    length = bu_re.shape[1]
    t, l_pad, n_pass = scan_geometry(length, block_t)
    if carry_init is not None:
        lr, li = lam
        cr, ci = carry_init
        bu_re = torch.cat([bu_re[:, :1] + (lr * cr - li * ci)[:, None],
                           bu_re[:, 1:]], dim=1)
        bu_im = torch.cat([bu_im[:, :1] + (lr * ci + li * cr)[:, None],
                           bu_im[:, 1:]], dim=1)
    if reverse:
        bu_re, bu_im = bu_re.flip(1), bu_im.flip(1)
    pad = (0, 0, 0, l_pad - length)
    xs = qat_blocks_plain((F.pad(bu_re, pad), F.pad(bu_im, pad)),
                          lambda_power_tables(lam, t, n_pass, a_bits), t,
                          act_bits)
    xs = (xs[0][:, :length], xs[1][:, :length])
    if reverse:
        xs = (xs[0].flip(1), xs[1].flip(1))
    return xs


def _lib():
    fn = build.load("qat_scan").qat_scan_run
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2
                       + [ctypes.c_void_p] * 6 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def qat_scan_cuda(lam: Pair, bu: Pair, qat_bits: QatBits, block_t: int,
                  reverse: bool = False,
                  carry_init: Optional[Pair] = None) -> Pair:
    """Launch the kernel. bu: (B, L, P) pair with equal strides, unit
    stride in P; lam (P,) pair; carry_init (B, P) pair or None. Returns
    contiguous (B, L, P) states."""
    global launches
    _check_args(bu, carry_init, reverse)
    a_bits, act_bits = _check_bits(qat_bits)
    bu_re, bu_im = bu
    dev = bu_re.device
    if bu_re.stride() != bu_im.stride() or bu_re.stride(-1) != 1:
        raise ValueError("bu halves need equal strides, unit-stride in P")
    b, length, p = bu_re.shape
    lam_re, lam_im = lam[0].contiguous(), lam[1].contiguous()
    tensors = {"bu_re": bu_re, "bu_im": bu_im, "lam_re": lam_re,
               "lam_im": lam_im}
    c_ptr = [None, None]
    if carry_init is not None:
        c_re, c_im = (c.contiguous() for c in carry_init)
        if c_re.shape != (b, p) or c_im.shape != (b, p):
            raise ValueError(f"carry_init must be ({b}, {p}) pairs")
        tensors.update(c_re=c_re, c_im=c_im)
        c_ptr = [c_re.data_ptr(), c_im.data_ptr()]
    for name, t in tensors.items():
        _check_f32_cuda(name, t, dev)
    if lam_re.shape != (p,) or lam_im.shape != (p,):
        raise ValueError(f"lam must be ({p},) pairs")
    out_re = torch.empty((b, length, p), dtype=torch.float32, device=dev)
    out_im = torch.empty_like(out_re)
    if b == 0 or length == 0 or p == 0:
        return out_re, out_im
    t, l_pad, n_pass = scan_geometry(length, block_t)
    tables = [x.contiguous() for x in lambda_power_tables(
        (lam_re, lam_im), t, n_pass, a_bits)]
    scratch = torch.empty((2, b, l_pad, 2 * p), dtype=torch.float32,
                          device=dev)
    err = _lib()(
        bu_re.data_ptr(), bu_im.data_ptr(), bu_re.stride(0),
        bu_re.stride(1), lam_re.data_ptr(), lam_im.data_ptr(), *c_ptr,
        tables[0].data_ptr(), tables[1].data_ptr(), n_pass,
        tables[2].data_ptr(), tables[3].data_ptr(), scratch[0].data_ptr(),
        scratch[1].data_ptr(), out_re.data_ptr(), out_im.data_ptr(), b,
        length, p, t, int(reverse), act_bits,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "qat_scan")
    launches += 1
    return out_re, out_im


def qat_scan(lam: Pair, bu: Pair, qat_bits: QatBits, block_t: int,
             reverse: bool = False,
             carry_init: Optional[Pair] = None) -> Pair:
    """All-prefix states (B, L, P) of the QAT scan over bu (B, L, P):
    x_t = λ x_{t-1} + bu_t, or with ``reverse`` x_t = λ x_{t+1} + bu_t (no
    carry then), with the in-scan fake-quant of ``qat_bits``
    (a_bits, act_bits) over time blocks of ``block_t``. Not
    differentiable (``ops/scan.py`` ``DiagScanFn`` is).

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version."""
    fn = qat_scan_cuda if bu[0].is_cuda else qat_scan_plain
    return fn(lam, bu, qat_bits, block_t, reverse, carry_init)
