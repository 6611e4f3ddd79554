"""Exact integer dots of quantized activations with int8 weights
(counterpart of ``sparsernns_tpu/ops/intdot.py``).

An activation on a frozen symmetric grid of up to 16 bits has integer
codes q in [-2^15, 2^15 - 1], which split exactly into two int8 planes

    q = 256 * hi + (lo - 128) + 128,
    hi = floor(q / 256)      in [-128, 127]
    lo = q - 256 * hi        in [0, 255]  ->  lo - 128 in [-128, 127]

so  q . W = 256 * (hi . W) + ((lo - 128) . W) + 128 * colsum(W),

every term an int8 x int8 -> int32 dot or a precomputed int32 column sum.
At 8 bits or fewer the codes are int8 themselves: one plane.

Formulas, chosen by the (padded) reduction dim K that the TPU kernels see:

- one int32 accumulator while K * 2^(bits-1) * 128 <= 2^31 - 1 (K <= 511
  at 16 bits: both grids clip to -2^(b-1), so a product reaches +2^22);
- beyond that, plane-wise: the hi-plane dot and the lo-plane dot plus the
  colsum term each in int32, combined by one float32 add,
  ``256 * f32(hi . W) + f32((lo - 128) . W + 128 * colsum)``; exact terms,
  valid to K = 65536 (:data:`MAX_REDUCTION_DIM`).

Every integer term is exact, so the result does not depend on summation
order: the engine's CUDA kernels (``ops/cuda/csrc/engine_body.cuh``,
``__dp4a`` on the planes) and these functions agree bit for bit, and both
equal the JAX package's.

How the int8 x int8 -> int32 contraction runs here (:func:`_dot_i8`): on
the CPU as an int64 ``torch.matmul``; on a CUDA device as a float64
``torch.matmul`` of the codes (integer matmul is not implemented there,
``torch._int_mm`` needs K a multiple of 8, and a float32 product is exact
only with TF32 off), which is exact since every partial sum stays below
2^53. Either result is cast to int32, the true value, so the int32
arithmetic that follows is JAX's. These functions are the plain version
the kernels are held against, and the engine's per-op route calls them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

#: largest (padded) reduction dim the plane-wise formula serves: the
#: lo-plane + colsum accumulator is bounded by K * 255 * 128 <= 2^31 - 1
MAX_REDUCTION_DIM = 65536

#: the formula of an integer dot: codes of 8 bits or fewer in one plane;
#: two planes in one int32 accumulator; two planes combined in float32
DOT_I8, DOT_I16, DOT_I16_PLANES = 1, 2, 3


def fits_int32(k_padded: int, a_bits: int = 16) -> bool:
    """Single-int32-accumulator condition of the two-plane formula:
    K * 2^(a_bits-1) * 128 <= 2^31 - 1."""
    return k_padded * (1 << (a_bits - 1)) * 128 <= 2 ** 31 - 1


def fits_planewise(k_padded: int) -> bool:
    """The plane-wise formula's budget: K <= 65536."""
    return k_padded <= MAX_REDUCTION_DIM


def dot_formula(k_padded: int, bits: int) -> int:
    """:data:`DOT_I8`, :data:`DOT_I16` or :data:`DOT_I16_PLANES` for a
    dot of ``bits``-bit codes over a reduction dim of ``k_padded``;
    ``ValueError`` past the plane-wise budget."""
    if bits <= 8:
        return DOT_I8
    if fits_int32(k_padded, bits):
        return DOT_I16
    if not fits_planewise(k_padded):
        raise ValueError(
            f"int16_dot: reduction dim {k_padded} exceeds the plane-wise "
            f"int32 budget ({MAX_REDUCTION_DIM}); run this dot in f32 "
            "(engine call sites gate on fits_planewise)")
    return DOT_I16_PLANES


def quantize_codes(x: torch.Tensor, scale: float, bits: int) -> torch.Tensor:
    """Integer codes (float32) of x on the frozen symmetric grid: round
    half to even, then clip to [-2^(b-1), 2^(b-1) - 1]."""
    qmax = float(2 ** (bits - 1) - 1)
    return torch.clamp(torch.round(x / scale), -(qmax + 1.0), qmax)


def i16_planes(q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Integer-valued float codes in [-2^15, 2^15 - 1] -> the two exact
    int8 planes (hi, lo - 128)."""
    hi = torch.floor(q * (1.0 / 256.0))
    lo = q - hi * 256.0 - 128.0
    return hi.to(torch.int8), lo.to(torch.int8)


def weight_colsum(w_i8) -> torch.Tensor:
    """int32 column sums of an int8 weight (K, N): the +128 correction
    row of the two-plane formula. Takes a tensor or a numpy array."""
    return torch.as_tensor(w_i8).to(torch.int64).sum(0).to(torch.int32)


def _dot_i8(a_i8: torch.Tensor, w_i8: torch.Tensor) -> torch.Tensor:
    """int8 x int8 -> int32 contraction over a's last and w's first dim,
    exact (module docstring)."""
    if a_i8.is_cuda:
        acc = a_i8.to(torch.float64) @ w_i8.to(torch.float64)
        return acc.to(torch.int64).to(torch.int32)
    return (a_i8.to(torch.int64) @ w_i8.to(torch.int64)).to(torch.int32)


def int16_dot(x: Optional[torch.Tensor], w_i8: torch.Tensor,
              colsum_i32: Optional[torch.Tensor], in_scale: float, bits: int,
              codes: Optional[torch.Tensor] = None,
              reduction_dim: Optional[int] = None) -> torch.Tensor:
    """The float32 ACCUMULATOR of ``codes(x) @ w_i8``, x quantized at
    (in_scale, bits); the caller multiplies by in_scale * w_scale.

    ``codes``: integer codes (float-valued) already on the grid, e.g.
    states the scan put there; x is then not read. ``reduction_dim``: the
    K that picks the formula, where the TPU kernels pad the operand
    (defaults to the codes' last dim)."""
    q = quantize_codes(x, in_scale, bits) if codes is None else codes
    k = q.shape[-1] if reduction_dim is None else reduction_dim
    formula = dot_formula(k, bits)
    if formula == DOT_I8:
        return _dot_i8(q.to(torch.int8), w_i8).to(torch.float32)
    hi, lo = i16_planes(q)
    cs = colsum_i32 * 128
    if formula == DOT_I16:
        return (_dot_i8(hi, w_i8) * 256 + _dot_i8(lo, w_i8)
                + cs).to(torch.float32)
    return (_dot_i8(hi, w_i8).to(torch.float32) * 256.0
            + (_dot_i8(lo, w_i8) + cs).to(torch.float32))
