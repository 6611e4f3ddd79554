"""Fixed-point integer tensors (counterpart of ``sparsernns_tpu/fxp/array.py``):
``FxpArray`` / ``ComplexFxpArray``, integer codes with a static
(bits, exp, signed) format, value = data / 2^exp, and the shift-round,
add, multiply, matmul, top-k, log-softmax and mean of the integer engine.

Every op gives the JAX package's integers bit for bit:

- the codes are int32 tensors and int32 arithmetic wraps as XLA's does
  (PyTorch's int32 add, multiply and shifts wrap; a left shift by 32 or
  more gives 0 and an arithmetic right shift by 32 or more the sign, as
  XLA's); where the JAX package widens to int64 (``_needs_wide``, the
  aligned adds and up-shifts past 31 bits) this module computes in int64
  and casts back to int32, which wraps as JAX's ``astype`` does;
- the wide dtype of ``fxp_mean`` and ``fxp_log_softmax``'s sums is int32,
  the JAX package's while its x64 flag is off (its default, and the
  tests' ``conftest.py``): those sums wrap in int32;
- an integer dot is exact: an int64 ``torch.matmul`` on the CPU; on a
  CUDA device, where PyTorch has no integer matmul, float64 matmuls of
  the codes, whole where every partial sum stays below 2^53 and split in
  16-bit limbs otherwise (:func:`_int_dot`); the exact sum is then cast
  to the accumulator's dtype, which wraps an int32 accumulator exactly as
  XLA's int32 ``dot_general`` does;
- host packing (a numpy array in) stays in numpy, as in the JAX package,
  so the packed codes are numpy's float32 arithmetic's.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

#: the dtype of the JAX package's ``_wide_dtype()`` with its x64 flag off
WIDE_DTYPE = torch.int32


class RoundingMode(enum.Enum):
    FLOOR = 0
    CEIL = 1
    ROUND = 2
    STOCHASTIC = 3


def _tensor(x, like: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x`` as a tensor, a numpy array moved to ``like``'s device."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x),
                           device=None if like is None else like.device)


def _to_int(x: torch.Tensor, dtype=torch.int32) -> torch.Tensor:
    """Float (already integral) -> ``dtype``, saturating at int32's range
    as XLA's float-to-int conversion does."""
    return x.double().clamp(-2.0 ** 31, 2.0 ** 31 - 1).to(dtype)


def round_array(x, round_mode: RoundingMode = RoundingMode.FLOOR,
                dtype=None):
    """Round float values to integers: numpy in, numpy out (host
    packing), a tensor in, a tensor out."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
        dtype = np.int32 if dtype is None else dtype
        if round_mode == RoundingMode.ROUND:
            return np.round(x).astype(dtype)
        if round_mode == RoundingMode.CEIL:
            return np.ceil(x).astype(dtype)
        if round_mode == RoundingMode.FLOOR:
            return np.floor(x).astype(dtype)
        raise NotImplementedError(f"rounding mode {round_mode}")
    dtype = torch.int32 if dtype is None else dtype
    if round_mode == RoundingMode.ROUND:   # half to even, as jnp.round
        return _to_int(torch.round(x), dtype)
    if round_mode == RoundingMode.CEIL:
        return _to_int(torch.ceil(x), dtype)
    if round_mode == RoundingMode.FLOOR:
        return _to_int(torch.floor(x), dtype)
    raise NotImplementedError(f"rounding mode {round_mode}")


def fxp_rshift_round(x: torch.Tensor, rshift: int,
                     round_mode: RoundingMode = RoundingMode.FLOOR
                     ) -> torch.Tensor:
    """Arithmetic right shift with rounding: FLOOR, CEIL, or ROUND as
    round half to EVEN (the float static-quant path rounds ties to
    even)."""
    if rshift == 0:
        return x
    if round_mode == RoundingMode.FLOOR:
        return x >> rshift
    if round_mode == RoundingMode.CEIL:
        return (x + (1 << rshift) - 1) >> rshift
    if round_mode == RoundingMode.ROUND:
        half = 1 << (rshift - 1)
        q = (x + half) >> rshift
        tie = (x & ((1 << rshift) - 1)) == half
        return torch.where(tie, q - (q & 1), q)
    raise NotImplementedError(f"rounding mode {round_mode}")


@dataclasses.dataclass
class FxpArray:
    """Integer tensor with fixed-point interpretation value = data / 2^exp.
    ``data`` is a tensor, or a numpy array straight from host packing."""

    data: torch.Tensor
    bits: int = 16
    exp: int = 8
    signed: bool = True

    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def ndim(self):
        return self.data.ndim

    def minval(self) -> int:
        return -(1 << (self.bits - 1)) if self.signed else 0

    def maxval(self) -> int:
        return (1 << (self.bits - 1)) - 1 if self.signed else (1 << self.bits) - 1

    def to_float(self) -> torch.Tensor:
        return _tensor(self.data).to(torch.float32) / (1 << self.exp)

    def clip(self) -> "FxpArray":
        if isinstance(self.data, torch.Tensor):
            data = torch.clamp(self.data, self.minval(), self.maxval())
        else:
            data = np.asarray(np.clip(self.data, self.minval(),
                                      self.maxval()))
        return FxpArray(data, self.bits, self.exp, self.signed)

    def overflow_count(self) -> torch.Tensor:
        d = _tensor(self.data)
        return ((d > self.maxval()) | (d < self.minval())).sum()

    def change_exp(self, new_exp: int,
                   round_mode: RoundingMode = RoundingMode.FLOOR) -> "FxpArray":
        return fxp_change_exp(self, new_exp, round_mode)

    def change_cfg(self, new_bits: int, new_exp: int, new_signed: bool,
                   round_mode: RoundingMode = RoundingMode.FLOOR) -> "FxpArray":
        return fxp_change_cfg(self, new_bits, new_exp, new_signed, round_mode)

    def astype_wide(self) -> "FxpArray":
        return FxpArray(_tensor(self.data).to(WIDE_DTYPE), self.bits,
                        self.exp, self.signed)

    def to(self, device) -> "FxpArray":
        return FxpArray(_tensor(self.data).to(device), self.bits, self.exp,
                        self.signed)

    def __add__(self, other):
        return fxp_add(self, other)

    def __sub__(self, other):
        return fxp_sub(self, other)

    def __mul__(self, other):
        return fxp_mul(self, other)

    def __matmul__(self, other):
        return fxp_matmul(self, other)

    def __getitem__(self, idx):
        return FxpArray(self.data[idx], self.bits, self.exp, self.signed)


@dataclasses.dataclass
class ComplexFxpArray:
    real: FxpArray
    imag: FxpArray

    @property
    def shape(self):
        return self.real.shape

    def to_float(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.real.to_float(), self.imag.to_float()

    def to(self, device) -> "ComplexFxpArray":
        return ComplexFxpArray(self.real.to(device), self.imag.to(device))

    def __add__(self, other):
        return ComplexFxpArray(real=self.real + other.real,
                               imag=self.imag + other.imag)

    def __getitem__(self, idx):
        return ComplexFxpArray(self.real[idx], self.imag[idx])


def fxp_from_fp(x, bits: int = 16, exp: int = 8, signed: bool = True,
                round_mode: RoundingMode = RoundingMode.FLOOR) -> FxpArray:
    """Quantize float -> fxp. numpy in -> numpy out (host packing)."""
    xint = x * (1 << exp)
    if not signed:
        xint = xint.abs() if isinstance(xint, torch.Tensor) else np.abs(xint)
    data = round_array(xint, round_mode)
    return FxpArray(data=data, bits=bits, exp=exp, signed=signed).clip()


def _wide(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64)


def _narrow(arr: FxpArray) -> FxpArray:
    """A clipped wide result back in int32."""
    return FxpArray(arr.data.to(torch.int32), arr.bits, arr.exp, arr.signed)


def fxp_change_exp(arr: FxpArray, new_exp: int,
                   round_mode: RoundingMode = RoundingMode.FLOOR) -> FxpArray:
    if new_exp == arr.exp:
        return arr
    data = _tensor(arr.data)
    if new_exp > arr.exp:
        shift = new_exp - arr.exp
        # an up-shift past 31 bits is clipped in int64 (JAX's _wide_ctx)
        wide = arr.bits + shift > 31
        data = (_wide(data) if wide else data) << shift
        if wide:
            return _narrow(FxpArray(data, arr.bits, new_exp,
                                    arr.signed).clip())
    else:
        data = fxp_rshift_round(data, arr.exp - new_exp, round_mode)
    return FxpArray(data, arr.bits, new_exp, arr.signed).clip()


def fxp_change_cfg(arr: FxpArray, new_bits: int, new_exp: int,
                   new_signed: bool,
                   round_mode: RoundingMode = RoundingMode.FLOOR) -> FxpArray:
    if (arr.bits, arr.exp, arr.signed) == (new_bits, new_exp, new_signed):
        return arr
    out = fxp_change_exp(arr, new_exp, round_mode)
    return FxpArray(out.data, new_bits, new_exp, new_signed).clip()


def _operands(op1: FxpArray, op2: FxpArray):
    a = _tensor(op1.data)
    if not isinstance(op1.data, torch.Tensor) and isinstance(op2.data,
                                                             torch.Tensor):
        a = a.to(op2.data.device)
    return a, _tensor(op2.data, a)


def fxp_add(op1: FxpArray, op2: FxpArray,
            result_bits: Optional[int] = None,
            result_bits_fn: Callable[[int, int], int] = max,
            result_bits_add: int = 0,
            result_exp: Optional[int] = None,
            round_mode: RoundingMode = RoundingMode.FLOOR) -> FxpArray:
    """Aligned integer addition, clipped to ``result_bits``."""
    result_signed = op1.signed or op2.signed
    if result_bits is None:
        result_bits = result_bits_fn(op1.bits, op2.bits) + result_bits_add
    if result_exp is None:
        result_exp = max(op1.exp, op2.exp)
        s1, s2 = result_exp - op1.exp, result_exp - op2.exp
        # the aligned operands' sum can pass int32: add in int64
        wide = max(op1.bits + s1, op2.bits + s2) + 1 > 31
        a, b = _operands(op1, op2)
        if wide:
            a, b = _wide(a), _wide(b)
        a = a << s1 if s1 else a
        b = b << s2 if s2 else b
        data = a + b
    else:
        wide = max(op1.bits, op2.bits) + 1 > 31
        a, b = _operands(fxp_change_exp(op1, result_exp, round_mode),
                         fxp_change_exp(op2, result_exp, round_mode))
        if wide:
            a, b = _wide(a), _wide(b)
        data = a + b
    out = FxpArray(data, result_bits, result_exp, result_signed).clip()
    return _narrow(out) if wide else out


def fxp_sub(op1: FxpArray, op2: FxpArray, **kw) -> FxpArray:
    neg = FxpArray(-_tensor(op2.data), op2.bits, op2.exp, signed=True)
    return fxp_add(op1, neg, **kw)


def _needs_wide(op1: FxpArray, op2: FxpArray) -> bool:
    """True when the product could overflow an int32 accumulator."""
    return op1.bits + op2.bits > 30


def _maybe_widen(op1: FxpArray, op2: FxpArray):
    a, b = _operands(op1, op2)
    if _needs_wide(op1, op2):
        return _wide(a), _wide(b)
    return a, b


def fxp_mul(op1: FxpArray, op2: FxpArray,
            result_exp: Optional[int] = None,
            result_exp_fn: Callable[[int, int], int] = max,
            result_bits: Optional[int] = None,
            result_bits_fn: Callable[[int, int], int] = max,
            round_mode: RoundingMode = RoundingMode.FLOOR) -> FxpArray:
    """Elementwise integer multiply, then shift-round to the target
    exponent."""
    result_signed = op1.signed or op2.signed
    if result_bits is None:
        result_bits = result_bits_fn(op1.bits, op2.bits)
    if result_exp is None:
        result_exp = result_exp_fn(op1.exp, op2.exp)
    rshift = op1.exp + op2.exp - result_exp
    if rshift < 0:
        raise ValueError(f"invalid result_exp {result_exp} > "
                         f"{op1.exp} + {op2.exp}")
    a, b = _maybe_widen(op1, op2)
    data = fxp_rshift_round(a * b, rshift, round_mode).to(torch.int32)
    return FxpArray(data, result_bits, result_exp, result_signed).clip()


def _magnitude_bits(arr: FxpArray) -> int:
    """|code| < 2^this for a code clipped to ``arr``'s format."""
    return arr.bits - 1 if arr.signed else arr.bits


def _int_dot(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype,
             magnitude_bits: int = 64,
             float64: Optional[bool] = None) -> torch.Tensor:
    """Exact contraction of a's last dim with b's first, cast to ``dtype``
    (an int32 accumulator wraps as XLA's). On the CPU an int64 matmul; on
    a CUDA device (``float64`` defaults to ``a.is_cuda``) float64 matmuls,
    exact while every partial sum stays below 2^53: one of the codes when
    ``magnitude_bits`` (|a_i * b_i| < 2^this) and K allow it, else four of
    16-bit limbs (each product below 2^32, so K up to 2^21)."""
    if not (a.is_cuda if float64 is None else float64):
        return (_wide(a) @ _wide(b)).to(dtype)
    k = max(a.shape[-1], 1)
    if magnitude_bits + math.ceil(math.log2(k)) <= 53:
        return (a.double() @ b.double()).to(torch.int64).to(dtype)
    a64, b64 = _wide(a), _wide(b)

    def limbs(x):
        return (x >> 16).double(), (x & 0xFFFF).double()

    def dot(x, y):
        return (x @ y).to(torch.int64)

    ah, al = limbs(a64)
    bh, bl = limbs(b64)
    acc = ((dot(ah, bh) << 32) + ((dot(ah, bl) + dot(al, bh)) << 16)
           + dot(al, bl))
    return acc.to(dtype)


def fxp_matmul(op1: FxpArray, op2: FxpArray,
               result_bits: Optional[int] = None,
               result_bits_fn: Callable[[int, int], int] = max,
               result_exp: Optional[int] = None,
               result_exp_fn: Callable[[int, int], int] = max,
               round_mode: RoundingMode = RoundingMode.FLOOR) -> FxpArray:
    """Integer matmul with int32 (int64 when the widths need it)
    accumulation, then shift-round."""
    result_signed = op1.signed or op2.signed
    if result_bits is None:
        result_bits = result_bits_fn(op1.bits, op2.bits)
    if result_exp is None:
        result_exp = result_exp_fn(op1.exp, op2.exp)
    a, b = _maybe_widen(op1, op2)
    raw = _int_dot(a, b, torch.promote_types(a.dtype, b.dtype),
                   _magnitude_bits(op1) + _magnitude_bits(op2))
    rshift = op1.exp + op2.exp - result_exp
    if rshift < 0:
        data = (raw << -rshift).to(torch.int32)
    else:
        data = fxp_rshift_round(raw, rshift, round_mode).to(torch.int32)
    return FxpArray(data, result_bits, result_exp, result_signed).clip()


def fxp_complex_mul(op1: ComplexFxpArray, op2: ComplexFxpArray,
                    result_exp: Tuple[Optional[int], Optional[int]] = (None, None),
                    result_bits: Tuple[Optional[int], Optional[int]] = (None, None),
                    round_mode: RoundingMode = RoundingMode.FLOOR
                    ) -> ComplexFxpArray:
    """(a+bi)(c+di) as 4 real multiplies + aligned add/sub."""
    re_exp, im_exp = result_exp
    re_bits, im_bits = result_bits

    def mul(x, y, e, b):
        return fxp_mul(x, y, result_exp=e, result_bits=b,
                       result_bits_fn=max, round_mode=round_mode)

    ac = mul(op1.real, op2.real, re_exp, re_bits)
    bd = mul(op1.imag, op2.imag, re_exp, re_bits)
    ad = mul(op1.real, op2.imag, im_exp, im_bits)
    bc = mul(op1.imag, op2.real, im_exp, im_bits)
    real = fxp_sub(ac, bd, result_bits=re_bits, result_exp=re_exp,
                   round_mode=round_mode)
    imag = fxp_add(ad, bc, result_bits=im_bits, result_exp=im_exp,
                   round_mode=round_mode)
    return ComplexFxpArray(real=real, imag=imag)


def fxp_relu(x: Union[FxpArray, ComplexFxpArray]):
    """ReLU on fxp data; complex applies to re/im separately."""
    if isinstance(x, ComplexFxpArray):
        return ComplexFxpArray(real=fxp_relu(x.real), imag=fxp_relu(x.imag))
    return FxpArray(torch.clamp_min(_tensor(x.data), 0), x.bits, x.exp,
                    x.signed)


def fxp_top_k(x: Union[FxpArray, ComplexFxpArray], k: int):
    """Keep the k largest entries along the last axis, zero the rest (ties
    with the k-th largest are kept: ``>= thr``). The selection runs on the
    codes as float32, as JAX's ``approx_max_k`` (exact on the CPU) does;
    complex applies per component."""
    if isinstance(x, ComplexFxpArray):
        return ComplexFxpArray(real=fxp_top_k(x.real, k),
                               imag=fxp_top_k(x.imag, k))
    data = _tensor(x.data)
    if k >= data.shape[-1]:
        return x
    top_vals = torch.topk(data.to(torch.float32), k, dim=-1).values
    thr = top_vals[..., -1:].to(data.dtype)
    keep = torch.where(data >= thr, data, torch.zeros_like(data))
    return FxpArray(keep, x.bits, x.exp, x.signed)


def fxp_relu_top_k(x: Union[FxpArray, ComplexFxpArray], k: int):
    """relu(top_k(x))."""
    return fxp_relu(fxp_top_k(x, k))


def fxp_log_softmax(x: FxpArray, out_bits: int = 16,
                    out_exp: int = 10) -> FxpArray:
    """Integer log-softmax along the last axis: y_i = z_i − ln Σ exp(z_i)
    with z = x − max(x), from compares, shifts, adds and two
    piecewise-linear tables, exp(z) over [−16, 0] (segments of 2⁻³) and
    log₂(m) over [1, 2) (segments of 2⁻⁵), the sum's exponent by an
    integer MSB search. The JAX package's algorithm step for step."""
    e = x.exp
    ke = 3                       # exp-LUT segment width = 2^-ke
    r = 16                       # exp(z) ≈ 0 below z = -r
    se = 15                      # exp-LUT output frac bits (unsigned)
    data = _tensor(x.data)
    if e < ke:                   # too coarse for the LUT segments
        sh = ke + 2 - e
        x = FxpArray(data.to(torch.int32) << sh,
                     min(x.bits + sh, 31), ke + 2, x.signed).clip()
        e = x.exp
        data = x.data
    dev = data.device

    def table(values) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values, np.int32), device=dev)

    m = data.max(dim=-1, keepdim=True).values
    z = torch.clamp_min(data - m, -(r << e) + 1)

    # ---- exp LUT: exp(z_f), z_f in [-r, 0) -> (0, 1], frac bits se ----
    width = 2.0 ** -ke
    edges = np.arange(-r, 0 + width / 2, width)
    vals = np.exp(edges)
    y0_t = table(np.round(vals[:-1] * (1 << se)))
    slope_t = table(np.round((vals[1:] - vals[:-1]) * (1 << se)))
    shift = e - ke
    idx = torch.clamp((z >> shift) + (r << ke), 0, (r << ke) - 1).long()
    frac = z - ((idx.to(z.dtype) - (r << ke)) << shift)
    ez = y0_t[idx] + fxp_rshift_round(
        slope_t[idx].to(WIDE_DTYPE) * frac, shift,
        RoundingMode.ROUND).to(torch.int32)

    # ---- s = sum exp(z), in the wide dtype (int32) ----
    s = ez.to(WIDE_DTYPE).sum(dim=-1, keepdim=True).to(WIDE_DTYPE)
    s = torch.clamp_min(s, 1)

    # ---- ln(s / 2^se) = (b - se + log2(mantissa)) * ln2 ----
    n_lead = int(np.ceil(np.log2(max(2, data.shape[-1])))) + 1
    b = torch.full_like(s, se)
    for i in range(se + 1, se + n_lead + 1):
        b = b + (s >= (1 << i)).to(s.dtype)
    k2 = 5                       # log2-LUT segment width = 2^-k2
    edges2 = 1.0 + np.arange(0, (1 << k2) + 1) / (1 << k2)
    vals2 = np.log2(edges2)
    l2e = 14                     # log2-LUT output frac bits
    ly0 = table(np.round(vals2[:-1] * (1 << l2e)))
    lslope = table(np.round((vals2[1:] - vals2[:-1]) * (1 << l2e)))
    mbits = k2 + 10
    mant = s >> (b - (mbits - 1))
    idx2 = torch.clamp((mant >> (mbits - 1 - k2)) - (1 << k2), 0,
                       (1 << k2) - 1).to(torch.int32)
    frac2 = mant - ((idx2 + (1 << k2)).to(s.dtype) << (mbits - 1 - k2))
    prod = lslope[idx2.long()] * frac2.to(torch.int32)
    log2m = ly0[idx2.long()] + fxp_rshift_round(prod, mbits - 1 - k2,
                                                RoundingMode.ROUND)
    ln2_q = int(round(np.log(2.0) * (1 << 14)))  # ln2 at 14 frac bits
    ln_int = (b - se).to(torch.int32) * ln2_q
    ln_frac = fxp_rshift_round(log2m * ln2_q, 14, RoundingMode.ROUND)
    ln_s = ln_int + ln_frac

    # ---- y = z - ln(s), assembled at out_exp ----
    dz = out_exp - e
    z_w = z.to(WIDE_DTYPE)
    z_o = (z_w << dz if dz >= 0
           else fxp_rshift_round(z_w, -dz, RoundingMode.ROUND))
    dl = out_exp - l2e
    ln_o = (ln_s << dl if dl >= 0
            else fxp_rshift_round(ln_s, -dl, RoundingMode.ROUND))
    y = (z_o - ln_o).to(torch.int32)
    return FxpArray(y, out_bits, out_exp, True).clip()


def fxp_mean(x: FxpArray, axis: int = 0,
             round_mode: RoundingMode = RoundingMode.ROUND) -> FxpArray:
    """Mean via multiply by fxp(1/n); the sum in the wide dtype (int32)."""
    data = _tensor(x.data)
    n = data.shape[axis]
    summed = data.to(WIDE_DTYPE).sum(dim=axis).to(WIDE_DTYPE)
    # float32 1/n and log2, as the JAX package computes them
    n_log2 = int(np.ceil(np.log2(np.float32(n))))
    recn = fxp_from_fp(np.asarray(np.float32(1.0 / n)), bits=x.bits,
                       exp=max(x.exp, n_log2 + 2), signed=False)
    raw = summed * int(recn.data)
    data = fxp_rshift_round(raw, recn.exp, round_mode).to(torch.int32)
    return FxpArray(data, x.bits, x.exp, x.signed).clip()


def overflow_count(x: FxpArray) -> torch.Tensor:
    """Elements of ``x`` outside its format's range."""
    return x.overflow_count()


__all__ = [
    "FxpArray", "ComplexFxpArray", "RoundingMode", "round_array",
    "fxp_from_fp", "fxp_add", "fxp_sub", "fxp_mul", "fxp_matmul",
    "fxp_complex_mul", "fxp_change_exp", "fxp_change_cfg",
    "fxp_rshift_round", "fxp_relu", "fxp_top_k", "fxp_relu_top_k",
    "fxp_log_softmax", "fxp_mean", "overflow_count", "WIDE_DTYPE",
]
