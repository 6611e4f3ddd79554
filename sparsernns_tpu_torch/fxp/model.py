"""Fixed-point (integer) inference engine for the S5 stack (counterpart of
``sparsernns_tpu/fxp/model.py``): ``FxpDense``, ``FxpBatchNorm``,
``FxpSigmoid`` (a piecewise-linear table), ``FxpSSM`` (B̄u, the integer
recurrence, relu / top-k on the states, C and D), ``FxpSequenceLayer``,
``FxpStackedEncoder`` and the regression and classification heads, each
with the intermediates capture and the export bundle of the JAX package.

Modules are plain classes, as in the JAX package: they are packed on the
host in numpy (the codes are numpy's), and :meth:`FxpModule.to` moves
every packed tensor to a device. Every forward gives the JAX package's
integers bit for bit (``fxp/array.py``); the recurrence runs through
``ops/cuda/fxp_scan.py``, one launch per layer on a CUDA device, the
step-by-step loop on the CPU. Nothing here has a gradient.

Formats are derived from a calibrated static-quant checkpoint by
:mod:`sparsernns_tpu_torch.fxp.derive`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from sparsernns_tpu_torch.fxp.array import (ComplexFxpArray, FxpArray,
                                            RoundingMode, _tensor, fxp_add,
                                            fxp_change_cfg, fxp_from_fp,
                                            fxp_log_softmax, fxp_matmul,
                                            fxp_mean, fxp_mul, fxp_relu,
                                            fxp_relu_top_k, fxp_rshift_round,
                                            fxp_top_k)
from sparsernns_tpu_torch.ops.cuda.fxp_scan import fxp_scan


@dataclasses.dataclass(frozen=True)
class FxpSpec:
    """Static fixed-point format: value = int(data) / 2^exp, int has
    ``bits`` bits, two's complement if signed."""

    bits: int
    exp: int
    signed: bool = True

    def quantize(self, x, round_mode: RoundingMode = RoundingMode.ROUND
                 ) -> FxpArray:
        return fxp_from_fp(x, self.bits, self.exp, self.signed, round_mode)

    def cast(self, x: FxpArray,
             round_mode: RoundingMode = RoundingMode.ROUND) -> FxpArray:
        # ROUND: the float static-quant path rounds to nearest
        return fxp_change_cfg(x, self.bits, self.exp, self.signed, round_mode)


def spec_for(x, bits: int, signed: bool = True) -> FxpSpec:
    """Best exponent for ``x`` in ``bits`` bits: the float static-quant
    path's symmetric power-of-2 rule, scale = pow2_round(absmax / qmax),
    so the weight grids equal the dequantized int weights. Pure numpy."""
    absmax = float(np.max(np.abs(np.asarray(x))))
    if absmax == 0.0 or not np.isfinite(absmax):
        return FxpSpec(bits, bits - 1 if signed else bits, signed)
    qmax = 2.0 ** (bits - 1) - 1.0
    exp = -int(round(np.log2(absmax / qmax)))
    return FxpSpec(bits, max(0, exp), signed)


def exp_from_scale(scale: float, clamp_min: int = 0) -> int:
    """Power-of-2 quantization scale -> fxp exponent (scale = 2^-exp)."""
    return max(clamp_min, int(round(-np.log2(float(scale)))))


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

class FxpModule:
    """Base: the intermediates capture of the verification reporter, the
    export bundle and the move to a device."""

    def __init__(self):
        self.intermediates: Dict[str, Any] = {}
        self.store_intermediates = False

    def sow(self, name: str, value):
        if self.store_intermediates:
            if isinstance(value, (FxpArray, ComplexFxpArray)):
                value = value.to_float()
            self.intermediates[name] = value

    def _children(self):
        for name, child in self.__dict__.items():
            if isinstance(child, FxpModule):
                yield name, None, child
            elif isinstance(child, (list, tuple)):
                for i, c in enumerate(child):
                    if isinstance(c, FxpModule):
                        yield name, i, c

    def set_store_intermediates(self, on: bool):
        self.store_intermediates = on
        for _, _, child in self._children():
            child.set_store_intermediates(on)

    def collect_intermediates(self, prefix: str = "") -> Dict[str, Any]:
        """{dotted module path.name: float32 tensor, or an (re, im) pair}
        of the last forward with the capture on, the JAX package's keys."""
        out = {f"{prefix}{k}": v for k, v in self.intermediates.items()}
        for name, i, child in self._children():
            sub = f"{name}." if i is None else f"{name}_{i}."
            out.update(child.collect_intermediates(f"{prefix}{sub}"))
        return out

    def export(self) -> Dict[str, Any]:
        """Self-describing export bundle (int data + specs)."""
        out = {"type": type(self).__name__}
        for name, val in self.__dict__.items():
            if isinstance(val, FxpArray):
                out[name] = {"data": _numpy(val.data), "bits": val.bits,
                             "exp": val.exp, "signed": val.signed}
            elif isinstance(val, ComplexFxpArray):
                out[name] = {
                    "real": {"data": _numpy(val.real.data),
                             "bits": val.real.bits, "exp": val.real.exp},
                    "imag": {"data": _numpy(val.imag.data),
                             "bits": val.imag.bits, "exp": val.imag.exp}}
            elif isinstance(val, FxpSpec):
                out[name] = dataclasses.asdict(val)
            elif isinstance(val, FxpModule):
                out[name] = val.export()
            elif isinstance(val, list) and val and isinstance(val[0],
                                                              FxpModule):
                out[name] = [m.export() for m in val]
        return out

    def to(self, device) -> "FxpModule":
        """Every packed array (and every child's) as a tensor on
        ``device``; returns self."""
        for name, val in list(self.__dict__.items()):
            if isinstance(val, (FxpArray, ComplexFxpArray)):
                setattr(self, name, val.to(device))
        for _, _, child in self._children():
            child.to(device)
        return self


class FxpDense(FxpModule):
    """Integer dense: y = requant(x_q @ W_q + bias)."""

    #: headroom above the OUTPUT grid kept in the 32-bit accumulator:
    #: saturation at |value| = 2^(31 - out.exp - GUARD)
    ACC_GUARD_BITS = 12

    def __init__(self, kernel: np.ndarray, bias: Optional[np.ndarray],
                 in_spec: FxpSpec, w_bits: int, out_spec: FxpSpec):
        super().__init__()
        self.in_spec = in_spec
        self.out_spec = out_spec
        w_spec = spec_for(kernel, w_bits)
        self.w = w_spec.quantize(np.asarray(kernel))
        self.acc_exp = min(in_spec.exp + w_spec.exp,
                           out_spec.exp + self.ACC_GUARD_BITS)
        self.bias = (fxp_from_fp(np.asarray(bias), 32, self.acc_exp,
                                 round_mode=RoundingMode.ROUND)
                     if bias is not None else None)

    def __call__(self, x: FxpArray) -> FxpArray:
        x = self.in_spec.cast(x)
        self.sow("input", x)
        acc = fxp_matmul(x, self.w, result_bits=32,
                         result_exp=self.acc_exp)
        if self.bias is not None:
            acc = fxp_add(acc, self.bias, result_bits=32)
        y = self.out_spec.cast(acc)
        self.sow("output", y)
        return y


class FxpBatchNorm(FxpModule):
    """Folded inference batchnorm: y = w ⊙ x + b with w = γ/√(σ²+ε),
    b = β − μ·w, both pre-quantized (degenerate statistics patched)."""

    def __init__(self, mean, var, scale, bias, eps: float,
                 in_spec: FxpSpec, out_spec: FxpSpec, w_bits: int = 16):
        super().__init__()
        w = np.asarray(scale) / np.sqrt(np.asarray(var) + eps)
        b = np.asarray(bias) - np.asarray(mean) * w
        w = np.nan_to_num(w, nan=1.0, posinf=1.0, neginf=1.0)
        b = np.nan_to_num(b, nan=0.0)
        self.w = spec_for(w, w_bits).quantize(np.asarray(w))
        self.b_spec = spec_for(b, 16)
        self.b = self.b_spec.quantize(np.asarray(b))
        self.in_spec = in_spec
        self.out_spec = out_spec

    def __call__(self, x: FxpArray) -> FxpArray:
        x = self.in_spec.cast(x)
        wx = fxp_mul(x, self.w, result_exp=self.out_spec.exp,
                     result_bits=32, round_mode=RoundingMode.ROUND)
        y = fxp_add(wx, self.b, result_bits=32)
        y = self.out_spec.cast(y)
        self.sow("output", y)
        return y


class FxpSigmoid(FxpModule):
    """Piecewise-linear integer sigmoid table with interpolation: segments
    of width 2^-half_log2 over [-RANGE, RANGE)."""

    RANGE = 8  # segments cover [-RANGE, RANGE)

    def __init__(self, out_spec: FxpSpec, half_log2: int = 1):
        super().__init__()
        assert not out_spec.signed or out_spec.exp <= out_spec.bits - 1
        self.out_spec = out_spec
        self.half_log2 = half_log2  # width = 2^-half_log2
        width = 2.0 ** -half_log2
        edges = np.arange(-self.RANGE, self.RANGE + width / 2, width)
        vals = 1.0 / (1.0 + np.exp(-edges))
        y0 = vals[:-1]
        slope = vals[1:] - vals[:-1]  # per segment
        e = out_spec.exp
        self.y0 = np.round(y0 * (1 << e)).astype(np.int32)
        self.slope = np.round(slope * (1 << e)).astype(np.int32)

    def __call__(self, x: FxpArray) -> FxpArray:
        k = self.half_log2
        n_seg = 2 * self.RANGE << k
        if x.exp < k:  # too coarse for sub-unit segments: widen first
            x = fxp_change_cfg(x, max(x.bits, 16), k + 2, x.signed)
        shift = x.exp - k  # fractional bits within a segment
        offset = self.RANGE << k
        # saturate the input to the table domain
        lo = -(self.RANGE << x.exp)
        hi = (self.RANGE << x.exp) - 1
        data = torch.clamp(x.data, lo, hi)
        idx = torch.clamp((data >> shift) + offset, 0, n_seg - 1)
        frac = data - ((idx - offset) << shift)  # in [0, 2^shift)
        y0 = torch.as_tensor(self.y0, device=data.device)
        slope = torch.as_tensor(self.slope, device=data.device)
        gather = idx.long()
        y = y0[gather] + fxp_rshift_round(
            slope[gather] * frac, shift, RoundingMode.ROUND)
        out = FxpArray(y, self.out_spec.bits, self.out_spec.exp,
                       self.out_spec.signed).clip()
        self.sow("output", out)
        return out


@dataclasses.dataclass(frozen=True)
class FxpSSMSpecs:
    """Formats for every tensor in the integer SSM."""

    a: Tuple[FxpSpec, FxpSpec]       # Λ̄ re/im
    b: Tuple[FxpSpec, FxpSpec]       # B̄ weights re/im (separate grids)
    c: Tuple[FxpSpec, FxpSpec]       # C weights re/im
    d: FxpSpec                        # D
    u: FxpSpec                        # input activations
    bu: Tuple[FxpSpec, FxpSpec]      # B̄u re/im
    x: Tuple[FxpSpec, FxpSpec]       # state re/im
    y: FxpSpec                        # output activations


class FxpSSM(FxpModule):
    """Integer S5: B̄u matmuls, the shift/multiply recurrence
    (``fxp_scan``), C/D application."""

    def __init__(self, lam_bar: Tuple[np.ndarray, np.ndarray],
                 b_bar: Tuple[np.ndarray, np.ndarray],
                 c_tilde: Tuple[np.ndarray, np.ndarray],
                 d: np.ndarray, specs: FxpSSMSpecs, conj_sym: bool = True,
                 relufication: bool = False,
                 d_bias: Optional[np.ndarray] = None,
                 topk: float = 1.0):
        super().__init__()
        self.specs = specs
        self.conj_sym = conj_sym
        self.relufication = relufication
        self.topk = topk
        self.a = ComplexFxpArray(
            real=specs.a[0].quantize(np.asarray(lam_bar[0])),
            imag=specs.a[1].quantize(np.asarray(lam_bar[1])))
        # stored transposed for (L, H) @ (H, P) matmuls
        self.b_re = specs.b[0].quantize(np.asarray(b_bar[0].T))
        self.b_im = specs.b[1].quantize(np.asarray(b_bar[1].T))
        self.c_re = specs.c[0].quantize(np.asarray(c_tilde[0].T))
        self.c_im = specs.c[1].quantize(np.asarray(c_tilde[1].T))
        self.d = specs.d.quantize(np.asarray(d))
        self.d_bias = (spec_for(d_bias, 16).quantize(np.asarray(d_bias))
                       if d_bias is not None else None)

    def guard_bits(self) -> int:
        """g: each step's complex sum is accumulated at g extra fractional
        bits and rounded once, as the float static-quant path quant-
        dequants the whole step once; three accumulands below
        2^(bits - 1 + g) stay within int32."""
        sp = self.specs
        g_re = max(0, min(12, self.a.real.exp, 29 - sp.x[0].bits))
        g_im = max(0, min(12, self.a.imag.exp, 29 - sp.x[1].bits))
        return min(g_re, g_im)

    def __call__(self, u: FxpArray) -> Tuple[FxpArray, ComplexFxpArray]:
        sp = self.specs
        u = sp.u.cast(u)
        self.sow("input", u)

        # ROUND: the float static-quant path's round-to-nearest
        bu_re = fxp_matmul(u, self.b_re, result_bits=sp.bu[0].bits,
                           result_exp=sp.bu[0].exp,
                           round_mode=RoundingMode.ROUND)
        bu_im = fxp_matmul(u, self.b_im, result_bits=sp.bu[1].bits,
                           result_exp=sp.bu[1].exp,
                           round_mode=RoundingMode.ROUND)
        self.sow("Bu", ComplexFxpArray(bu_re, bu_im))

        # align bu to the state exponents (int32, wrapping as XLA's)
        x_re_exp, x_im_exp = sp.x[0].exp, sp.x[1].exp
        dr = x_re_exp - sp.bu[0].exp
        di = x_im_exp - sp.bu[1].exp
        bu_r = (bu_re.data << dr if dr >= 0
                else fxp_rshift_round(bu_re.data, -dr, RoundingMode.ROUND))
        bu_i = (bu_im.data << di if di >= 0
                else fxp_rshift_round(bu_im.data, -di, RoundingMode.ROUND))

        a_re, a_im = self.a.real, self.a.imag
        g = self.guard_bits()
        bounds = [(-(1 << (s.bits - 1)), (1 << (s.bits - 1)) - 1)
                  for s in sp.x]
        shape = bu_r.shape
        rows = (-1,) + tuple(shape[-2:])
        xs_r, xs_i = fxp_scan(
            bu_r.reshape(rows).contiguous(), bu_i.reshape(rows).contiguous(),
            _tensor(a_re.data, bu_r), _tensor(a_im.data, bu_r),
            (a_re.exp - g, a_im.exp - g), g, *bounds)
        xs = ComplexFxpArray(
            FxpArray(xs_r.reshape(shape), sp.x[0].bits, x_re_exp),
            FxpArray(xs_i.reshape(shape), sp.x[1].bits, x_im_exp))
        if self.relufication:
            if self.topk < 1.0:
                # per-component relu_top_k on the states, as the float path
                k = int(self.topk * xs.real.data.shape[-1])
                xs = fxp_relu_top_k(xs, k)
            else:
                xs = fxp_relu(xs)
        # sown post-relufication: the float model's pre_C
        self.sow("states", xs)

        yc_re = fxp_matmul(xs.real, self.c_re, result_bits=32,
                           result_exp=sp.y.exp + 1,
                           round_mode=RoundingMode.ROUND)
        yc_im = fxp_matmul(xs.imag, self.c_im, result_bits=32,
                           result_exp=sp.y.exp + 1,
                           round_mode=RoundingMode.ROUND)
        y = FxpArray(yc_re.data - yc_im.data, 32, sp.y.exp + 1)
        if self.conj_sym:
            y = FxpArray(y.data << 1, 32, y.exp)

        du = fxp_mul(self.d, u, result_exp=y.exp, result_bits=32,
                     round_mode=RoundingMode.ROUND)
        y = fxp_add(y, du, result_bits=32)
        if self.d_bias is not None:
            y = fxp_add(y, self.d_bias, result_bits=32)
        y = sp.y.cast(y)
        self.sow("output", y)
        return y, xs


class FxpSequenceLayer(FxpModule):
    """norm -> SSM -> relu -> GLU gate -> residual (+ relufication)."""

    def __init__(self, ssm: FxpSSM, norm: Optional[FxpBatchNorm],
                 out2: Optional[FxpDense], out1: Optional[FxpDense],
                 glu_variant: str, act_spec: FxpSpec,
                 relufication: bool = True, prenorm: bool = True,
                 mult_specs: Optional[Tuple[FxpSpec, FxpSpec]] = None,
                 topk: float = 1.0):
        super().__init__()
        self.ssm = ssm
        self.norm = norm
        self.out1 = out1
        self.out2 = out2
        self.glu_variant = glu_variant
        self.act_spec = act_spec
        self.relufication = relufication
        self.prenorm = prenorm
        self.topk = topk
        # the GLU multiply's operands on their calibrated grids (with the
        # static path's clip at the calibrated absmax)
        self.mult_specs = mult_specs
        self.sigmoid = (FxpSigmoid(FxpSpec(act_spec.bits,
                                           min(act_spec.bits - 1, 14),
                                           signed=False))
                        if glu_variant in ("full", "half1", "half2")
                        else None)

    def __call__(self, x: FxpArray) -> FxpArray:
        skip = self.act_spec.cast(x)
        self.sow("input", skip)
        if self.norm is not None and self.prenorm:
            x = self.norm(skip)
        else:
            x = skip
        y, _ = self.ssm(x)

        if self.relufication and self.topk < 1.0:
            x1 = fxp_relu_top_k(y, int(self.topk * y.data.shape[-1]))
        elif self.relufication:
            x1 = fxp_relu(y)
        else:
            x1 = y
        self.sow("pre_GLU", x1)

        def mult(left, g):
            if self.mult_specs is not None:
                left = self.mult_specs[0].cast(left)
                g = self.mult_specs[1].cast(g)
            return fxp_mul(left, g, result_exp=self.act_spec.exp,
                           result_bits=self.act_spec.bits,
                           round_mode=RoundingMode.ROUND)

        if self.glu_variant == "full":
            x = mult(self.out1(x1), self.sigmoid(self.out2(x1)))
        elif self.glu_variant == "half1":
            x = mult(x1, self.sigmoid(self.out2(x1)))
        elif self.glu_variant == "half2":
            x = mult(y, self.sigmoid(self.out2(x1)))
        else:
            x = self.act_spec.cast(x1)

        x = fxp_add(x, skip, result_bits=self.act_spec.bits + 1,
                    result_exp=self.act_spec.exp)
        if self.norm is not None and not self.prenorm:
            x = self.norm(x)
        if self.relufication:
            x = fxp_relu(x)
        if self.topk < 1.0:
            # layer-output top_k (post-relu, pre-requant)
            x = fxp_top_k(x, int(self.topk * x.data.shape[-1]))
        x = self.act_spec.cast(x)
        self.sow("output", x)
        return x


class FxpStackedEncoder(FxpModule):
    """Encoder dense + N sequence layers."""

    def __init__(self, encoder: FxpDense, layers: List[FxpSequenceLayer],
                 relufication: bool = True, topk: float = 1.0):
        super().__init__()
        self.encoder = encoder
        self.layers = layers
        self.relufication = relufication
        self.topk = topk

    def __call__(self, x: FxpArray) -> FxpArray:
        x = self.encoder(x)
        if self.topk < 1.0:
            # top-k implies relu at the encoder output
            x = fxp_relu_top_k(x, int(self.topk * x.data.shape[-1]))
        elif self.relufication:
            x = fxp_relu(x)
        for layer in self.layers:
            x = layer(x)
        return x


class FxpRegressionModel(FxpModule):
    """Integer NDNS head: encoder stack + per-step decoder."""

    def __init__(self, encoder: FxpStackedEncoder, decoder: FxpDense,
                 in_spec: FxpSpec):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder
        self.in_spec = in_spec

    @torch.no_grad()
    def __call__(self, x) -> FxpArray:
        if not isinstance(x, FxpArray):
            x = self.in_spec.quantize(x)
        self.sow("input", x)
        x = self.encoder(x)
        out = self.decoder(x)
        self.sow("output", out)
        return out


class FxpClassificationModel(FxpModule):
    """Integer classifier: encoder stack + mean over time + decoder +
    integer log-softmax (``fxp_log_softmax``)."""

    def __init__(self, encoder: FxpStackedEncoder, decoder: FxpDense,
                 in_spec: FxpSpec, log_softmax: bool = True):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder
        self.in_spec = in_spec
        self.log_softmax = log_softmax

    @torch.no_grad()
    def __call__(self, x) -> FxpArray:
        if not isinstance(x, FxpArray):
            x = self.in_spec.quantize(x)
        x = self.encoder(x)
        x = fxp_mean(x, axis=x.ndim - 2)
        out = self.decoder(x)
        if self.log_softmax:
            out = fxp_log_softmax(out)
        self.sow("output", out)
        return out
