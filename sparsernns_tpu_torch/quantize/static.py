"""Static quantization: observers, fake-quant modules, quantized Dense
(counterpart of ``sparsernns_tpu/quantize/static.py``).

Every quantizer is an ``nn.Module`` whose observer min/max and ``scale``
are buffers. ``calibrating=True`` runs the observer, stores the scale it
derives and passes the input through unchanged; ``calibrating=False``
applies quant-dequant with the stored (frozen) scale, with the
straight-through gradient: the identity in the input and nothing to the
scale, which is a buffer. So a static-quant model finetunes its weights
with its scales frozen. Complex tensors are (re, im) pairs.

The JAX package creates its variables by running the model once on a
zeros example, so each of its observers starts from the value it saw
there (0 almost everywhere). The port has no such pass: its observers
start at min = max = 0, which gives the same symmetric scales.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch
from torch import nn

from sparsernns_tpu_torch.quantize.config import QuantScheme

_SYMMETRIC = (QuantScheme.per_tensor_symmetric,
              QuantScheme.per_channel_symmetric)
_PER_CHANNEL = (QuantScheme.per_channel_symmetric,
                QuantScheme.per_channel_affine)


class MinMaxObserver(nn.Module):
    """Running min/max of what it is shown. Per-tensor reduces over all
    axes; per-channel over all but the last."""

    def __init__(self,
                 qscheme: QuantScheme = QuantScheme.per_tensor_symmetric):
        super().__init__()
        self.qscheme = qscheme
        self.register_buffer("observer_min", torch.zeros(()))
        self.register_buffer("observer_max", torch.zeros(()))

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.qscheme in _PER_CHANNEL:
            flat = x.reshape(-1, x.shape[-1])
            local_min = flat.min(dim=0).values
            local_max = flat.max(dim=0).values
        else:
            local_min, local_max = x.min(), x.max()
        self.observer_min = torch.minimum(self.observer_min, local_min)
        self.observer_max = torch.maximum(self.observer_max, local_max)
        return x


def calculate_qparams(minval: torch.Tensor, maxval: torch.Tensor, bits: int,
                      qscheme: QuantScheme = QuantScheme.per_tensor_symmetric,
                      pow2scale: bool = True, eps: float = 1e-6
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """min/max -> (scale, zero_point)."""
    if qscheme in _SYMMETRIC:
        max_abs = torch.maximum(minval.abs(), maxval.abs())
        scale = torch.clamp(max_abs / (2.0 ** (bits - 1) - 1.0), min=eps)
        if pow2scale:
            scale = torch.exp2(torch.round(torch.log2(scale)))
        return scale, torch.zeros_like(scale)
    if qscheme == QuantScheme.per_tensor_affine:
        scale = torch.clamp((maxval - minval) / (2.0 ** bits - 1.0), min=eps)
        if pow2scale:
            scale = torch.exp2(torch.round(torch.log2(scale)))
        # zero_point in the signed integer range quant_dequant uses
        zero_point = torch.round(-minval / scale) - 2.0 ** (bits - 1)
        return scale, zero_point
    raise NotImplementedError(f"qscheme {qscheme} not implemented")


def quant_dequant(x: torch.Tensor, scale: torch.Tensor,
                  zero_point: Union[torch.Tensor, float], bits: int
                  ) -> torch.Tensor:
    """Quantize-dequantize with the straight-through gradient:
    ``x + (xdq - x).detach()``, the JAX package's form, so the gradient is
    the identity in ``x`` and zero in ``scale`` and ``zero_point``."""
    quant_min = -(2.0 ** (bits - 1))
    quant_max = 2.0 ** (bits - 1) - 1.0
    xq = torch.clamp(torch.round(x / scale + zero_point), quant_min,
                     quant_max)
    xdq = (xq - zero_point) * scale
    return x + (xdq - x).detach()


class FakeQuant(nn.Module):
    """Observer-calibrated fake quantization of a real tensor."""

    def __init__(self, bits: int = 8, pow2scale: bool = True,
                 qscheme: QuantScheme = QuantScheme.per_tensor_symmetric,
                 calibrating: bool = True):
        super().__init__()
        self.bits = bits
        self.pow2scale = pow2scale
        self.qscheme = qscheme
        self.calibrating = calibrating
        self.register_buffer("scale", torch.ones(()))
        if calibrating:
            self.observer = MinMaxObserver(qscheme)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.calibrating:
            return quant_dequant(x, self.scale, 0.0, self.bits)
        self.observer(x)
        self.scale = self.calibration_scale()
        return x

    def calibration_scale(self) -> Optional[torch.Tensor]:
        """Scale from this module's observer, None when not calibrating."""
        if not self.calibrating:
            return None
        scale, _ = calculate_qparams(
            self.observer.observer_min, self.observer.observer_max,
            self.bits, self.qscheme, self.pow2scale)
        return scale

    def observed_absmax(self) -> torch.Tensor:
        obs = self.observer
        return torch.maximum(obs.observer_min.abs(),
                             obs.observer_max.abs()).max()


class FakeQuantComplex(nn.Module):
    """FakeQuant over a complex tensor given as an (re, im) pair, each
    half on its own per-tensor grid."""

    def __init__(self, **kw):
        super().__init__()
        self.quant_real = FakeQuant(**kw)
        self.quant_imag = FakeQuant(**kw)

    def forward(self, re: torch.Tensor, im: torch.Tensor):
        return self.quant_real(re), self.quant_imag(im)


class QuantizedMultiply(nn.Module):
    """Static-quant elementwise multiply with observers on both operands."""

    def __init__(self, left_bits: int = 8, right_bits: int = 8,
                 out_bits: Optional[int] = None, calibrating: bool = True):
        super().__init__()
        self.quant_left = FakeQuant(bits=left_bits, calibrating=calibrating)
        self.quant_right = FakeQuant(bits=right_bits, calibrating=calibrating)
        if out_bits is not None:
            self.quant_out = FakeQuant(bits=out_bits, calibrating=calibrating)

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        out = self.quant_left(a) * self.quant_right(b)
        return self.quant_out(out) if hasattr(self, "quant_out") else out


class QuantizedDense(nn.Linear):
    """``nn.Linear`` with static input/weight/output quantization. The
    weight scale comes from the weight itself; activations use observers
    during calibration and frozen scales afterwards."""

    def __init__(self, in_features: int, out_features: int, a_bits: int = 8,
                 w_bits: Optional[int] = 8, calibrating: bool = True,
                 pow2scale: bool = True):
        super().__init__(in_features, out_features)
        self.w_bits = w_bits
        self.pow2scale = pow2scale
        kw = dict(bits=a_bits, pow2scale=pow2scale, calibrating=calibrating)
        self.quant_input = FakeQuant(**kw)
        self.quant_output = FakeQuant(**kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.quant_input(x)
        kernel = self.weight.T
        if self.w_bits is not None and self.w_bits < 32:
            w_absmax = kernel.detach().abs().max()
            w_scale, _ = calculate_qparams(-w_absmax, w_absmax, self.w_bits,
                                           pow2scale=self.pow2scale)
            kernel = quant_dequant(kernel, w_scale, 0.0, self.w_bits)
        return self.quant_output(x @ kernel + self.bias)


def merge_trained_params_into_calibrated(trained: Mapping[str, Any],
                                         calibrated: Mapping[str, Any]
                                         ) -> Dict[str, Any]:
    """A copy of the nested dict ``calibrated`` with every leaf that
    ``trained`` has at the same path (the JAX leaf paths) replaced by the
    trained one; leaves only ``calibrated`` has (its ``scale`` leaves) are
    kept."""
    out = dict(calibrated)
    for key, val in trained.items():
        if isinstance(val, Mapping) and isinstance(out.get(key), Mapping):
            out[key] = merge_trained_params_into_calibrated(val, out[key])
        else:
            out[key] = val
    return out
