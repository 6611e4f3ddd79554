"""Quantization-aware training: dynamic fake-quant (counterpart of
``sparsernns_tpu/quantize/qat.py``).

Per-tensor symmetric dynamic quantization over all axes with a
straight-through estimator (STE): the forward sees the value on the grid
of the tensor's own absmax, the backward sees the identity. Rounding is
half to even (``torch.round``), then the codes are clipped to
``[-qmax - 1, qmax]``. ``bits`` None or at least 32 is the identity.

:func:`dyn_fake_quant` is the same quant-dequant without the STE, with an
optional given absmax: the in-scan fake-quant of the QAT scan kernels
(``ops/cuda/qat_scan.py``), whose gradients come from their own backward.

Every division divides by a tensor, never by a Python number: on a CUDA
tensor PyTorch turns a division by a host scalar into a multiplication by
its reciprocal, which can round the scale one unit apart from the
kernels' IEEE division.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from sparsernns_tpu_torch.quantize.config import QuantizationConfig

_EPS = 1e-20


def _qmax(bits: int) -> float:
    return 2.0 ** (bits - 1) - 1.0


def _on_grid(x: torch.Tensor, amax: torch.Tensor, bits: int
             ) -> torch.Tensor:
    """x on the symmetric ``bits``-bit grid of scale max(amax, eps)/qmax."""
    qmax = _qmax(bits)
    scale = torch.clamp(amax, min=_EPS) / torch.full(
        (), qmax, dtype=amax.dtype, device=amax.device)
    return torch.clamp(torch.round(x / scale), -qmax - 1.0, qmax) * scale


def fake_quant(x: torch.Tensor, bits: Optional[int]) -> torch.Tensor:
    """Per-tensor symmetric fake-quant with the STE,
    ``x + (xdq - x).detach()``, the scale from the detached absmax. An
    empty tensor passes through (the associative scan's recursion reaches
    zero-length slices, where an absmax has no value)."""
    if bits is None or bits >= 32 or x.numel() == 0:
        return x
    xd = x.detach()
    xdq = _on_grid(xd, xd.abs().amax(), bits)
    return x + (xdq - xd)


def dyn_fake_quant(x: torch.Tensor, bits: Optional[int],
                   absmax: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quant-dequant of ``x`` on its own absmax, or on ``absmax`` where
    given (the global-scale QAT mode); no STE."""
    if bits is None or bits >= 32:
        return x
    return _on_grid(x, x.abs().amax() if absmax is None else absmax, bits)


def q_dot(act_bits: Optional[int], weight_bits: Optional[int]) -> Callable:
    """(x, w) -> fake_quant(x) @ fake_quant(w): contracts the last axis of
    the activation with the first of the weight."""
    return lambda x, w: fake_quant(x, act_bits) @ fake_quant(w, weight_bits)


def q_had(left_bits: Optional[int], right_bits: Optional[int]) -> Callable:
    """Elementwise product of the two fake-quantized operands."""
    if left_bits is None and right_bits is None:
        return torch.mul
    return lambda a, b: fake_quant(a, left_bits) * fake_quant(b, right_bits)


@dataclasses.dataclass
class QuantizedOps:
    """The (possibly fake-quantized) ops of the S5 stack, as the JAX
    package's ``QuantizedOps``: ``a_had`` the (Λ·Λ, Λ·x) hadamards of the
    associative scan, ``b_dot`` / ``c_dot`` the B- and C-projections,
    ``d_had`` the feedthrough D ⊙ u, ``dense_dot`` the dense layers outside
    the SSM. Under static quantization (and without any precision) they are
    the float ops."""

    a_had: Tuple[Callable, Callable]
    b_dot: Callable
    c_dot: Callable
    d_had: Callable
    dense_dot: Callable

    @staticmethod
    def create(cfg: QuantizationConfig) -> "QuantizedOps":
        if cfg.static_quant or not cfg.any_quantized:
            return QuantizedOps(a_had=(torch.mul, torch.mul),
                                b_dot=torch.matmul, c_dot=torch.matmul,
                                d_had=torch.mul, dense_dot=torch.matmul)
        return QuantizedOps(
            a_had=(q_had(cfg.a_precision, cfg.a_precision),
                   q_had(cfg.a_precision, cfg.ssm_act_precision)),
            b_dot=q_dot(cfg.ssm_act_precision, cfg.b_precision),
            c_dot=q_dot(cfg.ssm_act_precision, cfg.c_precision),
            d_had=q_had(cfg.d_precision, cfg.ssm_act_precision),
            dense_dot=q_dot(cfg.non_ssm_act_precision, cfg.non_ssm_precision))


def is_qat(cfg: QuantizationConfig) -> bool:
    """A dynamic fake-quant (QAT) configuration: some precision set, no
    static quantization."""
    return cfg.any_quantized and not cfg.static_quant


def act_qat_bits(cfg: QuantizationConfig
                 ) -> Optional[Tuple[Optional[int], Optional[int]]]:
    """(a_bits, act_bits) of the in-scan activation QAT, or None when no
    activation precision of the SSM is below 32 bits."""
    if any(p is not None and p < 32 for p in (
            cfg.ssm_act_precision, cfg.a_precision, cfg.d_precision)):
        return cfg.a_precision, cfg.ssm_act_precision
    return None
