"""Sequence layer: norm → S5 mixer → GLU gate → residual (eval forward;
counterpart of ``sparsernns_tpu/models/layers.py`` ``SequenceLayer``).

Two routes, as in the JAX package:

- fused (:meth:`SequenceLayer.forward` of a float prenorm-BatchNorm
  layer, as every repo recipe sets): BatchNorm folds to a per-feature
  affine from its running statistics and the whole rest of the layer is
  one kernel (``ops/cuda/layer_tail.py``); the raw input is the residual;
- unfused (:meth:`SequenceLayer.forward_stream`, and ``forward`` of a
  LayerNorm, postnorm or static-quant layer): norm, then the mixer
  (B-projection, scan with carry, C-projection), then the GLU, then the
  residual. Under static quantization the dense layers are
  ``QuantizedDense``, the gate product a ``QuantizedMultiply`` and the
  layer output goes through the ``quant_residual`` quantizer.

Only the eval forward is ported; training waits for a later slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sparsernns_tpu_torch.ops.cuda.layer_tail import layer_tail
from sparsernns_tpu_torch.ops.scan import Pair
from sparsernns_tpu_torch.quantize.config import QuantizationConfig
from sparsernns_tpu_torch.quantize.static import (FakeQuant, QuantizedDense,
                                                  QuantizedMultiply)

GLU_VARIANTS = ("full", "half1", "half2", "none")

#: BatchNorm and LayerNorm epsilons of the JAX package (flax defaults)
BN_EPS = 1e-5
LN_EPS = 1e-6


def make_dense(q_config: QuantizationConfig, d_in: int, d_out: int
               ) -> nn.Linear:
    """Dense layer outside the SSM: ``QuantizedDense`` under static
    quantization, else ``nn.Linear`` (dynamic fake-quant training is not
    ported)."""
    if q_config.static_quant:
        return QuantizedDense(d_in, d_out,
                              a_bits=q_config.non_ssm_act_precision,
                              w_bits=q_config.non_ssm_precision,
                              calibrating=q_config.calibrating)
    return nn.Linear(d_in, d_out)


class SequenceLayer(nn.Module):
    """One S5 block over (B, L, H)."""

    def __init__(self, mixer: nn.Module, d_model: int,
                 glu_variant: str = "none", relufication: bool = False,
                 batchnorm: bool = True, prenorm: bool = True,
                 q_config: Optional[QuantizationConfig] = None):
        super().__init__()
        if glu_variant not in GLU_VARIANTS:
            raise ValueError(f"glu_variant must be one of {GLU_VARIANTS}")
        q_config = q_config or QuantizationConfig.none()
        self.mixer = mixer
        self.d_model = d_model
        self.glu_variant = glu_variant
        self.relufication = relufication
        self.batchnorm = batchnorm
        self.prenorm = prenorm
        if glu_variant == "full":
            self.out1 = make_dense(q_config, d_model, d_model)
        if glu_variant in ("full", "half1", "half2"):
            self.out2 = make_dense(q_config, d_model, d_model)
        self.norm = (nn.BatchNorm1d(d_model, eps=BN_EPS) if batchnorm
                     else nn.LayerNorm(d_model, eps=LN_EPS))
        act_bits = q_config.non_ssm_act_precision
        self.static_quant = bool(q_config.static_quant)
        if self.static_quant and act_bits is not None:
            self.mult_gate = QuantizedMultiply(
                left_bits=act_bits, right_bits=act_bits,
                calibrating=q_config.calibrating)
            # observes the layer output, so the serving engine gets a
            # residual-stream format of this layer's own
            self.quant_residual = FakeQuant(
                bits=act_bits, calibrating=q_config.calibrating)

    def _act(self, x: torch.Tensor) -> torch.Tensor:
        # jax.nn.gelu's default is the tanh approximation
        return torch.relu(x) if self.relufication else F.gelu(
            x, approximate="tanh")

    def bn_affine(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """BatchNorm (eval) as x * nw + nb, from the running statistics."""
        n = self.norm
        nw = n.weight * torch.rsqrt(n.running_var + n.eps)
        return nw, n.bias - n.running_mean * nw

    def _check_eval(self):
        if self.training:
            raise NotImplementedError(
                "only the eval forward is ported: call .eval() first")

    def _norm(self, x: torch.Tensor) -> torch.Tensor:
        n = self.norm
        if not self.batchnorm:
            return n(x)
        z = (x - n.running_mean) * torch.rsqrt(n.running_var + n.eps)
        return z * n.weight + n.bias

    def _gate(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.mult_gate(a, b) if hasattr(self, "mult_gate") else a * b

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check_eval()
        if not (self.batchnorm and self.prenorm) or self.static_quant:
            return self.forward_stream(x, None)[0]
        lam, w_b, w_c, d, relu_state = self.mixer.layer_tail_operands()
        nw, nb = self.bn_affine()
        glu = self.glu_variant
        o2k = o2b = o1k = o1b = None
        if glu != "none":
            o2k, o2b = self.out2.weight.T, self.out2.bias
        if glu == "full":
            o1k, o1b = self.out1.weight.T, self.out1.bias
        return layer_tail(
            x, lam, w_b, w_c, d, nw, nb, o2k, o2b, o1k, o1b,
            act="relu" if self.relufication else "gelu", glu=glu,
            relu_state=relu_state, layer_relu=self.relufication)

    def forward_stream(self, x: torch.Tensor, carry: Optional[Pair]
                       ) -> Tuple[torch.Tensor, Pair]:
        """Unfused forward starting the scan from ``carry`` (None: zero).
        Returns (output, the mixer's final state pair)."""
        self._check_eval()
        y, final = self.mixer(self._norm(x) if self.prenorm else x, carry)
        x1 = self._act(y)
        glu = self.glu_variant
        if glu == "full":
            h = self._gate(self.out1(x1), torch.sigmoid(self.out2(x1)))
        elif glu == "half1":
            h = self._gate(x1, torch.sigmoid(self.out2(x1)))
        elif glu == "half2":
            h = self._gate(y, torch.sigmoid(self.out2(x1)))
        else:
            h = x1
        out = h + x
        if not self.prenorm:
            out = self._norm(out)
        if self.relufication:
            out = torch.relu(out)
        if hasattr(self, "quant_residual"):
            out = self.quant_residual(out)
        return out, final
