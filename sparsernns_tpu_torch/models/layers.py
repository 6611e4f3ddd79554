"""Sequence layer: BatchNorm → S5 mixer → GLU gate → residual (eval
forward; counterpart of ``sparsernns_tpu/models/layers.py``
``SequenceLayer`` with prenorm BatchNorm, as every repo recipe sets).

Two routes, as in the JAX package:

- offline (:meth:`SequenceLayer.forward`): BatchNorm folds to a
  per-feature affine from its running statistics and the whole rest of
  the layer is one kernel (``ops/cuda/layer_tail.py``); the raw input is
  the residual;
- streaming (:meth:`SequenceLayer.forward_stream`): BatchNorm, then the
  mixer (B-projection, scan kernel with carry, C-projection), then the
  GLU, then the residual.

Only the eval forward is ported; training waits for a later slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sparsernns_tpu_torch.ops.cuda.layer_tail import layer_tail
from sparsernns_tpu_torch.ops.scan import Pair

GLU_VARIANTS = ("full", "half1", "half2", "none")

#: BatchNorm epsilon of the JAX package
BN_EPS = 1e-5


class SequenceLayer(nn.Module):
    """One S5 block over (B, L, H)."""

    def __init__(self, mixer: nn.Module, d_model: int,
                 glu_variant: str = "none", relufication: bool = False):
        super().__init__()
        if glu_variant not in GLU_VARIANTS:
            raise ValueError(f"glu_variant must be one of {GLU_VARIANTS}")
        self.mixer = mixer
        self.d_model = d_model
        self.glu_variant = glu_variant
        self.relufication = relufication
        if glu_variant == "full":
            self.out1 = nn.Linear(d_model, d_model)
        if glu_variant in ("full", "half1", "half2"):
            self.out2 = nn.Linear(d_model, d_model)
        self.norm = nn.BatchNorm1d(d_model, eps=BN_EPS)

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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check_eval()
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
        n = self.norm
        z = (x - n.running_mean) * torch.rsqrt(n.running_var + n.eps)
        y, final = self.mixer(z * n.weight + n.bias, carry)
        x1 = self._act(y)
        glu = self.glu_variant
        if glu == "full":
            h = self.out1(x1) * torch.sigmoid(self.out2(x1))
        elif glu == "half1":
            h = x1 * torch.sigmoid(self.out2(x1))
        elif glu == "half2":
            h = y * torch.sigmoid(self.out2(x1))
        else:
            h = x1
        out = h + x
        return (torch.relu(out) if self.relufication else out), final
