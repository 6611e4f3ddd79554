"""Sequence layer: norm → S5 mixer → GLU gate → residual (counterpart of
``sparsernns_tpu/models/layers.py`` ``SequenceLayer``).

Two routes, as in the JAX package:

- fused (:meth:`SequenceLayer.forward` of a float prenorm layer around a
  unidirectional ``scan_mode="fused"`` mixer without top-k, as every repo
  recipe sets; :meth:`SequenceLayer.takes_tail` decides, as the JAX
  package's ``_tail_ops``), eval and training: the norm, then the whole
  rest of the layer as one kernel with a kernel backward
  (``ops/cuda/layer_tail.py``
  :class:`~sparsernns_tpu_torch.ops.cuda.layer_tail.LayerTailFn`), in one
  of its two modes.

  - BatchNorm (affine mode): the norm folds to a per-feature affine that
    the kernel applies, and the raw input is the residual. In eval mode the
    affine comes from the running statistics. In training mode it comes
    from the batch statistics, summed in float32 whatever the stream's
    dtype, which stay in the autograd graph (the gradients of the affine
    flowing back to ``x`` are the BatchNorm backward), and the running
    statistics move by ``bn_momentum`` with the unclamped variance
    E[x²] − E[x]², as the JAX package's padded-stream path moves them. A
    training stack whose layers all take this mode may run on a bfloat16
    stream (``seq_model.py``); the layer then reads and writes bf16.
  - LayerNorm (non-affine mode): ``z = LayerNorm(x)`` in autograd and the
    raw ``x`` as the residual go to the kernel as two streams.

  In training mode the dropout masks are drawn per (batch row, feature),
  constant along time, from the caller's generator;
- unfused (``forward`` of every other layer: postnorm, a bidirectional or
  ``scan_mode="pallas"`` mixer, quantization, top-k; and
  :meth:`SequenceLayer.forward_stream` of any layer), eval and training:
  norm, then the mixer, then the activation and the GLU with the same two
  dropout masks, then the residual, then the norm of a postnorm layer, all
  in autograd. Offline the mixer is called without a carry (the mixer
  kernel ``ops/cuda/fused_s5.py``, or the stand-alone scans), streaming
  with one (``ops/scan.py`` ``diag_ssm_scan``). BatchNorm on this route is
  flax's own: in training mode it normalizes with the batch mean and the
  biased variance max(0, E[x²] − E[x]²) of the stream it sees (for a
  postnorm layer the post-residual stream) and moves the running
  statistics by ``bn_momentum``. Under static quantization the dense layers
  are ``QuantizedDense``, the gate product a ``QuantizedMultiply`` and the
  layer output goes through the ``quant_residual`` quantizer; such a layer
  trains with its scales frozen (straight-through quant-dequant,
  ``quantize/static.py``). A QAT layer (dynamic fake-quant) runs this route
  too, its dense layers ``QATDense`` and its gate product of two
  fake-quantized operands. A layer with activation top-k (``topk < 1``, with
  ``approx_topk``: the JAX package raises for exact top-k) runs this route
  too: a relufied layer's activation keeps the ``int(topk * d_model)``
  largest values (relu top-k), and after the residual, the postnorm and
  the relu the layer output keeps them too (top-k, before the
  ``quant_residual`` quantizer).

With ``fuse_batchnorm_linear`` (prenorm BatchNorm only) the layer never
takes the whole-layer kernel: its BatchNorm folds into the mixer's B̄ and
D from the running statistics and the affine (the JAX package's
``bn_fusion``), in eval and in training mode alike, and the norm itself
is not run, so its running statistics stay as they are. Without
``use_batchnorm_scale`` / ``use_batchnorm_bias`` the BatchNorm has no
scale or no bias parameter (ones and zeros take their place as
non-persistent buffers, so every route computes as before). A layer
without either parameter does not fold (the JAX package finds no norm
parameters and normalizes), and one with a single parameter raises
``KeyError`` on folding, as the JAX package's lookup does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sparsernns_tpu_torch.ops.cuda.layer_tail import LayerTailFn
from sparsernns_tpu_torch.ops.scan import Pair
from sparsernns_tpu_torch.ops.topk import relu_top_k_sparsity, top_k_sparsity
from sparsernns_tpu_torch.quantize.config import QuantizationConfig
from sparsernns_tpu_torch.quantize.qat import fake_quant
from sparsernns_tpu_torch.quantize.static import (FakeQuant, QuantizedDense,
                                                  QuantizedMultiply)

GLU_VARIANTS = ("full", "half1", "half2", "none")

#: BatchNorm and LayerNorm epsilons of the JAX package (flax defaults)
BN_EPS = 1e-5
LN_EPS = 1e-6


class StreamMoments(torch.autograd.Function):
    """(E[x], E[x²]) over (B, L) of a (B, L, H) stream, in float32 whatever
    the stream's dtype. The backward saves the stream as it is: a bf16
    stream is widened again there, never kept as an f32 copy (the JAX
    package's padded-stream path fuses the widening into its sums). For an
    f32 stream the gradient is autograd's of ``x.mean``, ``(x * x).mean``,
    bit for bit."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        xf = x.float()
        return xf.mean(dim=(0, 1)), (xf * xf).mean(dim=(0, 1))

    @staticmethod
    def backward(ctx, g_mean, g_sq):
        x, = ctx.saved_tensors
        n = x.shape[0] * x.shape[1]
        xf = x.float()
        # the square's two paths, x * (g_sq / n) each, as autograd sums them
        return (g_mean / n + xf * (2.0 * (g_sq / n))).to(x.dtype)


class StreamSums(torch.autograd.Function):
    """(Σx, Σx²) over (B, L) of a (B, L, H) stream, in float32 whatever the
    stream's dtype, with :class:`StreamMoments`' backward (the stream kept
    as it is)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        xf = x.float()
        return xf.sum(dim=(0, 1)), (xf * xf).sum(dim=(0, 1))

    @staticmethod
    def backward(ctx, g_sum, g_sq):
        x, = ctx.saved_tensors
        return (g_sum + x.float() * (2.0 * g_sq)).to(x.dtype)


def group_moments(x: torch.Tensor, group
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(E[x], E[x²]) over the (B, L) rows of every rank of ``group``: the
    local sums and row count, summed over the group in one all-reduce
    (differentiable: the backward sums the gradients of the sums over the
    group), over the total count. The BatchNorm statistics of a
    data- or sequence-parallel batch, as the JAX package's partitioner
    reduces them over the mesh."""
    from sparsernns_tpu_torch.parallel.comms import AllReduceSum
    s1, s2 = StreamSums.apply(x)
    count = s1.new_full((1,), float(x.shape[0] * x.shape[1]))
    tot = AllReduceSum.apply(torch.cat([s1, s2, count]), group)
    h = s1.shape[0]
    return tot[:h] / tot[2 * h], tot[h:2 * h] / tot[2 * h]


class QATDense(nn.Linear):
    """``nn.Linear`` whose input and weight pass the per-tensor fake-quant
    with the STE first (the JAX package's ``QDense`` with ``q_dot``):
    ``fake_quant(x, a_bits) @ fake_quant(W, w_bits)^T + b``. The weight's
    absmax is that of the JAX package's (in, out) kernel, and the
    parameter names are ``nn.Linear``'s."""

    def __init__(self, d_in: int, d_out: int, a_bits: Optional[int],
                 w_bits: Optional[int]):
        super().__init__(d_in, d_out)
        self.a_bits, self.w_bits = a_bits, w_bits

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(fake_quant(x, self.a_bits),
                        fake_quant(self.weight, self.w_bits), self.bias)


def make_dense(q_config: QuantizationConfig, d_in: int, d_out: int
               ) -> nn.Linear:
    """Dense layer outside the SSM: ``QuantizedDense`` under static
    quantization, ``QATDense`` under dynamic fake-quant (QAT), else
    ``nn.Linear``."""
    if q_config.static_quant:
        return QuantizedDense(d_in, d_out,
                              a_bits=q_config.non_ssm_act_precision,
                              w_bits=q_config.non_ssm_precision,
                              calibrating=q_config.calibrating)
    if q_config.any_quantized:
        return QATDense(d_in, d_out, q_config.non_ssm_act_precision,
                        q_config.non_ssm_precision)
    return nn.Linear(d_in, d_out)


class SequenceLayer(nn.Module):
    """One S5 block over (B, L, H)."""

    def __init__(self, mixer: nn.Module, d_model: int,
                 glu_variant: str = "none", relufication: bool = False,
                 batchnorm: bool = True, prenorm: bool = True,
                 q_config: Optional[QuantizationConfig] = None,
                 dropout: float = 0.0, bn_momentum: float = 0.90,
                 topk: float = 1.0, approx_topk: bool = False,
                 fuse_batchnorm_linear: bool = False,
                 use_batchnorm_scale: bool = True,
                 use_batchnorm_bias: bool = True):
        super().__init__()
        if glu_variant not in GLU_VARIANTS:
            raise ValueError(f"glu_variant must be one of {GLU_VARIANTS}")
        if fuse_batchnorm_linear and not (batchnorm and prenorm):
            raise ValueError("fuse_batchnorm_linear requires batchnorm and "
                             "prenorm")
        if not 0.0 <= dropout < 1.0:
            raise ValueError(f"dropout must be in [0, 1), got {dropout}")
        q_config = q_config or QuantizationConfig.none()
        self.mixer = mixer
        self.d_model = d_model
        self.glu_variant = glu_variant
        self.relufication = relufication
        self.batchnorm = batchnorm
        self.prenorm = prenorm
        self.dropout = dropout
        self.topk = topk
        self.approx_topk = approx_topk
        #: running = bn_momentum * running + (1 - bn_momentum) * batch, the
        #: JAX package's convention (the complement of nn.BatchNorm1d's)
        self.bn_momentum = bn_momentum
        if glu_variant == "full":
            self.out1 = make_dense(q_config, d_model, d_model)
        if glu_variant in ("full", "half1", "half2"):
            self.out2 = make_dense(q_config, d_model, d_model)
        self.fuse_batchnorm_linear = fuse_batchnorm_linear
        self.norm = (nn.BatchNorm1d(d_model, eps=BN_EPS) if batchnorm
                     else nn.LayerNorm(d_model, eps=LN_EPS))
        #: the BatchNorm's affine parameters that exist (flax's
        #: ``use_scale`` / ``use_bias``)
        self.bn_params = ()
        if batchnorm:
            for name, use, fill in (("weight", use_batchnorm_scale, 1.0),
                                    ("bias", use_batchnorm_bias, 0.0)):
                if use:
                    self.bn_params += (name,)
                else:
                    delattr(self.norm, name)
                    self.norm.register_buffer(
                        name, torch.full((d_model,), fill), persistent=False)
        act_bits = q_config.non_ssm_act_precision
        self.static_quant = bool(q_config.static_quant)
        #: any quantization (static or QAT) keeps the layer off the
        #: whole-layer kernel
        self.quantized = q_config.any_quantized
        #: the process group whose rows the training statistics of the
        #: BatchNorm cover (a data- or sequence-parallel mesh's (data, seq)
        #: group, set by ``train/loop.build_model``); None: this rank's
        self.stat_group = None
        #: set while ``train/steps.capture_intermediates`` records the
        #: layer: the unfused route, as the JAX package's capture runs it
        self.capturing = False
        #: the QAT gate product: both operands fake-quantized to act_bits
        self.gate_bits = None if self.static_quant else act_bits
        if self.static_quant and act_bits is not None:
            self.mult_gate = QuantizedMultiply(
                left_bits=act_bits, right_bits=act_bits,
                calibrating=q_config.calibrating)
            # observes the layer output, so the serving engine gets a
            # residual-stream format of this layer's own
            self.quant_residual = FakeQuant(
                bits=act_bits, calibrating=q_config.calibrating)

    def _topk_k(self) -> int:
        if not self.approx_topk:
            raise NotImplementedError("exact top-k not implemented")
        return int(self.topk * self.d_model)

    def _act(self, x: torch.Tensor) -> torch.Tensor:
        """The GLU input's activation (the JAX package's ``_glu_act``)."""
        if self.relufication:
            if self.topk < 1.0:
                return relu_top_k_sparsity(x, self._topk_k())
            return torch.relu(x)
        # jax.nn.gelu's default is the tanh approximation
        return F.gelu(x, approximate="tanh")

    def bn_affine(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """BatchNorm (eval) as x * nw + nb, from the running statistics."""
        n = self.norm
        nw = n.weight * torch.rsqrt(n.running_var + n.eps)
        return nw, n.bias - n.running_mean * nw

    def batch_affine(self, x: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """BatchNorm (training) as x * nw + nb from the statistics of ``x``
        over (B, L), summed in float32 whatever the dtype of ``x`` and
        differentiable in ``x``; moves the running statistics by
        ``bn_momentum`` with the biased variance E[x²] − E[x]², unclamped,
        as the JAX package's padded-stream path does (flax's BatchNorm,
        which the unfused route follows, clamps it at 0).
        ``nn.BatchNorm1d``'s own training forward is not used: it stores
        the unbiased variance."""
        n = self.norm
        if self.stat_group is None:
            mean, sq = StreamMoments.apply(x)
        else:
            mean, sq = group_moments(x, self.stat_group)
        var = sq - mean * mean
        with torch.no_grad():
            mom = self.bn_momentum
            n.running_mean.mul_(mom).add_(mean, alpha=1.0 - mom)
            n.running_var.mul_(mom).add_(var, alpha=1.0 - mom)
        nw = n.weight * torch.rsqrt(var + n.eps)
        return nw, n.bias - mean * nw

    def dropout_masks(self, batch: int, device,
                      generator: Optional[torch.Generator]
                      ) -> Tuple[Optional[torch.Tensor],
                                 Optional[torch.Tensor]]:
        """The two training dropout masks, (B, 1, H) each, values 0 or
        1/keep: one after the activation and, with a gate, one after the
        gate product; two separate draws. (None, None) without dropout."""
        if self.dropout == 0.0:
            return None, None
        if generator is None:
            raise ValueError("a training forward with dropout needs the "
                             "run's torch.Generator")
        keep = 1.0 - self.dropout

        def draw():
            u = torch.rand((batch, 1, self.d_model), generator=generator,
                           device=device)
            return (u < keep).to(torch.float32) / keep

        m1 = draw()
        return m1, (draw() if self.glu_variant != "none" else None)

    def _norm(self, x: torch.Tensor) -> torch.Tensor:
        """The unfused route's norm: LayerNorm, or BatchNorm as flax
        computes it (running statistics in eval mode; in training mode the
        statistics of ``x`` over (B, L), which also move the running
        ones)."""
        n = self.norm
        if not self.batchnorm:
            return n(x)
        if self.training:
            if self.stat_group is None:
                mean, sq = x.mean(dim=(0, 1)), (x * x).mean(dim=(0, 1))
            else:
                mean, sq = group_moments(x, self.stat_group)
            var = (sq - mean * mean).clamp(min=0.0)
            with torch.no_grad():
                mom = self.bn_momentum
                n.running_mean.mul_(mom).add_(mean, alpha=1.0 - mom)
                n.running_var.mul_(mom).add_(var, alpha=1.0 - mom)
        else:
            mean, var = n.running_mean, n.running_var
        return (x - mean) * (torch.rsqrt(var + n.eps) * n.weight) + n.bias

    def _gate(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "mult_gate"):
            return self.mult_gate(a, b)
        return fake_quant(a, self.gate_bits) * fake_quant(b, self.gate_bits)

    def takes_tail(self) -> bool:
        """Whether :meth:`forward` runs the whole-layer kernel (the JAX
        package's ``_tail_ops``): a float prenorm layer around a mixer that
        the kernel expresses."""
        return (self.prenorm and not self.quantized and not self.capturing
                and not self.fuse_batchnorm_linear
                and self.mixer.expresses_tail())

    def bn_fusion(self) -> Optional[dict]:
        """The BatchNorm the mixer folds in (mean, var, eps, scale, bias),
        or None: with ``fuse_batchnorm_linear``, outside static
        quantization, and where the norm has parameters at all."""
        if (not self.fuse_batchnorm_linear or self.static_quant
                or not self.bn_params):
            return None
        for name in ("weight", "bias"):
            if name not in self.bn_params:
                raise KeyError(
                    f"fuse_batchnorm_linear folds the BatchNorm's scale and "
                    f"bias; this norm has no {name!r}")
        n = self.norm
        return dict(mean=n.running_mean, var=n.running_var, eps=n.eps,
                    scale=n.weight, bias=n.bias)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator``: the source of the training dropout masks, on the
        device of ``x`` (unused in eval mode and without dropout). On the
        whole-layer route ``x`` may be a bfloat16 stream (BatchNorm only);
        the output keeps its dtype."""
        if not self.takes_tail():
            return self._unfused(x, generator, None, streaming=False)[0]
        lam, w_b, w_c, d, relu_state = self.mixer.layer_tail_operands()
        skip = nw = nb = None
        if not self.batchnorm:
            z, skip = self.norm(x), x
        elif self.training:
            z, (nw, nb) = x, self.batch_affine(x)
        else:
            z, (nw, nb) = x, self.bn_affine()
        m1 = m2 = None
        if self.training:
            m1, m2 = self.dropout_masks(x.shape[0], x.device, generator)
        glu = self.glu_variant
        o2k = o2b = o1k = o1b = None
        if glu != "none":
            o2k, o2b = self.out2.weight.T, self.out2.bias
        if glu == "full":
            o1k, o1b = self.out1.weight.T, self.out1.bias
        return LayerTailFn.apply(
            z, lam[0], lam[1], w_b, w_c, d, nw, nb, o2k, o2b, o1k, o1b, m1,
            m2, "relu" if self.relufication else "gelu", glu, relu_state,
            self.relufication, skip)

    def forward_stream(self, x: torch.Tensor, carry: Optional[Pair],
                       generator: Optional[torch.Generator] = None
                       ) -> Tuple[torch.Tensor, Pair]:
        """Unfused forward starting the scan from ``carry`` (None: zero).
        Returns (output, the mixer's final state pair). In training mode
        (truncated backpropagation through time) the norm takes the batch
        statistics and the dropout masks come from ``generator``."""
        return self._unfused(x, generator, carry, streaming=True)

    def _unfused(self, x: torch.Tensor,
                 generator: Optional[torch.Generator],
                 carry: Optional[Pair], streaming: bool
                 ) -> Tuple[torch.Tensor, Optional[Pair]]:
        m1 = m2 = None
        if self.training:
            m1, m2 = self.dropout_masks(x.shape[0], x.device, generator)
        fusion = self.bn_fusion()
        u = self._norm(x) if self.prenorm and fusion is None else x
        if streaming:
            y, final = self.mixer.forward_stream(u, carry, bn_fusion=fusion)
        else:
            y, final = self.mixer(u, bn_fusion=fusion)
        x1 = self._act(y)
        if m1 is not None:
            x1 = x1 * m1
        glu = self.glu_variant
        if glu == "full":
            h = self._gate(self.out1(x1), torch.sigmoid(self.out2(x1)))
        elif glu == "half1":
            h = self._gate(x1, torch.sigmoid(self.out2(x1)))
        elif glu == "half2":
            h = self._gate(y, torch.sigmoid(self.out2(x1)))
        else:
            h = x1
        if m2 is not None:
            h = h * m2
        out = h + x
        if not self.prenorm:
            out = self._norm(out)
        if self.relufication:
            out = torch.relu(out)
        if self.topk < 1.0:
            out = top_k_sparsity(out, self._topk_k())
        if hasattr(self, "quant_residual"):
            out = self.quant_residual(out)
        return out, final
