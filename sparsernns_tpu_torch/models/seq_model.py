"""Stacked S5 encoder and the regression head (counterpart of
``sparsernns_tpu/models/seq_model.py`` ``StackedEncoderModel`` and
``RegressionModel``), eval and training forward.

The JAX package pads the stream to its TPU kernel geometry (L to a
multiple of the time block, H to 128 lanes) and takes the training
BatchNorm statistics from sums over the padded stream divided by the true
count; the port computes on the true (B, L, H) region, where the values
and the statistics are the same. The stream between the layers is float32,
or, in training mode with ``stream_dtype="bfloat16"``, bfloat16 when every
layer takes the whole-layer kernel with BatchNorm: the JAX package's
padded-stream path, the only one where it uses the stream dtype. Eval,
streaming and every other stack stay float32.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch
from torch import nn

from sparsernns_tpu_torch.models.layers import SequenceLayer, make_dense
from sparsernns_tpu_torch.ops.scan import Pair
from sparsernns_tpu_torch.ops.topk import relu_top_k_sparsity
from sparsernns_tpu_torch.quantize.config import QuantizationConfig

#: per-layer streaming state: one (carry_re, carry_im) (B, P) pair a layer
Cache = List[Pair]

#: the stream dtypes of a training stack (``RunConfig.train_stream_dtype``)
STREAM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def check_stream_dtype(name: str) -> str:
    if name not in STREAM_DTYPES:
        raise ValueError(f"stream dtype {name!r}: one of "
                         f"{sorted(STREAM_DTYPES)}")
    return name


def quant_input_fn(x: torch.Tensor, quant_input_exp: Optional[float] = None
                   ) -> torch.Tensor:
    """Round the input to the fixed grid of 2^-quant_input_exp (None: the
    identity), as the fixed-point model quantizes its input."""
    if quant_input_exp is None:
        return x
    step = 2.0 ** quant_input_exp
    return torch.round(x * step) / step


class StackedEncoderModel(nn.Module):
    """Linear encoder + N S5 sequence layers."""

    def __init__(self, make_mixer: Callable[[], nn.Module], d_input: int,
                 n_layers: int, d_model: int, glu_variant: str = "none",
                 relufication: bool = False, batchnorm: bool = True,
                 prenorm: bool = True,
                 q_config: Optional[QuantizationConfig] = None,
                 dropout: float = 0.0, bn_momentum: float = 0.90,
                 topk: float = 1.0, approx_topk: bool = False,
                 stream_dtype: str = "float32"):
        super().__init__()
        q_config = q_config or QuantizationConfig.none()
        if topk < 1.0 and not approx_topk:
            raise NotImplementedError("exact top-k not implemented")
        #: the stream between the layers in training mode (module doc)
        self.stream_dtype = check_stream_dtype(stream_dtype)
        self.relufication = relufication
        self.d_model = d_model
        self.topk = topk
        self.encoder = make_dense(q_config, d_input, d_model)
        self.layers = nn.ModuleList(
            SequenceLayer(make_mixer(), d_model, glu_variant=glu_variant,
                          relufication=relufication, batchnorm=batchnorm,
                          prenorm=prenorm, q_config=q_config,
                          dropout=dropout, bn_momentum=bn_momentum,
                          topk=topk, approx_topk=approx_topk)
            for _ in range(n_layers))

    def _encode(self, x: torch.Tensor) -> torch.Tensor:
        """The encoder dense and its activation (the JAX package's
        ``topk_op``): relu top-k with top-k, relu when relufied, else
        none."""
        x = self.encoder(x)
        if self.topk < 1.0:
            return relu_top_k_sparsity(x, int(self.topk * self.d_model))
        return torch.relu(x) if self.relufication else x

    def _stream_dtype(self) -> torch.dtype:
        """The dtype of the stream between the layers of this forward."""
        if (self.training and len(self.layers) > 0
                and all(lay.batchnorm and lay.takes_tail()
                        for lay in self.layers)):
            return STREAM_DTYPES[self.stream_dtype]
        return torch.float32

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self._encode(x).to(self._stream_dtype())
        for layer in self.layers:
            x = layer(x, generator)
        return x.to(torch.float32)

    def forward_stream(self, x: torch.Tensor, cache: Optional[Cache]
                       ) -> Tuple[torch.Tensor, Cache]:
        x = self._encode(x)
        new_cache = []
        for i, layer in enumerate(self.layers):
            x, final = layer.forward_stream(
                x, None if cache is None else cache[i])
            new_cache.append(final)
        return x, new_cache


class RegressionModel(nn.Module):
    """Encoder stack + per-step linear decoder (the NDNS denoising head):
    (B, L, d_input) -> (B, L, d_output)."""

    def __init__(self, make_mixer: Callable[[], nn.Module], d_input: int,
                 d_output: int, n_layers: int, d_model: int,
                 q_config: Optional[QuantizationConfig] = None,
                 quant_input: Optional[float] = None, **layer_kw):
        super().__init__()
        q_config = q_config or QuantizationConfig.none()
        self.q_config = q_config
        #: the exponent of the input grid (``quant_input_fn``), or None
        self.quant_input = quant_input
        self.encoder = StackedEncoderModel(make_mixer, d_input, n_layers,
                                           d_model, q_config=q_config,
                                           **layer_kw)
        self.decoder = make_dense(q_config, d_model, d_output)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Offline forward (the whole-layer kernel route for a float
        prenorm model, BatchNorm or LayerNorm, else the unfused route
        around the mixer kernel or the stand-alone scans). In training mode
        every layer, on either route, normalizes with the batch statistics
        (BatchNorm), moves its running statistics and draws its dropout
        masks from ``generator``, and the stream between the layers is the
        encoder's ``stream_dtype`` where the module doc says. With
        ``quant_input`` the input is first rounded to its grid."""
        x = quant_input_fn(x, self.quant_input)
        return self.decoder(self.encoder(x, generator))

    def forward_stream(self, x: torch.Tensor, cache: Optional[Cache] = None
                       ) -> Tuple[torch.Tensor, Cache]:
        """Chunk forward: every layer's scan starts from its carry in
        ``cache`` (None: zero) and the final carries come back."""
        y, new_cache = self.encoder.forward_stream(
            quant_input_fn(x, self.quant_input), cache)
        return self.decoder(y), new_cache
