"""Stacked S5 encoder and the task heads (counterpart of
``sparsernns_tpu/models/seq_model.py``): ``StackedEncoderModel``, the
regression head (NDNS denoising), the classification head (pooled or last
step, ``log_softmax``) and the retrieval head (two documents, pooled, the
four-feature MLP), eval and training forward, float, QAT or static-quant.
A ``padded`` head takes ``(x, lengths)`` and pools over the valid steps
only (:func:`masked_meanpool`).

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
import torch.nn.functional as F
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


def masked_meanpool(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Mean of (B, L, H) over the first ``lengths`` (B,) steps of each
    row."""
    mask = torch.arange(x.shape[-2], device=x.device) < lengths[..., None]
    return (mask[..., None] * x).sum(dim=-2) / lengths[..., None].to(x.dtype)


class StackedEncoderModel(nn.Module):
    """Linear encoder + N S5 sequence layers."""

    def __init__(self, make_mixer: Callable[[], nn.Module], d_input: int,
                 n_layers: int, d_model: int, glu_variant: str = "none",
                 relufication: bool = False, batchnorm: bool = True,
                 prenorm: bool = True,
                 q_config: Optional[QuantizationConfig] = None,
                 dropout: float = 0.0, bn_momentum: float = 0.90,
                 topk: float = 1.0, approx_topk: bool = False,
                 stream_dtype: str = "float32",
                 fuse_batchnorm_linear: bool = False,
                 use_batchnorm_scale: bool = True,
                 use_batchnorm_bias: bool = True):
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
                          topk=topk, approx_topk=approx_topk,
                          fuse_batchnorm_linear=fuse_batchnorm_linear,
                          use_batchnorm_scale=use_batchnorm_scale,
                          use_batchnorm_bias=use_batchnorm_bias)
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

    def forward_stream(self, x: torch.Tensor, cache: Optional[Cache],
                       generator: Optional[torch.Generator] = None
                       ) -> Tuple[torch.Tensor, Cache]:
        x = self._encode(x)
        new_cache = []
        for i, layer in enumerate(self.layers):
            x, final = layer.forward_stream(
                x, None if cache is None else cache[i], generator)
            new_cache.append(final)
        return x, new_cache


class RegressionModel(nn.Module):
    """Encoder stack + per-step linear decoder (the NDNS denoising head):
    (B, L, d_input) -> (B, L, d_output)."""

    def __init__(self, make_mixer: Callable[[], nn.Module], d_input: int,
                 d_output: int, n_layers: int, d_model: int,
                 q_config: Optional[QuantizationConfig] = None,
                 quant_input: Optional[float] = None, padded: bool = False,
                 **layer_kw):
        super().__init__()
        q_config = q_config or QuantizationConfig.none()
        self.q_config = q_config
        #: the exponent of the input grid (``quant_input_fn``), or None
        self.quant_input = quant_input
        #: inputs are ``(x, lengths)``; the regression head ignores the
        #: lengths, as the JAX package's does
        self.padded = padded
        self.encoder = StackedEncoderModel(make_mixer, d_input, n_layers,
                                           d_model, q_config=q_config,
                                           **layer_kw)
        self.decoder = make_dense(q_config, d_model, d_output)

    def forward(self, x, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """Offline forward (the whole-layer kernel route for a float
        prenorm model, BatchNorm or LayerNorm, else the unfused route
        around the mixer kernel or the stand-alone scans). In training mode
        every layer, on either route, normalizes with the batch statistics
        (BatchNorm), moves its running statistics and draws its dropout
        masks from ``generator``, and the stream between the layers is the
        encoder's ``stream_dtype`` where the module doc says. With
        ``quant_input`` the input is first rounded to its grid."""
        if self.padded:
            x, _ = x
        x = quant_input_fn(x, self.quant_input)
        return self.decoder(self.encoder(x, generator))

    def forward_stream(self, x: torch.Tensor, cache: Optional[Cache] = None,
                       generator: Optional[torch.Generator] = None
                       ) -> Tuple[torch.Tensor, Cache]:
        """Chunk forward: every layer's scan starts from its carry in
        ``cache`` (None: zero) and the final carries come back. In
        training mode (``data/tbptt.py``) the layers take batch statistics
        and draw dropout masks from ``generator``."""
        y, new_cache = self.encoder.forward_stream(
            quant_input_fn(x, self.quant_input), cache, generator)
        return self.decoder(y), new_cache


class ClassificationModel(nn.Module):
    """Encoder stack, then pooling, a linear decoder and ``log_softmax``:
    (B, L, d_input) -> log-probabilities (B, d_output). ``mode="pool"``
    averages over time (over the valid steps when ``padded``),
    ``mode="last"`` takes the last step (``padded`` then raises, as in the
    JAX package)."""

    def __init__(self, make_mixer: Callable[[], nn.Module], d_input: int,
                 d_output: int, n_layers: int, d_model: int,
                 q_config: Optional[QuantizationConfig] = None,
                 quant_input: Optional[float] = None, padded: bool = False,
                 mode: str = "pool", **layer_kw):
        super().__init__()
        q_config = q_config or QuantizationConfig.none()
        self.q_config = q_config
        self.quant_input = quant_input
        self.padded = padded
        self.mode = mode
        self.encoder = StackedEncoderModel(make_mixer, d_input, n_layers,
                                           d_model, q_config=q_config,
                                           **layer_kw)
        self.decoder = make_dense(q_config, d_model, d_output)

    def _head(self, x: torch.Tensor, lengths) -> torch.Tensor:
        if self.mode == "pool":
            x = (masked_meanpool(x, lengths) if self.padded
                 else x.mean(dim=-2))
        elif self.mode == "last":
            if self.padded:
                raise NotImplementedError(
                    "mode='last' with padded sequences not implemented")
            x = x[..., -1, :]
        else:
            raise NotImplementedError(f"mode {self.mode}")
        return F.log_softmax(self.decoder(x), dim=-1)

    def forward(self, x, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        lengths = None
        if self.padded:
            x, lengths = x
        x = quant_input_fn(x, self.quant_input)
        return self._head(self.encoder(x, generator), lengths)


class RetrievalDecoder(nn.Module):
    """MLP over the four-feature concatenation [u1, u2, u1 - u2, u1 * u2]:
    dense (4H -> H), gelu, dense (H -> d_output). The denses keep the JAX
    package's automatic names (``QDense_0`` / ``QDense_1``,
    ``QuantizedDense_*`` under static quantization)."""

    def __init__(self, d_model: int, d_output: int,
                 q_config: Optional[QuantizationConfig] = None):
        super().__init__()
        q_config = q_config or QuantizationConfig.none()
        prefix = "QuantizedDense" if q_config.static_quant else "QDense"
        self.names = (f"{prefix}_0", f"{prefix}_1")
        self.add_module(self.names[0],
                        make_dense(q_config, 4 * d_model, d_model))
        self.add_module(self.names[1],
                        make_dense(q_config, d_model, d_output))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        first, second = (getattr(self, n) for n in self.names)
        return second(F.gelu(first(x), approximate="tanh"))


class RetrievalModel(nn.Module):
    """Document matching: (2B, L, d_input), the first B rows the first
    documents and the last B the second, -> log-probabilities
    (B, d_output). Both halves go through one encoder stack and are pooled
    (over the valid steps when ``padded``)."""

    def __init__(self, make_mixer: Callable[[], nn.Module], d_input: int,
                 d_output: int, n_layers: int, d_model: int,
                 q_config: Optional[QuantizationConfig] = None,
                 padded: bool = False, **layer_kw):
        super().__init__()
        q_config = q_config or QuantizationConfig.none()
        self.q_config = q_config
        self.padded = padded
        self.encoder = StackedEncoderModel(make_mixer, d_input, n_layers,
                                           d_model, q_config=q_config,
                                           **layer_kw)
        self.decoder = RetrievalDecoder(d_model, d_output, q_config)

    def forward(self, x, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        lengths = None
        if self.padded:
            x, lengths = x
        x = self.encoder(x, generator)
        x = masked_meanpool(x, lengths) if self.padded else x.mean(dim=-2)
        u1, u2 = torch.chunk(x, 2, dim=0)
        features = torch.cat([u1, u2, u1 - u2, u1 * u2], dim=-1)
        return F.log_softmax(self.decoder(features), dim=-1)
