"""Kernel K6: the whole serving network in one call.

Replaces ``sparsernns_tpu/ops/pallas/fused_network.py``
``fused_network_apply`` in float-dot mode and in the integer-dot modes
(``engine_layer.py``; the encoder's and decoder's as JAX's
``_boundary_dense``): per time block, the encoder dense (+ its output
requant, + relu), every layer as in ``engine_layer.py`` with the store and
load of the stream between two layers reproduced as values, and the
decoder dense, with every layer's scan carry resident across blocks.
Input (B, L, d_in) float32 / bfloat16, output (B, L, d_out) in
``out_dtype``. Bit-identical to the per-layer stack (``engine_layer`` with
``enc`` on the first launch and ``dec`` on the last) at the same block.

On the card the call is ``n_layers + 1`` row passes and ``n_layers``
scans over the whole card (``engine_layer.py``'s :func:`pass_plan`; the
tail of layer l and the head of layer l + 1 share a row pass), enqueued by
one C call, with the stream and bu in scratch that this wrapper allocates.

The CUDA source is ``csrc/engine_network.cu`` over ``csrc/engine_passes.cuh``
and ``csrc/engine_body.cuh`` (shared with K5). :func:`engine_network`
launches the passes for CUDA tensors (or raises) and takes
:func:`engine_network_plain` only for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from sparsernns_tpu_torch.ops.cuda import build
from sparsernns_tpu_torch.ops.cuda.engine_layer import (
    IO_TYPES, MAX_SMEM, Dense, DenseW, LayerMode, LayerParams, Mode,
    alloc_scratch, check_row_passes, zero_carry, dense_plain, encode_plain,
    layer_body_plain, pack_dense, pad128, pack_layer, pack_mode, pass_plan,
    read_launched, stream_value, widest_row_pass)
from sparsernns_tpu_torch.utils.trace import count, traced

#: most layers one call takes (``kMaxLayers`` of the CUDA source)
MAX_LAYERS = 8


def _check_args(x, enc: Dense, layers: Sequence, dec: Dense, block_t: int):
    d_in = enc.kernel.data.shape[0]
    if x.dim() != 3 or x.shape[-1] != d_in:
        raise ValueError(f"x must be (B, L, {d_in}), got {tuple(x.shape)}")
    if not 1 <= len(layers) <= MAX_LAYERS:
        raise ValueError(f"1..{MAX_LAYERS} layers, got {len(layers)}")
    if block_t < 1:
        raise ValueError(f"block_t {block_t}")


def engine_network_plain(x: torch.Tensor, enc: Dense, layers: Sequence,
                         dec: Dense, mode: LayerMode, *, block_t: int,
                         out_dtype: torch.dtype = torch.float32
                         ) -> torch.Tensor:
    """Plain PyTorch version: per time block of ``block_t`` frames, the
    encoder, every layer (the body shared with ``engine_layer_plain``,
    recurrence step by step) and the decoder."""
    _check_args(x, enc, layers, dec, block_t)
    carries = [zero_carry(x, layer) for layer in layers]
    outs = []
    for s in range(0, x.shape[1], block_t):
        hb = encode_plain(x[:, s:s + block_t], enc, mode)
        for i, layer in enumerate(layers):
            hb, carries[i] = layer_body_plain(hb, layer, mode, carries[i])
            hb = stream_value(hb, layer, mode)
        outs.append(dense_plain(hb, dec, pad128(hb.shape[-1])).to(out_dtype))
    return torch.cat(outs, dim=1)


_FWD_ARGS = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
              ctypes.POINTER(LayerParams), ctypes.c_int, ctypes.POINTER(Mode),
              ctypes.POINTER(DenseW), ctypes.c_int, ctypes.POINTER(DenseW),
              ctypes.c_int] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3)


def launched():
    """The passes of the last K6 call on the card, (kernel, CTAs) in
    order, as the CUDA source recorded them at the launch."""
    return read_launched("engine_network")


@traced("kernel.engine_network")
def engine_network_cuda(x: torch.Tensor, enc: Dense, layers: Sequence,
                        dec: Dense, mode: LayerMode, *, block_t: int,
                        out_dtype: torch.dtype = torch.float32
                        ) -> torch.Tensor:
    """Enqueue the passes (:func:`pass_plan`) for all of L. Same
    arguments as :func:`engine_network_plain`, every tensor on ``x``'s
    CUDA device."""
    _check_args(x, enc, layers, dec, block_t)
    if x.dtype not in (torch.float32, torch.bfloat16) or out_dtype not in (
            torch.float32, torch.bfloat16):
        raise ValueError(f"io dtypes {x.dtype} / {out_dtype}")
    dev = x.device
    b, l, d_in = x.shape
    h = enc.kernel.data.shape[1]
    d_out = dec.kernel.data.shape[1]
    x = x.contiguous()
    out = torch.empty((b, l, d_out), dtype=out_dtype, device=dev)
    if b == 0 or l == 0:
        return out
    packed = (LayerParams * len(layers))(
        *[pack_layer(layer, mode, dev) for layer in layers])
    md = pack_mode(mode, h)
    enc_w = pack_dense(enc, "encoder", (d_in, h), dev)
    dec_w = pack_dense(dec, "decoder", (h, d_out), dev, pad128(h))
    p_max = max(layer.w_b.shape[-1] // 2 for layer in layers)
    n = len(layers)
    if widest_row_pass(h, p_max, d_in) > MAX_SMEM:
        check_row_passes(h, 2 * p_max, [
            dict(d_in=d_in, enc=enc_w if i == 0 else None,
                 dec=dec_w if i == n else None,
                 tail=packed[i - 1] if i > 0 else None,
                 head=packed[i] if i < n else None) for i in range(n + 1)])
    scratch = alloc_scratch(pass_plan(b, l, h, p_max, len(layers)), dev)
    err = build.entry("engine_network", "engine_network_fwd", _FWD_ARGS)(
        x.data_ptr(), out.data_ptr(), IO_TYPES[x.dtype], IO_TYPES[out_dtype],
        packed, len(layers), ctypes.byref(md), ctypes.byref(enc_w), d_in,
        ctypes.byref(dec_w), d_out, b, l, int(block_t),
        scratch["bu"].data_ptr(), scratch["stream"].data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "engine_network")
    count("engine_network")
    return out


def engine_network(x: torch.Tensor, enc: Dense, layers: Sequence, dec: Dense,
                   mode: LayerMode, **kw) -> torch.Tensor:
    """The whole network on (B, L, d_in). CUDA tensors launch the passes
    (or raise); CPU tensors take the plain version."""
    fn = engine_network_cuda if x.is_cuda else engine_network_plain
    return fn(x, enc, layers, dec, mode, **kw)
