"""Data-, sequence- and tensor-parallel serving of the engine (counterpart
of ``sparsernns_tpu/parallel/sp_engine.py``).

Each forward takes the whole input (B, L, d_in), the same on every rank,
as the JAX package's forward takes its global array, and returns this
rank's part of the output as the JAX package shards it:

- :func:`make_dp_forward`: the engine's own route (the whole-network
  kernel where it applies) on this data rank's rows; no collective;
- :func:`make_sp_forward`: this seq rank's time chunk through the
  engine's per-op float layer body (``engine_layer_forward``) around the
  sequence-parallel scan (``seqscan.seq_chunk_scan``: the scan kernel on
  the chunk, one gather of the (λ^T, end state) pairs a layer);
- :func:`make_tp_forward`: the whole output, with P split over the model
  ranks: each rank scans its P-slice (the scan kernel) and one all-reduce
  of the C-projection's partial sum (B, L, H) a layer joins them.
"""

from __future__ import annotations

import torch

from sparsernns_tpu_torch.ops.scan import diag_ssm_scan
from sparsernns_tpu_torch.parallel import comms
from sparsernns_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS,
                                                SEQ_AXIS, Mesh)
from sparsernns_tpu_torch.parallel.seqscan import seq_chunk_scan
from sparsernns_tpu_torch.quantize.engine import (W8A16Engine, engine_encode,
                                                  engine_layer_forward,
                                                  quantized_dense,
                                                  state_activation)


def make_dp_forward(engine: W8A16Engine, mesh: Mesh):
    """Data-parallel forward: ``forward(x)`` -> this data rank's rows of
    the mask, (B / n, L, d_out), from the engine's own route on those
    rows, weights replicated, no collective. The batch must be divisible
    by the data axis. Per row it is the one-device call's mask: the same
    kernels, on rows that do not depend on each other."""
    n, i = mesh.size(DATA_AXIS), mesh.index(DATA_AXIS)

    def forward(x):
        x = engine._input(x)
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} not divisible by data "
                             f"axis ({n})")
        rows = x.shape[0] // n
        return engine._apply(x[i * rows:(i + 1) * rows], engine.block_t)

    return forward


def _reject_mxu16(engine, what: str):
    """The sp / tp / pp-float serving paths run the per-op float mixer
    body, which has no hooks for the mxu16 mode's requant chain: serving
    such an engine through them would silently differ from its
    one-device forward. The dense sites follow the engine's frozen input
    grids (so a w8a8 engine serves as it does alone); DP runs the
    engine's own route and takes every mode."""
    m = getattr(engine, "mxu16", None)
    if m and (m.get("mixer") or m.get("state") or m.get("requants")):
        raise NotImplementedError(
            f"{what} does not support the mxu16 engine mode — build the "
            "engine with mxu16=False, or use make_dp_forward")


def _encode(engine: W8A16Engine, x: torch.Tensor) -> torch.Tensor:
    return engine_encode(engine.cfg, engine.encoder_kernel,
                         engine.encoder_bias, x.to(torch.float32),
                         in_scale=engine.encoder_in_scale)


def _decode(engine: W8A16Engine, h: torch.Tensor) -> torch.Tensor:
    return quantized_dense(h, engine.decoder_kernel, engine.decoder_bias,
                           engine.decoder_in_scale)


def make_sp_forward(engine: W8A16Engine, mesh: Mesh):
    """Sequence-parallel forward: ``forward(x)`` -> this seq rank's time
    chunk of the mask, the L / n frames from L / n · index. L must be
    divisible by the seq axis."""
    _reject_mxu16(engine, "make_sp_forward")
    cfg = engine.cfg
    group, n = mesh.group(SEQ_AXIS), mesh.size(SEQ_AXIS)
    i = mesh.index(SEQ_AXIS)

    @torch.no_grad()
    def forward(x):
        x = engine._input(x)
        length = x.shape[1]
        if length % n:
            raise ValueError(f"L={length} not divisible by the seq axis "
                             f"({n})")
        part = length // n
        h = _encode(engine, x[:, i * part:(i + 1) * part])
        for layer in engine.layers:
            def mixer(z, layer=layer):
                z = z.to(torch.float32)
                bu = z @ layer.wb_f32()
                p = layer.p
                xs = seq_chunk_scan(layer.lam, (bu[..., :p], bu[..., p:]),
                                    group)
                xs = state_activation(cfg, xs)
                return torch.cat(xs, dim=-1) @ layer.wc_f32() + \
                    layer.d * z, None

            h, _ = engine_layer_forward(cfg, layer, h, mixer,
                                        act_dtype=engine.act_dtype)
        return _decode(engine, h)

    return forward


def make_tp_forward(engine: W8A16Engine, mesh: Mesh):
    """Tensor-parallel forward: ``forward(x)`` -> the whole mask on every
    model rank, the SSM state dim P split over the model ranks (P must be
    divisible by the model axis)."""
    _reject_mxu16(engine, "make_tp_forward")
    cfg = engine.cfg
    group, n = mesh.group(MODEL_AXIS), mesh.size(MODEL_AXIS)
    i = mesh.index(MODEL_AXIS)
    # each layer's P-slice of λ, of W_b's two halves' columns and of W_c's
    # two halves' rows, dequantized (the int8 packing is a per-card
    # serving layout, kept out of the split)
    shards = []
    for layer in engine.layers:
        p = layer.p
        if p % n:
            raise ValueError(f"P={p} does not split over {n} model ranks")
        part = p // n
        cols = torch.cat([torch.arange(i * part, (i + 1) * part),
                          p + torch.arange(i * part, (i + 1) * part)]
                         ).to(engine.device)
        sl = slice(i * part, (i + 1) * part)
        shards.append(((layer.lam[0][sl], layer.lam[1][sl]),
                       layer.wb_f32()[:, cols], layer.wc_f32()[cols, :]))

    @torch.no_grad()
    def forward(x):
        h = _encode(engine, engine._input(x))
        for layer, (lam, w_b, w_c) in zip(engine.layers, shards):
            def mixer(z, layer=layer, lam=lam, w_b=w_b, w_c=w_c):
                z = z.to(torch.float32)
                bu = z @ w_b
                part = w_b.shape[-1] // 2
                xs = diag_ssm_scan(lam, (bu[..., :part], bu[..., part:]))
                xs = state_activation(cfg, xs)
                y_part = torch.cat(xs, dim=-1) @ w_c
                return comms.all_reduce(y_part, group) + layer.d * z, None

            h, _ = engine_layer_forward(cfg, layer, h, mixer,
                                        act_dtype=engine.act_dtype)
        return _decode(engine, h)

    return forward
