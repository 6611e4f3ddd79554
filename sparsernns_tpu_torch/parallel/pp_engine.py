"""Pipeline-parallel serving of the engine (counterpart of
``sparsernns_tpu/parallel/pp_engine.py``).

Contiguous groups of layers (stages) run on a list of devices, and time
chunks flow from stage to stage while each stage keeps its SSM carries:
the GPipe schedule with time in place of the microbatches. A chunk of
stage s needs stage s's carry from the chunk before, which is all the
state a stage has, so nothing is recomputed or stashed, and chunked scans
with carries are the whole scan.

The JAX package runs the stages on the devices of its mesh's model axis
(one SPMD program with a ``ppermute`` ring on its float route, one program
a device on its mxu16 route). Here one process drives both routes over a
list of ``torch.device``: stage s lives on ``devices[s]`` with a CUDA
stream of its own; a chunk goes to the next stage by ``.to(devices[s+1],
non_blocking=True)`` after an event on its stage's stream. On one card
every stage is ``cuda:0`` and the stages still overlap on their streams.
The host issues the ticks in order; the devices run them as the events
allow.

- The mxu16 route: each stage is the engine's chunked whole-layer
  forward over its layers (``W8A16Engine._apply_chunk_stack``: the
  whole-layer kernel with a carry), so the output is ``process_chunk``'s
  at the same chunk length, bit for bit.
- The float route: each stage runs the engine's per-op float layer body
  (``engine_layer_forward``, as the sequence- and tensor-parallel
  forwards do) per chunk, its mixer input f32 as in the JAX package's
  float pipeline body, around the scan from the carry (the scan kernel
  on the card) with every layer's B and C dequantized.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import Optional, Sequence

import torch

from sparsernns_tpu_torch.ops.scan import diag_ssm_scan
from sparsernns_tpu_torch.quantize.engine import (W8A16Engine, engine_encode,
                                                  engine_layer_forward,
                                                  quantized_dense,
                                                  state_activation)


def _to(obj, device: torch.device):
    """``obj`` with every tensor it holds (in dataclass fields, tuples and
    lists) on ``device``; the object itself where nothing moves."""
    if torch.is_tensor(obj):
        return obj.to(device)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _to(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, (tuple, list)):
        items = [_to(v, device) for v in obj]
        return type(obj)(*items) if hasattr(obj, "_fields") else \
            type(obj)(items)
    return obj


def _index(device) -> torch.device:
    """``device`` with the current card's index where it names none."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _engine_on(engine: W8A16Engine, device: torch.device) -> W8A16Engine:
    """The engine, or a shallow copy of it whose tensors are on
    ``device``."""
    if _index(device) == _index(engine.device):
        return engine
    moved = copy.copy(engine)
    for name, value in vars(engine).items():
        setattr(moved, name, _to(value, device))
    moved.device = torch.device(device)
    return moved


def _stages(n_layers: int, devices: Sequence) -> int:
    n_stages = len(devices)
    if n_stages < 1 or n_layers % n_stages:
        raise ValueError(f"{n_layers} layers do not partition into "
                         f"{n_stages} stages")
    return n_layers // n_stages


def _uniform(vals, what: str):
    """All layers must share the value (the JAX package's stages run one
    SPMD program)."""
    if len(set(vals)) > 1:
        raise NotImplementedError(
            f"make_pp_forward requires uniform per-layer {what}, got "
            f"{vals}")
    return vals[0]


class _Schedule:
    """GPipe over time chunks: at tick t stage s runs chunk t - s. Stages
    are issued last-first within a tick, so each takes the handoff of the
    tick before. ``run(s, c, inp)`` runs stage s on chunk c and returns its
    output, on ``devices[s]``."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = [torch.device(d) for d in devices]
        cuda = all(d.type == "cuda" for d in self.devices)
        self.streams = ([torch.cuda.Stream(device=d) for d in self.devices]
                        if cuda else None)

    def _stream(self, s: int):
        if self.streams is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.streams[s])

    def __call__(self, x_chunks, run):
        """``x_chunks`` and whatever ``run`` reads (the carries) were
        written on the caller's streams: each stage's stream waits for
        its device's current stream before its first chunk."""
        n_stages, n_chunks = len(self.devices), len(x_chunks)
        if self.streams is not None:
            for stream, device in zip(self.streams, self.devices):
                stream.wait_stream(torch.cuda.current_stream(device))
        outs = [None] * n_chunks
        handoff = [None] * n_stages   # (tensor, event) for stage s + 1
        for t in range(n_chunks + n_stages - 1):
            for s in reversed(range(n_stages)):
                c = t - s
                if not 0 <= c < n_chunks:
                    continue
                with self._stream(s):
                    if s == 0:
                        inp = x_chunks[c]
                    else:
                        inp, event = handoff[s - 1]
                        if event is not None:
                            self.streams[s].wait_event(event)
                        inp = inp.to(self.devices[s], non_blocking=True)
                        if self.streams is not None:
                            inp.record_stream(self.streams[s])
                    out = run(s, c, inp)
                    event = None
                    if self.streams is not None:
                        event = torch.cuda.Event()
                        event.record(self.streams[s])
                if s == n_stages - 1:
                    outs[c] = (out, event)
                else:
                    handoff[s] = (out, event)
        if self.streams is not None:
            current = torch.cuda.current_stream(self.devices[-1])
            for out, event in outs:
                current.wait_event(event)
                out.record_stream(current)
        return torch.cat([o for o, _ in outs], dim=1)


def _make_pp_forward_mxu16(engine: W8A16Engine, devices, chunks):
    per = _stages(len(engine.layers), devices)
    n_stages = len(devices)
    stage_eng = [_engine_on(engine, d) for d in devices]
    sched = _Schedule(devices)

    @torch.no_grad()
    def forward(x):
        x = engine._input(x)
        b, length, _ = x.shape
        n_chunks = chunks if chunks is not None else 2 * n_stages
        if length % n_chunks:
            raise ValueError(f"L={length} not divisible by {n_chunks} "
                             "chunks")
        lc = length // n_chunks
        carries = [list(stage_eng[s].init_stream_state(b)[
            s * per:(s + 1) * per]) for s in range(n_stages)]
        x0 = x.to(sched.devices[0])

        def run(s, c, inp):
            eng = stage_eng[s]
            out, carries[s] = eng._apply_chunk_stack(
                inp, carries[s], eng.block_t, lo=s * per,
                encode=s == 0, decode=s == n_stages - 1,
                layers=eng.layers[s * per:(s + 1) * per])
            return out

        return sched([x0[:, c * lc:(c + 1) * lc] for c in range(n_chunks)],
                     run)

    return forward


def make_pp_forward(engine: W8A16Engine, devices: Sequence,
                    chunks: Optional[int] = None):
    """Pipeline the engine's layers over ``len(devices)`` stages (stage s
    on ``devices[s]``; the JAX package takes the devices of its mesh's
    model axis). ``n_layers`` must divide into the stages; the float
    route needs uniform layer operands (state compaction off or uniform),
    GLU ``half1`` or ``none`` and no top-k. Returns ``forward(x (B, L,
    d_in)) -> (B, L, d_out)`` on the last stage's device, with L divisible
    by ``chunks`` (default ``2 * n_stages``).

    An mxu16 engine takes the mxu16 route (whole-layer kernels per stage,
    the true carry in hand, so its per-step requants run unchanged); every
    other engine the float route."""
    m = getattr(engine, "mxu16", None)
    if m and (m.get("mixer") or m.get("state") or m.get("requants")):
        return _make_pp_forward_mxu16(engine, devices, chunks)
    cfg = engine.cfg
    layers = engine.layers
    per = _stages(len(layers), devices)
    n_stages = len(devices)
    _uniform([lp.lam[0].shape[0] for lp in layers], "state dim P")
    _uniform(
        [None if lp.residual_requant is None else lp.residual_requant[1]
         for lp in layers], "residual_requant bits")
    _uniform(
        [None if lp.out2_in_scale is None else lp.out2_in_scale[1]
         for lp in layers], "out2 in_scale bits")
    if cfg.glu_variant not in ("half1", "none"):
        raise NotImplementedError(
            f"make_pp_forward supports glu half1/none, got "
            f"{cfg.glu_variant}")
    if cfg.topk < 1.0:
        raise NotImplementedError("make_pp_forward does not support top-k")

    stage_eng = [_engine_on(engine, d) for d in devices]
    # each stage's layers with their scan operands, dequantized once on
    # the stage's device
    stage_ops = [[(lp, lp.wb_f32(), lp.wc_f32())
                  for lp in stage_eng[s].layers[s * per:(s + 1) * per]]
                 for s in range(n_stages)]
    first, last = stage_eng[0], stage_eng[-1]
    sched = _Schedule(devices)

    def mixer(lp, w_b, w_c, carry):
        """The S5 mixer on a time chunk from ``carry`` (the JAX package's
        float pipeline body keeps its input f32): (y, the new carry)."""
        def fn(z):
            bu = z @ w_b
            p = bu.shape[-1] // 2
            xs = diag_ssm_scan(lp.lam, (bu[..., :p], bu[..., p:]),
                               carry_init=carry)
            new_carry = (xs[0][..., -1, :], xs[1][..., -1, :])
            xs = state_activation(cfg, xs)
            return torch.cat(xs, dim=-1) @ w_c + lp.d * z, new_carry
        return fn

    @torch.no_grad()
    def forward(x):
        x = engine._input(x)
        b, length, _ = x.shape
        n_chunks = chunks if chunks is not None else 2 * n_stages
        if length % n_chunks:
            raise ValueError(f"L={length} not divisible by {n_chunks} "
                             "chunks")
        lc = length // n_chunks
        carries = [[None] * per for _ in range(n_stages)]
        x0 = x.to(sched.devices[0])

        def run(s, c, h):
            if s == 0:
                h = engine_encode(cfg, first.encoder_kernel,
                                  first.encoder_bias, h.to(torch.float32),
                                  in_scale=first.encoder_in_scale)
            for j, (lp, w_b, w_c) in enumerate(stage_ops[s]):
                carry = carries[s][j]
                if carry is None:
                    zeros = h.new_zeros((b, lp.lam[0].shape[0]))
                    carry = (zeros, zeros)
                h, carries[s][j] = engine_layer_forward(
                    cfg, lp, h, mixer(lp, w_b, w_c, carry),
                    act_dtype=torch.float32)
            if s == n_stages - 1:
                h = quantized_dense(h, last.decoder_kernel,
                                    last.decoder_bias,
                                    last.decoder_in_scale)
            return h

        return sched([x0[:, c * lc:(c + 1) * lc] for c in range(n_chunks)],
                     run)

    return forward
