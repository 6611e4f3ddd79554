"""Truncated backpropagation through time (counterpart of
``sparsernns_tpu/data/tbptt.py``): long sequences split into chunks of a
fixed length with an optional overlap prefix, each chunk with a ``reset``
flag that is True for the first chunk of a batch, and a train step that
carries every layer's mixer state from one chunk into the next.

The carry is the per-layer state pair of the models' carried forward
(``forward_stream``), here in training mode: batch statistics, dropout
masks from the state's generator, and autograd through the plain scans.
It enters each step as a tensor without gradient, which is the
truncation. As in the JAX package only the plain scans differentiate
with a carry (``scan_mode="associative"``, ``"sequential"``,
``"blocked"``): a ``"fused"`` or ``"pallas"`` model raises, since the
carried scan kernel has no gradient in either package.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from sparsernns_tpu_torch.ops.scan import Pair
from sparsernns_tpu_torch.train.optim import optimizer_step


def tbptt_chunks(x: np.ndarray, y: Optional[np.ndarray], chunk_len: int,
                 overlap_len: int = 1, pad_value: float = 0.0
                 ) -> Iterator[Tuple[np.ndarray, Any, bool]]:
    """Split one batch (x: (B, L, ...), y: per-step (B, L, ...) or
    per-sequence (B,)) into chunks: x left-padded with ``overlap_len - 1``
    steps of ``pad_value``, each chunk of ``chunk_len + overlap_len - 1``
    steps with that overlap prefix, per-step targets over the non-overlap
    span only, ``reset`` True for the first chunk. The last chunk start
    of the range is dropped, as the reference loader drops it."""
    if chunk_len <= 0:
        raise ValueError(f"chunk_len must be positive, got {chunk_len}")
    if overlap_len < 1:
        raise ValueError(f"overlap_len must be >= 1, got {overlap_len}")
    b, seq = x.shape[0], x.shape[1]

    def pad(a, val):
        pad_block = np.full((b, overlap_len - 1) + a.shape[2:], val,
                            a.dtype)
        return np.concatenate([pad_block, a], axis=1)

    x = pad(x, pad_value)
    y_stepwise = y is not None and y.ndim > 1 and y.shape[1] == seq
    if y_stepwise:
        y = pad(y, 0)
    total = x.shape[1]
    reset = True
    for begin in list(range(overlap_len - 1, total, chunk_len))[:-1]:
        start = begin - overlap_len + 1
        end = begin + chunk_len
        yield x[:, start:end], (y[:, begin:end] if y_stepwise else y), reset
        reset = False


class TBPTTLoader:
    """Any ``(x, y)`` batch loader as a stream of TBPTT chunks
    ``(x_chunk, y_chunk, reset)``."""

    def __init__(self, loader, chunk_len: int, overlap_len: int = 1,
                 pad_value: float = 0.0):
        self.loader = loader
        self.chunk_len = chunk_len
        self.overlap_len = overlap_len
        self.pad_value = pad_value

    def __iter__(self):
        for x, y in self.loader:
            yield from tbptt_chunks(np.asarray(x), np.asarray(y),
                                    self.chunk_len, self.overlap_len,
                                    self.pad_value)

    def __len__(self):
        # chunks a batch: ceil(seq / chunk) - 1
        per_batch = max(0, -(-_first_len(self.loader) // self.chunk_len) - 1)
        return len(self.loader) * per_batch


def _first_len(loader) -> int:
    seq = getattr(loader, "seq_len",
                  getattr(getattr(loader, "dataset", None), "seq_len", None))
    if seq is None:
        raise TypeError("loader must expose seq_len for len(TBPTTLoader)")
    return seq


def zero_carry(carry: List[Pair]) -> List[Pair]:
    """The carry reset: zeros of every layer's state pair."""
    return [(torch.zeros_like(c[0]), torch.zeros_like(c[1])) for c in carry]


def init_carry(model: torch.nn.Module, x_chunk: torch.Tensor
               ) -> List[Pair]:
    """Zero carries for ``x_chunk``'s batch: one (B, P) pair a layer, on
    the model's device."""
    device = next(model.parameters()).device
    b = x_chunk.shape[0]
    return [(torch.zeros(b, lay.mixer.p, device=device),
             torch.zeros(b, lay.mixer.p, device=device))
            for lay in model.encoder.layers]


def make_tbptt_train_step(model: torch.nn.Module,
                          loss_fn: Callable[[torch.Tensor, Any],
                                            torch.Tensor],
                          overlap_len: int = 1) -> Callable:
    """One TBPTT chunk step: the training forward from the incoming carry
    (``model.forward_stream``), ``loss_fn(out, y_chunk)`` on the chunk's
    non-overlap span, the gradients truncated at the chunk's start, one
    optimizer update, the chunk's final states as the next carry.

    Returns ``step(state, carry, x_chunk, y_chunk) -> (state, carry,
    metrics)`` with ``metrics = {"loss"}``; ``state`` moves on in place.
    Call :func:`zero_carry` on ``reset``."""

    def step(state, carry: List[Pair], x_chunk: torch.Tensor, y_chunk):
        if state.model is not model:
            raise ValueError("the state holds another model than the step")
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        carry = [(c[0].detach(), c[1].detach()) for c in carry]
        out, new_carry = model.forward_stream(x_chunk, carry,
                                              state.generator)
        if overlap_len > 1:
            out = out[:, overlap_len - 1:]
        loss = loss_fn(out, y_chunk)
        loss.backward()
        optimizer_step(state.optimizer, state.step)
        state.step += 1
        new_carry = [(c[0].detach(), c[1].detach()) for c in new_carry]
        return state, new_carry, {"loss": loss.detach()}

    return step
