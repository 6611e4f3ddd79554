"""NDNS train and eval steps (counterpart of
``sparsernns_tpu/train/steps.py`` ``make_ndns_train_step``,
``_make_ndns_microbatch_step`` and ``make_ndns_eval_step``).

The train step updates the model, the optimizer and the state's step count
in place (the JAX step returns a new immutable state; here the tensors are
owned by the model and the optimizer) and returns the same state object.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from sparsernns_tpu_torch.train.losses import (STFT_MAG_MEAN,
                                               ndns_loss_from_mask_tm)
from sparsernns_tpu_torch.train.optim import optimizer_step
from sparsernns_tpu_torch.train.state import TrainState


def _loss(model, generator, noisy_mag, noisy_phase, clean_mag, clean):
    """(loss, mean SI-SNR) of one (micro)batch. The whole loss path runs
    time-major (B, L, F), the model's own layout; the spectra are
    transposed once here (only the mask carries gradients)."""
    noisy_mag_tm = noisy_mag.transpose(1, 2)
    out = model(noisy_mag_tm - STFT_MAG_MEAN, generator)
    loss, snr, _ = ndns_loss_from_mask_tm(
        out, noisy_mag_tm, noisy_phase.transpose(1, 2),
        clean_mag.transpose(1, 2), clean)
    return loss, snr


def _grad_norm_metrics(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Global gradient norm and one per top-level branch of the model
    (``grad_norm/encoder``, ``grad_norm/decoder``)."""
    squares: Dict[str, torch.Tensor] = {}
    for name, param in model.named_parameters():
        if param.grad is None:
            continue
        branch = name.split(".")[0]
        sq = (param.grad * param.grad).sum()
        squares[branch] = squares[branch] + sq if branch in squares else sq
    out = {f"grad_norm/{k}": torch.sqrt(v) for k, v in squares.items()}
    out["grad_norm"] = torch.sqrt(sum(squares.values()))
    return out


def make_ndns_train_step(model: torch.nn.Module,
                         microbatch: Optional[int] = None) -> Callable:
    """NDNS denoising train step: ``step(state, noisy_mag, noisy_phase,
    clean_mag, clean)`` -> ``(state, metrics)``. Spectra are (B, F, L) as
    :func:`~sparsernns_tpu_torch.ops.stft.stft_splitter` gives them, clean
    audio (B, T); metrics are 0-dim tensors on the model's device:
    ``loss``, ``si_snr``, ``grad_norm`` and ``grad_norm/<branch>``.

    ``microbatch``: gradient-accumulation microbatch size. The batch is
    split into B / microbatch chunks that run one after the other; the
    gradients are their sum / k, which for equal chunks of a batch-mean
    loss is the full-batch mean gradient, and one optimizer update follows.
    BatchNorm normalizes each chunk with its own statistics and moves the
    running statistics chunk by chunk; dropout draws fresh masks per
    chunk. The dropout masks come from ``state.generator``, which moves on
    with every draw, so every step sees other masks."""

    def step(state: TrainState, noisy_mag, noisy_phase, clean_mag, clean):
        if state.model is not model:
            raise ValueError("the state holds another model than the step")
        batch = noisy_mag.shape[0]
        size = batch if microbatch is None else microbatch
        if batch % size:
            raise ValueError(
                f"batch {batch} not divisible by microbatch {size}")
        k = batch // size
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        losses, snrs = [], []
        for i in range(k):
            rows = slice(i * size, (i + 1) * size)
            loss, snr = _loss(model, state.generator, noisy_mag[rows],
                              noisy_phase[rows], clean_mag[rows],
                              clean[rows])
            loss.backward()             # .grad accumulates the sum
            losses.append(loss.detach())
            snrs.append(snr.detach())
        if k > 1:
            for param in model.parameters():
                if param.grad is not None:
                    param.grad.div_(k)
        metrics = {"loss": torch.stack(losses).mean(),
                   "si_snr": torch.stack(snrs).mean()}
        metrics.update(_grad_norm_metrics(model))
        optimizer_step(state.optimizer, state.step)
        state.step += 1
        return state, metrics

    return step


def make_ndns_eval_step(model: torch.nn.Module) -> Callable:
    """Returns ``step(noisy_mag, noisy_phase, clean_mag, clean)`` ->
    ``{"loss", "si_snr"}`` (0-dim tensors). Spectra are (B, F, L) as
    :func:`~sparsernns_tpu_torch.ops.stft.stft_splitter` gives them; the
    model runs in eval mode on its own device (a model in training mode is
    switched to eval for the call and back)."""

    @torch.no_grad()
    def step(noisy_mag, noisy_phase, clean_mag, clean
             ) -> Dict[str, torch.Tensor]:
        was_training = model.training
        model.eval()
        try:
            loss, snr = _loss(model, None, noisy_mag, noisy_phase,
                              clean_mag, clean)
        finally:
            model.train(was_training)
        return {"loss": loss, "si_snr": snr}

    return step
