"""NDNS eval step (counterpart of ``sparsernns_tpu/train/steps.py``
``make_ndns_eval_step``). Forward only; the train step waits for the
training port."""

from __future__ import annotations

from typing import Callable, Dict

import torch

from sparsernns_tpu_torch.train.losses import (STFT_MAG_MEAN,
                                               ndns_loss_from_mask_tm)


def make_ndns_eval_step(model: torch.nn.Module) -> Callable:
    """Returns ``step(noisy_mag, noisy_phase, clean_mag, clean)`` ->
    ``{"loss", "si_snr"}`` (0-dim tensors). Spectra are (B, F, L) as
    :func:`~sparsernns_tpu_torch.ops.stft.stft_splitter` gives them; the
    model runs in eval mode on its own device."""

    @torch.no_grad()
    def step(noisy_mag, noisy_phase, clean_mag, clean
             ) -> Dict[str, torch.Tensor]:
        noisy_mag_tm = noisy_mag.transpose(1, 2)
        out = model(noisy_mag_tm - STFT_MAG_MEAN)
        loss, snr, _ = ndns_loss_from_mask_tm(
            out, noisy_mag_tm, noisy_phase.transpose(1, 2),
            clean_mag.transpose(1, 2), clean)
        return {"loss": loss, "si_snr": snr}

    return step
