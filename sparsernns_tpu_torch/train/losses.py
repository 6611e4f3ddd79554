"""Losses and quality metrics (counterpart of
``sparsernns_tpu/train/losses.py``): SI-SNR and the NDNS objective
0.001·MSE(mag) + (100 − SI-SNR); the classification heads' cross entropy
and accuracy."""

from __future__ import annotations

from typing import Tuple

import torch

from sparsernns_tpu_torch.ops.stft import stft_mixer_tm

_EPS = 1e-8

STFT_MAG_MEAN = 0.0007  # input mean-subtraction constant
NDNS_LOSS_LAMBDA = 0.001


def si_snr(target: torch.Tensor, estimate: torch.Tensor) -> torch.Tensor:
    """Scale-invariant SNR in dB over the last (time) axis; leading axes
    are kept."""
    s_target = target - target.mean(dim=-1, keepdim=True)
    s_estimate = estimate - estimate.mean(dim=-1, keepdim=True)
    dot = (s_target * s_estimate).sum(dim=-1, keepdim=True)
    t_norm = (s_target ** 2).sum(dim=-1, keepdim=True)
    proj = dot * s_target / t_norm
    noise = s_estimate - proj
    ratio = (proj ** 2).sum(dim=-1) / ((noise ** 2).sum(dim=-1) + _EPS)
    return 10.0 * torch.log10(ratio + _EPS)


def ndns_loss_from_mask_tm(mask, noisy_mag, noisy_phase, clean_mag,
                           clean_audio
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Time-major NDNS objective: spectral tensors are (B, L, F), the
    layout the model emits; clean_audio (B, T). Returns (loss, mean
    SI-SNR, cleaned magnitude (B, L, F))."""
    cleaned_mag = noisy_mag * (1.0 + mask)
    cleaned = stft_mixer_tm(cleaned_mag, noisy_phase)
    # the iSTFT length is hop-aligned and may exceed the audio length
    cleaned = cleaned[..., :clean_audio.shape[-1]]
    snr = si_snr(cleaned, clean_audio)
    loss = NDNS_LOSS_LAMBDA * torch.mean((cleaned_mag - clean_mag) ** 2) + (
        100.0 - snr.mean())
    return loss, snr.mean(), cleaned_mag


def ndns_loss_from_mask(mask, noisy_mag, noisy_phase, clean_mag,
                        clean_audio
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Frequency-major form: mask and spectra (B, F, L). Returns (loss,
    mean SI-SNR, cleaned magnitude (B, F, L))."""
    t = lambda a: a.transpose(-1, -2)  # noqa: E731
    loss, snr, cleaned_mag = ndns_loss_from_mask_tm(
        t(mask), t(noisy_mag), t(noisy_phase), t(clean_mag), clean_audio)
    return loss, snr, t(cleaned_mag)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor
                       ) -> torch.Tensor:
    """Mean negative log-likelihood of integer ``labels`` (B,) under
    log-probabilities ``logits`` (B, C)."""
    one_hot = torch.nn.functional.one_hot(labels.long(), logits.shape[-1])
    return -torch.mean(torch.sum(one_hot.to(logits.dtype) * logits, dim=-1))


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Share of rows whose largest log-probability is the label's."""
    return torch.mean((logits.argmax(dim=-1) == labels).to(torch.float32))
