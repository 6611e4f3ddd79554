"""STFT / iSTFT for the NDNS audio-denoising task (counterpart of
``sparsernns_tpu/ops/stft.py``): nfft 512, hop 128, boxcar window,
one-sided, scipy's centred framing, torch-convention magnitudes.

Both directions are one matmul against a real DFT basis; the matmuls stay
``torch.matmul`` (the JAX package left them to XLA, outside any kernel).
:func:`stft_splitter_fft` and :func:`stft_mixer_fft` are the FFT forms
over ``torch.stft`` / ``torch.istft``, the semantics oracles of the two.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from sparsernns_tpu_torch.utils.trace import span

NFFT = 512
HOP_LENGTH = 128
N_FREQ = NFFT // 2 + 1  # = 257 = NDNS feature dim


@lru_cache(maxsize=4)
def _dft_matrix(nfft: int) -> np.ndarray:
    """(nfft, nfft+2) one-sided DFT basis: frames @ basis ==
    [Re rfft(frames) | Im rfft(frames)]."""
    f = nfft // 2 + 1
    n = np.arange(nfft)[:, None]
    k = np.arange(f)[None, :]
    ang = 2.0 * np.pi * n * k / nfft
    return np.concatenate([np.cos(ang), -np.sin(ang)],
                          axis=1).astype(np.float32)


@lru_cache(maxsize=4)
def _idft_matrix(nfft: int) -> np.ndarray:
    """(nfft+2, nfft) one-sided inverse-DFT basis (numpy irfft's
    convention: the k=0 and k=N/2 bins undoubled)."""
    f = nfft // 2 + 1
    k = np.arange(f)[:, None]
    n = np.arange(nfft)[None, :]
    ang = 2.0 * np.pi * k * n / nfft
    w = np.full((f, 1), 2.0)
    w[0, 0] = 1.0
    w[-1, 0] = 1.0
    return np.concatenate([w * np.cos(ang) / nfft, -w * np.sin(ang) / nfft],
                          axis=0).astype(np.float32)


@lru_cache(maxsize=8)
def _ola_norm(n_frames: int, nfft: int, hop: int) -> np.ndarray:
    """Boxcar overlap counts of the overlap-add output, trimmed by
    nfft//2 at both ends."""
    total = (n_frames - 1) * hop + nfft
    norm = np.zeros(total, np.float32)
    for start in range(0, total - nfft + 1, hop):
        norm[start:start + nfft] += 1.0
    return norm[nfft // 2: total - nfft // 2]


def _check_geometry(nfft: int, hop_length: int) -> None:
    if nfft % hop_length:
        raise NotImplementedError("nfft must be a multiple of hop_length")


def stft_splitter(audio: torch.Tensor, nfft: int = NFFT,
                  hop_length: int = HOP_LENGTH
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """audio (..., T) -> (magnitude, phase), each (..., nfft//2+1, frames).

    scipy's framing: nfft//2 zeros at both ends, then zero-extended so
    that (len - nfft) % hop == 0."""
    _check_geometry(nfft, hop_length)
    lead = audio.shape[:-1]
    ext = audio.shape[-1] + nfft
    nadd = (-(ext - nfft) % hop_length) % nfft
    ext += nadd
    n_frames = (ext - nfft) // hop_length + 1
    with span("stft.frames"):
        x = torch.nn.functional.pad(audio, (nfft // 2, nfft // 2 + nadd))
        strips = x.reshape(*lead, ext // hop_length, hop_length)
        frames = torch.cat([strips[..., j:j + n_frames, :]
                            for j in range(nfft // hop_length)], dim=-1)
    with span("stft.upload"):
        basis = torch.from_numpy(_dft_matrix(nfft)).to(audio.device)
    with span("stft.dft"):
        spec = frames @ basis                            # (..., L, nfft+2)
        f = nfft // 2 + 1
        re = spec[..., :f].transpose(-1, -2)
        im = spec[..., f:].transpose(-1, -2)
        return torch.sqrt(re * re + im * im), torch.atan2(im, re)


def stft_splitter_fft(audio: torch.Tensor, nfft: int = NFFT,
                      hop_length: int = HOP_LENGTH
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """audio (..., T) -> (magnitude, phase), each (..., nfft//2+1, frames),
    by ``torch.stft``: the FFT form of :func:`stft_splitter`, with the
    same framing (the audio zero-extended to a whole hop, nfft//2 zeros at
    both ends) and the torch.stft magnitude convention (the frame's raw
    rFFT, no 1/N window normalization), which the JAX package's oracle
    restores from scipy's."""
    lead = audio.shape[:-1]
    t = audio.shape[-1]
    nadd = (-t) % hop_length
    x = torch.nn.functional.pad(audio.reshape(-1, t), (0, nadd))
    spec = torch.stft(x, nfft, hop_length=hop_length, win_length=nfft,
                      window=torch.ones(nfft, device=audio.device,
                                        dtype=audio.dtype),
                      center=True, pad_mode="constant", onesided=True,
                      return_complex=True)
    spec = spec.reshape(*lead, *spec.shape[-2:])
    return spec.abs(), spec.angle()


def stft_mixer_fft(mag: torch.Tensor, phase: torch.Tensor, nfft: int = NFFT,
                   hop_length: int = HOP_LENGTH) -> torch.Tensor:
    """(magnitude, phase) (..., F, L) -> audio (..., T) by ``torch.istft``
    (boxcar window, overlap-added and divided by the window overlap): the
    FFT form of :func:`stft_mixer`."""
    lead = mag.shape[:-2]
    spec = torch.polar(mag, phase).reshape(-1, *mag.shape[-2:])
    audio = torch.istft(spec, nfft, hop_length=hop_length, win_length=nfft,
                        window=torch.ones(nfft, device=mag.device,
                                          dtype=mag.dtype),
                        center=True, onesided=True)
    return audio.reshape(*lead, audio.shape[-1])


def stft_mixer_tm(mag: torch.Tensor, phase: torch.Tensor, nfft: int = NFFT,
                  hop_length: int = HOP_LENGTH) -> torch.Tensor:
    """Time-major iSTFT: (..., L, F) magnitude/phase -> audio (..., T).

    Fewer than nfft//2+1 bins are a truncated spectrum (zero-padded up);
    more bins imply nfft = 2*(F-1)."""
    f_in = mag.shape[-1]
    if f_in > nfft // 2 + 1:
        nfft = 2 * (f_in - 1)
    _check_geometry(nfft, hop_length)
    if f_in < nfft // 2 + 1:
        pad = (0, nfft // 2 + 1 - f_in)
        mag = torch.nn.functional.pad(mag, pad)
        phase = torch.nn.functional.pad(phase, pad)
    n_frames = mag.shape[-2]
    lead = mag.shape[:-2]
    with span("istft.dft"):
        products = torch.cat([mag * torch.cos(phase),
                              mag * torch.sin(phase)], dim=-1)
        with span("istft.upload"):
            basis = torch.from_numpy(_idft_matrix(nfft)).to(mag.device)
        frames = products @ basis                        # (..., L, nfft)
    with span("istft.ola"):
        # overlap-add: frame l covers samples [l*hop, l*hop + nfft)
        total = (n_frames - 1) * hop_length + nfft
        flat = n_frames * hop_length
        x = frames.new_zeros(*lead, total)
        for j in range(nfft // hop_length):
            piece = frames[..., :, j * hop_length:(j + 1) * hop_length]
            x[..., j * hop_length:j * hop_length + flat] += piece.reshape(
                *lead, flat)
        with span("istft.norm_upload"):
            norm = torch.from_numpy(_ola_norm(n_frames, nfft, hop_length)
                                    ).to(mag.device)
        return x[..., nfft // 2: total - nfft // 2] / norm


def stft_mixer(mag: torch.Tensor, phase: torch.Tensor, nfft: int = NFFT,
               hop_length: int = HOP_LENGTH) -> torch.Tensor:
    """(magnitude, phase) (..., F, L) -> audio (..., T); inverse of
    :func:`stft_splitter`."""
    return stft_mixer_tm(mag.transpose(-1, -2), phase.transpose(-1, -2),
                         nfft=nfft, hop_length=hop_length)
