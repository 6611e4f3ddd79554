"""Plain PyTorch reference of the NDNS S5 denoiser (recipes/ndns.json).

Written from the published model (S5: Smith et al., arXiv:2208.04933; the
N-DNS recipe of arXiv:2502.01330), in float32 with TF32 off, with no kernel,
cache or fused route. It imports nothing of the measured program. Weights
arrive as a dict of tensors under the names the benchmark gives them
(``benchmark/tasks/ndns.py``).

The model, per clip of L frames of F = 257 magnitudes (time-major):

- encoder ``h = x W_e^T + b_e`` with ``x = |STFT| - 0.0007``;
- per layer: prenorm BatchNorm ``z = (h - mu) / sqrt(var + 1e-5) * w + b``
  (batch statistics over (B, L) in training, biased variance; running
  statistics in eval); the diagonal S5 mixer with zero-order hold
  ``lam_bar = exp(lam dt)``, ``B_bar = (lam_bar - 1) / lam * B``, the
  states ``x_t = lam_bar x_{t-1} + B_bar z_t`` and ``y = 2 Re(C x) + D z``
  (conjugate symmetry); ``x1 = gelu_tanh(y) * m1``; the GLU ``half1``
  gate ``g = x1 * sigmoid(x1 W_2^T + b_2) * m2``; residual ``h = g + h``;
- decoder ``mask = h W_d^T + b_d``;
- the loss: ``cleaned_mag = |noisy| (1 + mask)``, iSTFT with the noisy
  phase, ``loss = 1e-3 mean((cleaned_mag - |clean|)^2) + 100 - SI-SNR``,
  SI-SNR taken with the cleaned audio as target and the clean audio as the
  estimate, as the recipe's training code defines it.

``prec="tf32"`` rounds every matrix product's operands to TF32's 10-bit
mantissa (round to nearest even), on any device: the control of the
correctness check, the precision below the configuration's float32.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

NFFT = 512
HOP = 128
MAG_MEAN = 0.0007
LOSS_LAMBDA = 0.001
BN_EPS = 1e-5
SNR_EPS = 1e-8
#: frames per chunk of the reference's chunked scan
SCAN_CHUNK = 64

Weights = Dict[str, torch.Tensor]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits, round to nearest even)."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class _TF32Matmul(torch.autograd.Function):
    """``a @ b`` on TF32 operands, and its backward's products on TF32
    operands too, as a TF32 matrix unit computes both."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = tf32(a), tf32(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32(g)
        ga = (g @ b.transpose(-1, -2)).sum_to_size(a.shape)
        gb = (a.transpose(-1, -2) @ g).sum_to_size(b.shape)
        return ga, gb


def mm(a: torch.Tensor, b: torch.Tensor, prec: str = "fp32") -> torch.Tensor:
    if prec == "tf32":
        return _TF32Matmul.apply(a, b)
    return a @ b


# ------------------------------------------------------------------ STFT

def stft(audio: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T) -> magnitude, phase, each (B, L, F) time-major: boxcar
    window, nfft 512, hop 128, centred with zero padding."""
    t = audio.shape[-1]
    x = F.pad(audio, (0, (-t) % HOP))
    spec = torch.stft(x, NFFT, hop_length=HOP, win_length=NFFT,
                      window=torch.ones(NFFT, device=audio.device),
                      center=True, pad_mode="constant", onesided=True,
                      return_complex=True)
    spec = spec.transpose(-1, -2)
    return spec.abs(), spec.angle()


def istft(mag: torch.Tensor, phase: torch.Tensor, length: int
          ) -> torch.Tensor:
    """(B, L, F) magnitude and phase -> (B, length) audio: each frame's
    inverse real FFT, overlap-added with hop 128, divided by the boxcar
    window's overlap count, nfft/2 samples trimmed at both ends. The
    magnitude may be negative (a mask below -1): the spectrum is
    ``mag cos(phase) + i mag sin(phase)`` as written, which
    ``torch.polar``'s gradient does not follow there."""
    spec = torch.complex(mag * torch.cos(phase), mag * torch.sin(phase))
    frames = torch.fft.irfft(spec, n=NFFT, dim=-1)
    n = frames.shape[-2]
    total = (n - 1) * HOP + NFFT

    def ola(cols):
        return F.fold(cols, (1, total), (1, NFFT), stride=(1, HOP))[:, 0, 0]

    audio = ola(frames.transpose(-1, -2))
    count = ola(torch.ones((1, NFFT, n), device=mag.device))
    audio = (audio / count)[..., NFFT // 2: total - NFFT // 2]
    return audio[..., :length]


def si_snr(target: torch.Tensor, estimate: torch.Tensor) -> torch.Tensor:
    t = target - target.mean(-1, keepdim=True)
    e = estimate - estimate.mean(-1, keepdim=True)
    proj = (t * e).sum(-1, keepdim=True) * t / (t * t).sum(-1, keepdim=True)
    noise = e - proj
    ratio = (proj * proj).sum(-1) / ((noise * noise).sum(-1) + SNR_EPS)
    return 10.0 * torch.log10(ratio + SNR_EPS)


def ndns_loss(mask, noisy_mag, noisy_phase, clean_mag, clean):
    """(loss, mean SI-SNR, cleaned audio); spectra (B, L, F)."""
    cleaned_mag = noisy_mag * (1.0 + mask)
    cleaned = istft(cleaned_mag, noisy_phase, clean.shape[-1])
    snr = si_snr(cleaned, clean)
    loss = LOSS_LAMBDA * torch.mean((cleaned_mag - clean_mag) ** 2) + (
        100.0 - snr.mean())
    return loss, snr.mean(), cleaned


# ------------------------------------------------------------------ S5

def discretize(w: Weights, prefix: str):
    """(lam_bar re, im) (P,), (B_bar re, im) (P, H): zero-order hold of the
    clipped eigenvalues (real part at most -1e-4) in complex64."""
    lam = torch.complex(torch.clamp(w[prefix + "Lambda_re"], max=-1e-4),
                        w[prefix + "Lambda_im"])
    dt = torch.exp(w[prefix + "log_step"][:, 0])
    lam_bar = torch.exp(lam * dt)
    b = torch.complex(w[prefix + "B"][..., 0], w[prefix + "B"][..., 1])
    b_bar = ((lam_bar - 1.0) / lam)[:, None] * b
    return (lam_bar.real, lam_bar.imag), (b_bar.real, b_bar.imag)


def _powers(lr, li, n: int):
    """lam^k for k = 0..n, (n+1, P) re and im, from float64 polar form."""
    lam = torch.complex(lr.double(), li.double())
    k = torch.arange(n + 1, device=lr.device, dtype=torch.float64)
    pw = torch.exp(k[:, None] * torch.log(lam)[None, :])
    return pw.real.float(), pw.imag.float()


def scan(lam, bu, carry=None, prec: str = "fp32", chunk: int = SCAN_CHUNK):
    """States of ``x_t = lam x_{t-1} + bu_t`` from ``carry`` (default 0).
    lam: (P,) pair; bu: (B, L, P) pair. Within a chunk of ``chunk`` frames
    the states are one product with the (chunk, chunk) Toeplitz matrix of
    powers of lam; the chunks are chained by their last state. Returns
    the (B, L, P) pair."""
    br, bi = bu
    b, l, p = br.shape
    n = -(-l // chunk)
    pad = n * chunk - l
    pr, pi = _powers(lam[0], lam[1], chunk)
    j = torch.arange(chunk, device=br.device)
    lag = j[:, None] - j[None, :]
    tri = (lag >= 0)[..., None]
    lag = lag.clamp(min=0)
    mr = (pr[lag] * tri).permute(2, 0, 1)      # (P, T, T): lam^(j - i)
    mi = (pi[lag] * tri).permute(2, 0, 1)

    def blocks(a):   # (B, L, P) -> (P, T, B * n)
        a = F.pad(a, (0, 0, 0, pad)).reshape(b, n, chunk, p)
        return a.permute(3, 2, 0, 1).reshape(p, chunk, b * n)

    ur, ui = blocks(br), blocks(bi)
    xr = mm(mr, ur, prec) - mm(mi, ui, prec)
    xi = mm(mr, ui, prec) + mm(mi, ur, prec)
    xr = xr.reshape(p, chunk, b, n).permute(2, 3, 1, 0)   # (B, n, T, P)
    xi = xi.reshape(p, chunk, b, n).permute(2, 3, 1, 0)
    gr, gi = pr[1:], pi[1:]                               # lam^(j + 1)
    cr = (torch.zeros((b, p), device=br.device) if carry is None
          else carry[0])
    ci = (torch.zeros((b, p), device=br.device) if carry is None
          else carry[1])
    out_r, out_i = [], []
    for c in range(n):
        yr = xr[:, c] + gr * cr[:, None] - gi * ci[:, None]
        yi = xi[:, c] + gr * ci[:, None] + gi * cr[:, None]
        out_r.append(yr)
        out_i.append(yi)
        cr, ci = yr[:, -1], yi[:, -1]
    xr = torch.stack(out_r, 1).reshape(b, n * chunk, p)[:, :l]
    xi = torch.stack(out_i, 1).reshape(b, n * chunk, p)[:, :l]
    return xr, xi


# ------------------------------------------------------------------ model

def layer_prefixes(w: Weights) -> List[str]:
    n = 0
    while f"encoder.layers.{n}.mixer.B" in w:
        n += 1
    return [f"encoder.layers.{i}." for i in range(n)]


def dropout_masks(generators: Sequence[torch.Generator], batch_per: int,
                  h: int, n_layers: int, keep: float, device):
    """The two (B, 1, H) masks of each layer, 0 or 1/keep: per layer two
    uniform draws of (rows, 1, H) from each generator, the first after the
    activation, the second after the gate; generators in row order, one
    per ``batch_per`` rows. A training step draws them in layer order."""
    out = []
    for _ in range(n_layers):
        pair = []
        for _k in range(2):
            draws = [torch.rand((batch_per, 1, h), generator=g,
                                device=device) for g in generators]
            u = torch.cat(draws, 0)
            pair.append((u < keep).to(torch.float32) / keep)
        out.append(tuple(pair))
    return out


def forward(w: Weights, x: torch.Tensor, training: bool,
            masks=None, prec: str = "fp32",
            layer_stats: Optional[list] = None) -> torch.Tensor:
    """x (B, L, F) features -> mask (B, L, F). ``training``: BatchNorm on
    the batch statistics (which ``layer_stats``, a list, receives per
    layer as (mean, var)); ``masks``: per layer the two dropout masks or
    None."""
    h = mm(x, w["encoder.encoder.weight"].T, prec) + w["encoder.encoder.bias"]
    for i, pre in enumerate(layer_prefixes(w)):
        if training:
            mean = h.mean((0, 1))
            var = (h * h).mean((0, 1)) - mean * mean
            if layer_stats is not None:
                layer_stats.append((mean.detach(), var.detach()))
        else:
            mean = w[pre + "norm.running_mean"]
            var = w[pre + "norm.running_var"]
        z = (h - mean) * (w[pre + "norm.weight"] * torch.rsqrt(var + BN_EPS)) \
            + w[pre + "norm.bias"]
        lam, bbar = discretize(w, pre + "mixer.")
        w_b = torch.cat([bbar[0].T, bbar[1].T], dim=-1)          # (H, 2P)
        p = w_b.shape[-1] // 2
        bu = mm(z, w_b, prec)
        xs = scan(lam, (bu[..., :p], bu[..., p:]), prec=prec)
        c = w[pre + "mixer.C"]
        w_c = 2.0 * torch.cat([c[..., 0].T, -c[..., 1].T], dim=0)  # (2P, H)
        y = mm(torch.cat(xs, -1), w_c, prec) + w[pre + "mixer.D"] * z
        x1 = F.gelu(y, approximate="tanh")
        m1, m2 = (None, None) if masks is None else masks[i]
        if m1 is not None:
            x1 = x1 * m1
        gate = torch.sigmoid(mm(x1, w[pre + "out2.weight"].T, prec)
                             + w[pre + "out2.bias"])
        g = x1 * gate
        if m2 is not None:
            g = g * m2
        h = g + h
    return mm(h, w["decoder.weight"].T, prec) + w["decoder.bias"]


def features(audio: torch.Tensor):
    """(B, T) -> (model input (B, L, F), magnitude, phase)."""
    mag, phase = stft(audio)
    return mag - MAG_MEAN, mag, phase


@torch.no_grad()
def denoise(w: Weights, noisy: torch.Tensor, prec: str = "fp32"):
    """The offline request: (mask (B, L, F), cleaned audio (B, T)) of the
    eval-mode model."""
    x, mag, phase = features(noisy)
    mask = forward(w, x, training=False, prec=prec)
    return mask, istft(mag * (1.0 + mask), phase, noisy.shape[-1])


@torch.no_grad()
def running_stats(w: Weights, x: torch.Tensor) -> List[tuple]:
    """Per layer (mean, biased var) of the norm's input over (B, L) when
    every norm normalizes with those statistics: what BatchNorm's running
    statistics converge to on inputs like ``x``."""
    stats: list = []
    forward(w, x, training=True, layer_stats=stats)
    return stats

