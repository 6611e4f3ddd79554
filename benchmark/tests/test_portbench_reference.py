"""The plain reference against the program's plain paths at a tiny size on
the CPU, piece by piece, and the whole cells' checks."""

import pytest
import torch

from benchmark.reference import engine, ndns
from benchmark.tests.tiny import tiny_run


def _audio(b=3, t=3200, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((b, t), generator=g)


def test_stft_and_istft_agree_with_the_program():
    from sparsernns_tpu_torch.ops.stft import stft_mixer_tm, stft_splitter
    audio = _audio()
    mag, phase = ndns.stft(audio)
    pmag, pphase = stft_splitter(audio)
    assert torch.allclose(mag, pmag.transpose(1, 2), atol=1e-4)
    mask = torch.randn_like(mag)          # some magnitudes go negative
    back = ndns.istft(mag * (1 + mask), phase, audio.shape[-1])
    pback = stft_mixer_tm(mag * (1 + mask), phase)[..., :audio.shape[-1]]
    assert torch.allclose(back, pback, atol=1e-4)


def test_istft_gradient_matches_finite_differences():
    """Negative magnitudes included, where ``torch.polar``'s gradient
    would be wrong."""
    audio = _audio(1, 1280).double()
    spec = torch.stft(audio, 512, 128, window=torch.ones(512,
                                                          dtype=torch.float64),
                      return_complex=True).transpose(1, 2)
    mag = (spec.abs() * torch.linspace(-1, 1, spec.shape[-1],
                                       dtype=torch.float64)
           ).requires_grad_(True)
    phase = spec.angle()
    assert torch.autograd.gradcheck(
        lambda m: ndns.istft(m, phase, 1280).sum(), (mag,), eps=1e-6)


def test_scan_matches_the_sequential_recurrence():
    g = torch.Generator().manual_seed(1)
    lam = (0.9 + 0.09 * torch.rand(8, generator=g),
           0.1 * torch.randn(8, generator=g))
    bu = (torch.randn(2, 150, 8, generator=g), torch.randn(2, 150, 8,
                                                          generator=g))
    xr, xi = ndns.scan(lam, bu)
    cr, ci = torch.zeros(2, 8), torch.zeros(2, 8)
    for t in range(150):
        cr, ci = (lam[0] * cr - lam[1] * ci + bu[0][:, t],
                  lam[0] * ci + lam[1] * cr + bu[1][:, t])
        assert torch.allclose(xr[:, t], cr, atol=1e-4)
        assert torch.allclose(xi[:, t], ci, atol=1e-4)


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 1.0 + 2 ** -10])
    assert ndns.tf32(x).tolist() == [1.0, 1.0 + 2 ** -9, 1.0 + 2 ** -10]


def test_pow2_quantize_is_the_engines_rule():
    from sparsernns_tpu_torch.quantize.engine import pow2_quantize
    w = torch.randn(64, 32)
    q, s = engine.quantize(w, 8)
    pq, ps = pow2_quantize(w.numpy(), 8)
    assert s == ps and torch.equal(q, torch.from_numpy(pq).float())


@pytest.mark.parametrize("cell", ["float_train_b32", "float_denoise_b32",
                                  "w8a16_denoise_b32"])
def test_a_sound_run_is_correct(cell):
    out = tiny_run(cell)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["failed"] == 0 and out["attempted"] > 0
