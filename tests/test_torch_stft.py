"""The port's STFT / iSTFT, SI-SNR, NDNS loss and synthetic data against
the JAX package's, on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsernns_tpu.data.ndns import SyntheticNDNS as JaxSyntheticNDNS
from sparsernns_tpu.ops import stft as jstft
from sparsernns_tpu.train import losses as jlosses
from sparsernns_tpu_torch.data.ndns import (NDNSLoader, SyntheticNDNS,
                                            create_ndns_dataset)
from sparsernns_tpu_torch.ops import stft as tstft
from sparsernns_tpu_torch.train import losses as tlosses


@pytest.mark.parametrize("length", [4096, 5000])
def test_stft_splitter_matches_jax(length):
    audio = np.random.RandomState(length).randn(2, length).astype(
        np.float32)
    ref_mag, ref_ph = jstft.stft_splitter(jnp.asarray(audio))
    mag, ph = tstft.stft_splitter(torch.from_numpy(audio))
    assert mag.shape == ref_mag.shape
    assert mag.shape[:2] == (2, 257)
    np.testing.assert_allclose(mag.numpy(), np.asarray(ref_mag),
                               atol=2e-4, rtol=1e-5)
    # phase where the bin carries energy (atan2 is ill-posed near 0)
    live = np.asarray(ref_mag) > 1e-2
    dph = np.angle(np.exp(1j * (ph.numpy() - np.asarray(ref_ph))))
    assert np.abs(dph[live]).max() < 1e-3


@pytest.mark.parametrize("bins", [257, 129])
def test_stft_mixer_matches_jax(bins):
    rng = np.random.RandomState(bins)
    mag = np.abs(rng.randn(2, bins, 33)).astype(np.float32)
    ph = rng.uniform(-np.pi, np.pi, (2, bins, 33)).astype(np.float32)
    ref = np.asarray(jstft.stft_mixer(jnp.asarray(mag), jnp.asarray(ph)))
    out = tstft.stft_mixer(torch.from_numpy(mag), torch.from_numpy(ph))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)
    out_tm = tstft.stft_mixer_tm(torch.from_numpy(mag).transpose(1, 2),
                                 torch.from_numpy(ph).transpose(1, 2))
    torch.testing.assert_close(out_tm, out)


def test_stft_roundtrip():
    audio = np.random.RandomState(1).randn(1, 8192).astype(np.float32)
    mag, ph = tstft.stft_splitter(torch.from_numpy(audio))
    recon = tstft.stft_mixer(mag, ph)[:, :8192].numpy()
    np.testing.assert_allclose(recon, audio, atol=1e-4)


def test_si_snr_and_ndns_loss_match_jax():
    rng = np.random.RandomState(2)
    clean = rng.randn(2, 4096).astype(np.float32)
    est = (clean + 0.3 * rng.randn(2, 4096)).astype(np.float32)
    np.testing.assert_allclose(
        tlosses.si_snr(torch.from_numpy(clean), torch.from_numpy(est))
        .numpy(),
        np.asarray(jlosses.si_snr(jnp.asarray(clean), jnp.asarray(est))),
        atol=1e-4)
    nm, nph = jstft.stft_splitter(jnp.asarray(est))
    cm, _ = jstft.stft_splitter(jnp.asarray(clean))
    mask = (0.1 * rng.randn(*nm.shape)).astype(np.float32)
    ref = jlosses.ndns_loss_from_mask(jnp.asarray(mask), nm, nph, cm,
                                      jnp.asarray(clean))
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    out = tlosses.ndns_loss_from_mask(t(mask), t(nm), t(nph), t(cm),
                                      t(clean))
    np.testing.assert_allclose(out[0].item(), float(ref[0]), atol=1e-3)
    np.testing.assert_allclose(out[1].item(), float(ref[1]), atol=1e-3)
    np.testing.assert_allclose(out[2].numpy(), np.asarray(ref[2]),
                               atol=1e-4, rtol=1e-5)


def test_synthetic_ndns_equals_jax_draw():
    ours, ref = SyntheticNDNS(4, 4096, seed=3), JaxSyntheticNDNS(4, 4096, 3)
    for i in (0, 3):
        for a, b in zip(ours[i], ref[i]):
            np.testing.assert_array_equal(a, b)


def test_create_ndns_dataset_synthetic(monkeypatch):
    for split in ("TRAIN", "VALIDATION", "TEST"):
        monkeypatch.delenv(f"NDNS_{split}_SET", raising=False)
    train, val, test, n_cls, seq_len, in_dim, size = create_ndns_dataset(
        2, seed=0, synthetic=True, synthetic_size=4, synthetic_length=5000)
    assert (n_cls, in_dim, size, seq_len) == (257, 257, 4, 4608 // 128 + 1)
    batches = list(train)
    assert len(batches) == len(train) == 2
    noisy, clean = batches[0]
    assert noisy.shape == clean.shape == (2, 4608)
    assert isinstance(val, NDNSLoader) and len(test) == 1
    # the WAV corpus needs its three directories
    with pytest.raises(FileNotFoundError):
        create_ndns_dataset(2, synthetic=False)
