"""The rest of the port's run surface against the JAX package's, on the
CPU: the WAV reader and the native decoder on files the test writes (bit
for bit), ``create_ndns_dataset`` over an N-DNS-layout corpus, DNSMOS with
a mock session, ``utils/logging`` (eigenvalue logs 1e-6 relative,
activation-sparsity fractions, JSONL records and gradient norms equal),
``tune`` picking JAX's trials from the same seed, the configuration
fields and flags, the FFT oracles of ``ops/stft.py`` (1e-5 of max|ref|),
and ``cli.py train`` on a classification dataset."""

import json
import os
import wave

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sparsernns_tpu.cli import build_parser as jax_parser
from sparsernns_tpu.data import dnsmos as jdnsmos
from sparsernns_tpu.data import native as jnative
from sparsernns_tpu.data import ndns as jndns
from sparsernns_tpu.ops import stft as jstft
from sparsernns_tpu.train import loop as jloop
from sparsernns_tpu.train import tune as jtune
from sparsernns_tpu.train.state import TrainState as JaxTrainState
from sparsernns_tpu.utils import logging as jlog
from sparsernns_tpu.utils.config import RunConfig as JaxConfig
from sparsernns_tpu.utils.config import \
    config_from_args as jax_config_from_args
from sparsernns_tpu_torch import cli
from sparsernns_tpu_torch.data import dnsmos, native, ndns
from sparsernns_tpu_torch.ops import stft
from sparsernns_tpu_torch.train import loop
from sparsernns_tpu_torch.train import tune
from sparsernns_tpu_torch.utils import logging as tlog
from sparsernns_tpu_torch.utils.config import RunConfig, config_from_args
from sparsernns_tpu_torch.weights import grads_to_flax, to_flax
from tests.test_torch_train import D_IO, paired, small_config


def write_wav(path, samples, rate=16000, width=2, channels=1):
    """PCM samples (frames, channels) of the given width to ``path``."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    dtype = {1: np.uint8, 2: "<i2", 4: "<i4"}[width]
    with wave.open(path, "wb") as f:
        f.setnchannels(channels)
        f.setsampwidth(width)
        f.setframerate(rate)
        f.writeframes(np.asarray(samples).astype(dtype).tobytes())


def pcm16(rng, n, channels=1):
    return rng.randint(-32768, 32768, (n, channels))


def test_read_wav_equals_jax(tmp_path):
    """Every sample width and a stereo file, bit for bit; a wrong sample
    rate raises in both."""
    rng = np.random.RandomState(0)
    cases = {
        "pcm16.wav": (pcm16(rng, 1000), 2, 1),
        "stereo.wav": (pcm16(rng, 600, 2), 2, 2),
        "pcm8.wav": (rng.randint(0, 256, (500, 1)), 1, 1),
        "pcm32.wav": (rng.randint(-2 ** 31, 2 ** 31, (400, 1)), 4, 1),
    }
    for name, (data, width, ch) in cases.items():
        path = str(tmp_path / name)
        write_wav(path, data, width=width, channels=ch)
        ours, theirs = ndns.read_wav(path), jndns.read_wav(path)
        assert ours.dtype == np.float32
        np.testing.assert_array_equal(ours, theirs)
    path = str(tmp_path / "8k.wav")
    write_wav(path, pcm16(rng, 100), rate=8000)
    for mod in (ndns, jndns):
        with pytest.raises(ValueError, match="sample rate"):
            mod.read_wav(path)
        assert mod.read_wav(path, expected_rate=None).shape == (100,)
    for n in (50, 100, 150):
        a = np.arange(n, dtype=np.float32)
        np.testing.assert_array_equal(ndns._pad_or_trim(a, 100),
                                      jndns._pad_or_trim(a, 100))


def test_native_decoder_equals_wave_reader_and_jax(tmp_path):
    """The port's decoder (built with g++ into the build directory) gives
    the ``wave`` reader's mono PCM16 samples bit for bit, padded or
    trimmed, and the JAX package's decoder's on every file, stereo too."""
    assert native.available(), "g++ builds the decoder here"
    assert native.lib_path().startswith(native.BUILD_DIR)
    rng = np.random.RandomState(1)
    mono, stereo = [], []
    for i, n in enumerate((700, 1000, 1300)):
        path = str(tmp_path / f"m{i}.wav")
        write_wav(path, pcm16(rng, n))
        mono.append(path)
        path = str(tmp_path / f"s{i}.wav")
        write_wav(path, pcm16(rng, n, 2), channels=2)
        stereo.append(path)
    batch = native.decode_batch(mono, 1000)
    for row, path in zip(batch, mono):
        np.testing.assert_array_equal(
            row, ndns._pad_or_trim(ndns.read_wav(path), 1000))
    one, got = native.decode_wav(mono[0], 1000)
    assert got == 700
    np.testing.assert_array_equal(one, batch[0])
    if jnative.available():
        for paths in (mono, stereo):
            np.testing.assert_array_equal(native.decode_batch(paths, 900),
                                          jnative.decode_batch(paths, 900))
    bad = str(tmp_path / "bad.wav")
    write_wav(bad, rng.randint(0, 256, (10, 1)), width=1)
    with pytest.raises(IOError):
        native.decode_batch([bad], 10)


def write_corpus(root, pairs, seconds, rng):
    """An N-DNS-layout directory: noisy/<...>_fileid_<i>.wav paired with
    clean/clean_fileid_<i>.wav, PCM16 at 16 kHz."""
    n = int(seconds * 16000)
    for i in range(pairs):
        clean = (0.3 * 32767 * np.sin(np.arange(n) * (0.01 + 0.001 * i)))
        noisy = clean + rng.randint(-2000, 2000, n)
        write_wav(os.path.join(root, "noisy", "sub",
                               f"book_{i:03d}_fileid_{i}.wav"),
                  np.clip(noisy, -32768, 32767)[:, None])
        write_wav(os.path.join(root, "clean", f"clean_fileid_{i}.wav"),
                  clean[:, None])


def test_ndns_corpus_dataset_equals_jax(tmp_path, monkeypatch):
    """``create_ndns_dataset`` over the corpus of the three
    ``NDNS_*_SET`` directories (``synthetic=None``): the pairs, the
    shuffled batches of two epochs, the 30 s clip length and 3751 frames,
    equal to the JAX package's loader's; ``build_dataset`` picks the
    corpus up with ``synthetic_data`` false."""
    rng = np.random.RandomState(2)
    for split, pairs in (("TRAIN", 4), ("VALIDATION", 2), ("TEST", 2)):
        root = str(tmp_path / split.lower())
        write_corpus(root, pairs, 0.25, rng)
        monkeypatch.setenv(f"NDNS_{split}_SET", root)
    ours = ndns.create_ndns_dataset(2, seed=3)
    theirs = jndns.create_ndns_dataset(2, seed=3)
    assert ours[3:] == theirs[3:] == (257, 3751, 257, 4)
    ds = ours[0].dataset
    assert isinstance(ds, ndns.DNSAudioDataset) and len(ds) == 4
    assert ds.batch_paths([1])[1][0].endswith("clean_fileid_1.wav")
    for i in range(len(ds)):
        for a, b in zip(ds[i], theirs[0].dataset[i]):
            np.testing.assert_array_equal(a, b)
    for lo, lt in zip(ours[:3], theirs[:3]):
        for _ in range(2):
            for (no, co), (nt, ct) in zip(lo, lt):
                assert no.shape == (2, ndns.AUDIO_LEN)
                np.testing.assert_array_equal(no, nt)
                np.testing.assert_array_equal(co, ct)
    cfg = small_config(synthetic_data=False)
    assert loop.build_dataset(cfg)[4] == jloop.build_dataset(cfg)[4] == 3751
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    with pytest.raises(FileNotFoundError):
        ndns.DNSAudioDataset(empty)


class MockSession:
    """onnxruntime's ``run(None, feeds)`` contract: raw scores from the
    window's statistics."""

    def __init__(self):
        self.calls = []

    def run(self, _, feeds):
        seg = feeds["input_1"]
        self.calls.append(seg.shape)
        m = float(np.abs(seg).mean())
        return [np.array([[2.0 + m, 3.0 - m, 2.5 + 0.5 * m]], np.float32)]


@pytest.mark.parametrize("seconds", [4.0, 9.01, 12.5])
def test_dnsmos_with_mock_session_equals_jax(seconds):
    audio = np.random.RandomState(4).randn(int(seconds * 16000)) * 0.1
    ours_s, theirs_s = MockSession(), MockSession()
    ours = dnsmos.DNSMOS(session=ours_s)(audio)
    theirs = jdnsmos.DNSMOS(session=theirs_s)(audio)
    assert ours == theirs and ours_s.calls == theirs_s.calls
    assert all(v is not None for v in ours.values())
    for raw in ((1.0, 2.0, 3.0), (np.arange(3.0),) * 3):
        for o, t in zip(dnsmos.DNSMOS._poly_fit(*raw),
                        jdnsmos.DNSMOS._poly_fit(*raw)):
            np.testing.assert_array_equal(o, t)
    none = dnsmos.DNSMOS(model_path="/nonexistent/sig_bak_ovr.onnx")
    assert not none.available
    assert none(audio) == {"OVRL": None, "SIG": None, "BAK": None}


def test_eigenvalue_logs_and_gradient_norms_equal_jax():
    cfg = small_config()
    _, variables, tm = paired(cfg, seed=5)
    ours = tlog.compute_eigenvalue_logs(tm)
    theirs = jlog.compute_eigenvalue_logs(variables["params"])
    assert set(ours) == set(theirs) and len(ours) == 4 * cfg.n_layers
    for key, val in theirs.items():
        assert ours[key] == pytest.approx(val, rel=1e-6), key
    assert tlog.compute_eigenvalue_logs(to_flax(tm)[0]) == ours
    tm(torch.randn(2, 12, D_IO)).pow(2).mean().backward()
    grads = grads_to_flax(tm)
    ours = tlog.gradient_norms(grads)
    theirs = jlog.gradient_norms(jax.tree_util.tree_map(jnp.asarray, grads))
    assert set(ours) == set(theirs) == {"grad_norm", "grad_norm/encoder",
                                        "grad_norm/decoder"}
    for key, val in theirs.items():
        assert ours[key] == pytest.approx(val, rel=1e-6), key


def test_activation_sparsity_equals_jax():
    """The per-epoch capture (``act_sparsity_metrics``) of a relufied
    model, eval mode, on the same batch: every activation the port
    captures has JAX's name and JAX's share of zeros. The port records no
    BatchNorm or dropout call (computed inline; ``ROADMAP.md``, recorded
    differences), so the mean covers the shared keys."""
    cfg = small_config(relufication=True, p_dropout=0.0, block_t=16)
    _, variables, tm = paired(cfg, seed=6)
    jm = jloop.build_model(cfg, D_IO, D_IO, training=False)
    state = JaxTrainState.create(apply_fn=jm.apply,
                                 params=variables["params"],
                                 tx=optax.sgd(0.0),
                                 batch_stats=variables["batch_stats"])
    x = np.random.RandomState(7).randn(2, 16, D_IO).astype(np.float32)
    theirs = jloop.act_sparsity_metrics(jm, state, jnp.asarray(x), "act")
    ours = loop.act_sparsity_metrics(tm, torch.from_numpy(x), "act")
    shared = set(ours) & set(theirs) - {"act/mean"}
    assert set(ours) - {"act/mean"} <= set(theirs)
    missing = set(theirs) - set(ours)
    assert missing and all("/norm/" in k or "/drop/" in k for k in missing)
    assert len(shared) == len(theirs) - 1 - len(missing)
    for key in shared:
        assert ours[key] == pytest.approx(theirs[key], abs=1e-6), key
    assert any(ours[k] > 0.2 for k in shared)         # relu zeros
    assert ours["act/mean"] == pytest.approx(
        np.mean([ours[k] for k in shared]))
    assert tm.training


def test_jsonl_and_wandb_sinks_equal_jax(tmp_path, caplog):
    metrics = [{"loss": np.float32(1.5), "acc": 0.25, "tag": "x"},
               {"loss": torch.tensor(0.75), "acc": 0.5, "tag": "y"}]
    for kind, mod in (("port", tlog), ("jax", jlog)):
        sink = mod.make_sink("jsonl", directory=str(tmp_path / kind))
        for step, m in enumerate(metrics):
            sink.log({k: (float(v) if kind == "jax" and
                          isinstance(v, torch.Tensor) else v)
                      for k, v in m.items()}, step=step)
        sink.log_best({"best_val_loss": 0.75})
        sink.finish()
    records = {}
    for kind in ("port", "jax"):
        with open(tmp_path / kind / "metrics.jsonl") as f:
            records[kind] = [{k: v for k, v in json.loads(line).items()
                              if k != "_time"} for line in f]
        with open(tmp_path / kind / "best.json") as f:
            records[kind + "_best"] = json.load(f)
    assert records["port"] == records["jax"]
    assert records["port_best"] == records["jax_best"]
    assert records["port"][1] == {"_step": 1, "loss": 0.75, "acc": 0.5,
                                  "tag": "y"}
    # wandb is not installed: a warning, and a sink that drops everything
    sink = tlog.make_sink("wandb", project="p", name="n")
    assert isinstance(sink, tlog.WandbSink) and sink.run_id is None
    sink.log({"a": 1.0})
    sink.finish()
    assert "wandb unavailable" in caplog.text
    assert isinstance(tlog.make_sink("none"), tlog.NullSink)


def test_tune_picks_jax_trials(tmp_path):
    """The same seed samples the same configurations, and the records,
    the best trial and ``tune_results.json`` agree."""
    def fake_train(cfg):
        loss = cfg.ssm_lr_base * 1e3 + cfg.p_dropout + cfg.weight_decay
        return {"metadata": {"best_val_loss": loss,
                             "best_si_snr": -loss}}

    base = small_config(checkpoint_dir=str(tmp_path / "port"))
    jbase = JaxConfig(checkpoint_dir=str(tmp_path / "jax"))
    ours = tune.tune(base, n_trials=5, train_fn=fake_train, seed=11)
    theirs = jtune.tune(jbase, n_trials=5, train_fn=fake_train, seed=11)
    assert ours == theirs
    for kind in ("port", "jax"):
        with open(tmp_path / kind / "tune_results.json") as f:
            assert json.load(f) == json.loads(json.dumps(ours,
                                                         default=float))
    rng_o, rng_t = np.random.RandomState(3), np.random.RandomState(3)
    for _ in range(3):
        assert tune.sample_config(base, tune.DEFAULT_SPACE, rng_o).lr == \
            jtune.sample_config(jbase, jtune.DEFAULT_SPACE, rng_t).lr


def test_config_fields_recipes_and_flags_equal_jax(tmp_path):
    """A recipe written for the JAX package, with every field the port
    lacked before, loads in the port and equals JAX's; the new flags
    parse to equal configurations."""
    recipe = {"run_name": "r", "wandb_project": "w",
              "log_act_sparsity": "both", "grad_norm_warn_threshold": 3.0,
              "profile": True, "profile_dir": "p", "dir_name": "d",
              "mode": "last", "activation_fn": "full_glu",
              "batchnorm_use_bias": False, "batchnorm_use_scale": False,
              "fuse_batchnorm_linear": True, "jax_seed": 5, "data_seed": 9,
              "dataset": "smnist", "scan_mode": "blocked"}
    path = tmp_path / "recipe.json"
    path.write_text(json.dumps(recipe))
    ours = RunConfig().with_recipe(str(path))
    theirs = JaxConfig().with_recipe(str(path))
    for key in recipe:
        assert getattr(ours, key) == getattr(theirs, key) == recipe[key]
    argv = ["train", "--dataset", "synthetic-classification", "--mode",
            "last", "--jax_seed", "4", "--data_seed", "6",
            "--log_act_sparsity", "val", "--batchnorm_use_scale", "false",
            "--fuse_batchnorm_linear", "true", "--profile", "1",
            "--grad_norm_warn_threshold", "7.5", "--run_name", "x"]
    a = config_from_args(cli.build_parser().parse_args(argv))
    b = jax_config_from_args(jax_parser().parse_args(argv))
    for key in b.to_dict():
        assert getattr(a, key) == getattr(b, key), key


@pytest.mark.parametrize("t", [4096, 5000, 700])
def test_fft_oracles_match_jax_and_the_matmul_forms(t):
    """``stft_splitter_fft`` / ``stft_mixer_fft`` against JAX's at 1e-5
    of max|ref| (the phase weighted by the magnitude), and against the
    port's matmul forms."""
    audio = np.random.RandomState(t).randn(2, t).astype(np.float32)
    mag, phase = stft.stft_splitter_fft(torch.from_numpy(audio))
    jmag, jphase = jstft.stft_splitter_fft(jnp.asarray(audio))
    jmag, jphase = np.asarray(jmag), np.asarray(jphase)
    scale = np.abs(jmag).max()
    assert mag.shape == jmag.shape
    assert np.abs(mag.numpy() - jmag).max() <= 1e-5 * scale
    dphase = np.angle(np.exp(1j * (phase.numpy() - jphase)))
    assert np.abs(dphase * jmag).max() <= 1e-5 * scale
    m2, p2 = stft.stft_splitter(torch.from_numpy(audio))
    assert np.abs(m2.numpy() - mag.numpy()).max() <= 1e-5 * scale
    out = stft.stft_mixer_fft(mag, phase).numpy()
    ref = np.asarray(jstft.stft_mixer_fft(jnp.asarray(jmag),
                                          jnp.asarray(jphase)))
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()
    back = stft.stft_mixer(mag, phase).numpy()
    assert np.abs(back - out).max() <= 1e-5 * np.abs(ref).max()
    np.testing.assert_allclose(out[:, :t], audio, atol=1e-5)


def test_cli_train_on_synthetic_classification(tmp_path):
    """``cli.py train`` on the classification registry, on the CPU: one
    epoch, a checkpoint, the JSONL epoch log with accuracy and the
    eigenvalue logs."""
    ckpt = tmp_path / "run"
    recipe = tmp_path / "r.json"
    recipe.write_text(json.dumps({
        "dataset": "synthetic-classification", "n_layers": 1, "d_model": 8,
        "ssm_size_base": 8, "blocks": 1, "bsz": 4, "synthetic_size": 8,
        "epochs": 1, "p_dropout": 0.0, "scan_mode": "fused",
        "log_act_sparsity": "val"}))
    assert cli.main(["train", "--recipe", str(recipe), "--device", "cpu",
                     "--checkpoint_dir", str(ckpt)]) == 0
    with open(ckpt / "metrics.jsonl") as f:
        rec = json.loads(f.readline())
    for key in ("train_loss", "train_acc", "val_accuracy", "test_accuracy",
                "encoder/layers_0/mixer/eig_mag_max", "act_sparsity_val/mean"):
        assert key in rec, key
    assert os.path.exists(ckpt / "best.json")
