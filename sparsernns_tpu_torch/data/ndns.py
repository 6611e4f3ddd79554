"""NDNS (Intel N-DNS audio denoising) input pipeline, numpy on the host
(counterpart of ``sparsernns_tpu/data/ndns.py``): the WAV corpus of the
reference's layout (``<root>/noisy/**.wav`` paired with
``<root>/clean/clean_fileid_<id>.wav``, 30 s at 16 kHz, padded or
trimmed), read by the native decoder (``data/native.py``) or, where it
cannot be built, the ``wave`` module; a synthetic set with the same
shapes; and the batch loader with shuffling, sharding and a background
prefetch thread. ``create_ndns_dataset`` takes the corpus where
``NDNS_TRAIN_SET``, ``NDNS_VALIDATION_SET`` and ``NDNS_TEST_SET`` are all
set (or ``synthetic=False``) and the synthetic set otherwise."""

from __future__ import annotations

import glob
import os
import queue
import re
import threading
import wave
from typing import Iterator, Optional, Tuple

import numpy as np

SAMPLE_RATE = 16000
AUDIO_SECONDS = 30
AUDIO_LEN = SAMPLE_RATE * AUDIO_SECONDS
N_CLASSES = 257  # output frequency bins
SEQ_LENGTH = 3751  # STFT frames of a 30 s clip at nfft 512, hop 128
IN_DIM = 257

_FILE_ID_RE = re.compile(r"fileid_(\d+)")


def read_wav(path: str, expected_rate: int = SAMPLE_RATE) -> np.ndarray:
    """PCM WAV (8-, 16- or 32-bit, channels averaged) -> float32 in
    [-1, 1]. A sample rate other than ``expected_rate`` raises (None:
    any rate)."""
    with wave.open(path, "rb") as f:
        n = f.getnframes()
        width = f.getsampwidth()
        rate = f.getframerate()
        raw = f.readframes(n)
        channels = f.getnchannels()
    if expected_rate and rate != expected_rate:
        raise ValueError(
            f"{path}: sample rate {rate} Hz != expected "
            f"{expected_rate} Hz (NDNS audio is 16 kHz; resample the "
            "corpus or pass expected_rate=None to override)")
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = (np.frombuffer(raw, dtype="<i4").astype(np.float32)
                / 2147483648.0)
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
                - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width {width} in {path}")
    if channels > 1:
        data = data.reshape(-1, channels).mean(axis=1)
    return data


def _pad_or_trim(audio: np.ndarray, length: int = AUDIO_LEN) -> np.ndarray:
    if audio.shape[0] >= length:
        return audio[:length]
    return np.pad(audio, (0, length - audio.shape[0]))


class DNSAudioDataset:
    """Paired (noisy, clean) clips of an N-DNS directory: every
    ``<root>/noisy/**.wav`` (sorted) with its
    ``<root>/clean/clean_fileid_<id>.wav``, each padded or trimmed to
    ``length`` samples."""

    def __init__(self, root: str, length: int = AUDIO_LEN):
        self.root = root
        self.length = length
        self.noisy_files = sorted(
            glob.glob(os.path.join(root, "noisy", "**", "*.wav"),
                      recursive=True))
        if not self.noisy_files:
            raise FileNotFoundError(f"no wav files under {root}/noisy")

    def __len__(self) -> int:
        return len(self.noisy_files)

    def _clean_path(self, noisy_path: str) -> str:
        m = _FILE_ID_RE.search(os.path.basename(noisy_path))
        if not m:
            raise ValueError(f"cannot parse fileid from {noisy_path}")
        return os.path.join(self.root, "clean",
                            f"clean_fileid_{m.group(1)}.wav")

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        noisy = _pad_or_trim(read_wav(self.noisy_files[idx]), self.length)
        clean = _pad_or_trim(read_wav(self._clean_path(
            self.noisy_files[idx])), self.length)
        return noisy, clean

    def batch_paths(self, indices) -> Tuple[list, list]:
        """(noisy paths, clean paths) for the native batch decoder."""
        noisy = [self.noisy_files[int(i)] for i in indices]
        return noisy, [self._clean_path(p) for p in noisy]


class SyntheticNDNS:
    """Deterministic synthetic denoising pairs with the NDNS shapes: clean
    is a sparse mixture of amplitude-modulated sinusoids, noisy adds
    coloured noise at a per-clip SNR in [0, 10] dB. Reproducible from
    (seed, idx) and equal to the JAX package's draw."""

    def __init__(self, size: int = 64, length: int = AUDIO_LEN,
                 seed: int = 42):
        self.size = size
        self.length = length
        self.seed = seed

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        rng = np.random.RandomState((self.seed * 1_000_003 + idx) % 2**31)
        t = np.arange(self.length, dtype=np.float32) / SAMPLE_RATE
        clean = np.zeros(self.length, dtype=np.float32)
        for _ in range(4):
            f0 = rng.uniform(80, 1200)
            amp = rng.uniform(0.05, 0.3)
            mod = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(0.3, 3.0) * t
                                    + rng.uniform(0, 6.28)))
            clean += (amp * mod * np.sin(2 * np.pi * f0 * t
                                         + rng.uniform(0, 6.28))
                      ).astype(np.float32)
        noise = rng.randn(self.length).astype(np.float32)
        alpha = rng.uniform(0.6, 0.95)  # one-pole lowpass colouring
        noise = np.asarray(
            np.concatenate([[noise[0]],
                            alpha * noise[:-1] + (1 - alpha) * noise[1:]]),
            dtype=np.float32)
        snr_db = rng.uniform(0.0, 10.0)
        p_clean = np.mean(clean ** 2) + 1e-9
        p_noise = np.mean(noise ** 2) + 1e-9
        noise *= np.sqrt(p_clean / (p_noise * 10 ** (snr_db / 10)))
        return clean + noise, clean


class NDNSLoader:
    """Batched iterator with shuffling, sharding and background prefetch.
    Yields (noisy, clean) float32 arrays of shape (B, T). A dataset with
    ``batch_paths`` (the WAV corpus) is decoded by the native decoder
    where it is available, else item by item."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = True,
                 num_shards: int = 1, shard_index: int = 0,
                 prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.prefetch = prefetch
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset) // self.num_shards
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        return idx[self.shard_index::self.num_shards]

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        indices = self._indices()
        self.epoch += 1
        n_batches = len(self)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        length = getattr(self.dataset, "length", AUDIO_LEN)
        use_native = False
        if hasattr(self.dataset, "batch_paths"):
            from sparsernns_tpu_torch.data import native
            use_native = native.available()

        def produce():
            try:
                for b in range(n_batches):
                    batch_idx = indices[b * self.batch_size:
                                        (b + 1) * self.batch_size]
                    if use_native:
                        noisy_paths, clean_paths = self.dataset.batch_paths(
                            batch_idx)
                        noisy = native.decode_batch(noisy_paths, length)
                        clean = native.decode_batch(clean_paths, length)
                    else:
                        noisy = np.empty((len(batch_idx), length),
                                         np.float32)
                        clean = np.empty_like(noisy)
                        for i, j in enumerate(batch_idx):
                            noisy[i], clean[i] = self.dataset[int(j)]
                    q.put((noisy, clean))
                q.put(None)
            except BaseException as e:  # surface errors to the consumer
                q.put(e)

        threading.Thread(target=produce, daemon=True).start()
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            yield item


def create_ndns_dataset(batch_size: int, seed: int = 0,
                        synthetic: Optional[bool] = None,
                        synthetic_size: int = 64,
                        synthetic_length: int = AUDIO_LEN,
                        num_shards: int = 1, shard_index: int = 0):
    """(train, val, test) loaders + task constants: (trainloader,
    valloader, testloader, n_classes, seq_len, in_dim, train_size).

    The WAV corpus under ``NDNS_{TRAIN,VALIDATION,TEST}_SET`` when
    ``synthetic`` is False, or None and all three are set (30 s clips,
    3751 frames); the synthetic set otherwise."""
    # keep synthetic audio hop-aligned so STFT -> iSTFT round-trips exactly
    synthetic_length = max(512, (synthetic_length // 512) * 512)
    roots = {k: os.environ.get(f"NDNS_{k}_SET")
             for k in ("TRAIN", "VALIDATION", "TEST")}
    use_real = synthetic is False or (
        synthetic is None and all(roots.values()))
    if use_real:
        unset = [f"NDNS_{k}_SET" for k, v in roots.items() if not v]
        if unset:
            raise FileNotFoundError(
                f"synthetic=False reads the WAV corpus: set {unset}")
        sets = {k: DNSAudioDataset(v) for k, v in roots.items()}
    else:
        eval_size = max(synthetic_size // 4, batch_size * num_shards)
        sets = {
            "TRAIN": SyntheticNDNS(synthetic_size, synthetic_length, seed),
            "VALIDATION": SyntheticNDNS(eval_size, synthetic_length,
                                        seed + 1),
            "TEST": SyntheticNDNS(eval_size, synthetic_length, seed + 2),
        }
    mk = lambda ds, shuf: NDNSLoader(  # noqa: E731
        ds, batch_size, shuffle=shuf, seed=seed,
        num_shards=num_shards, shard_index=shard_index)
    # STFT framing: n_frames = T // hop + 1 (3751 for 30 s clips)
    seq_len = SEQ_LENGTH if use_real else synthetic_length // 128 + 1
    return (mk(sets["TRAIN"], True), mk(sets["VALIDATION"], False),
            mk(sets["TEST"], False), N_CLASSES, seq_len, IN_DIM,
            len(sets["TRAIN"]))
