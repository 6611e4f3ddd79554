"""NDNS synthetic data and batch loader (numpy; counterpart of
``sparsernns_tpu/data/ndns.py``). Only the synthetic set is ported; the
WAV-corpus reader and the native decoder wait for a later slice."""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np

SAMPLE_RATE = 16000
AUDIO_SECONDS = 30
AUDIO_LEN = SAMPLE_RATE * AUDIO_SECONDS
N_CLASSES = 257  # output frequency bins
SEQ_LENGTH = 3751  # STFT frames of a 30 s clip at nfft 512, hop 128
IN_DIM = 257


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
    Yields (noisy, clean) float32 arrays of shape (B, T)."""

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

        def produce():
            try:
                for b in range(n_batches):
                    batch_idx = indices[b * self.batch_size:
                                        (b + 1) * self.batch_size]
                    noisy = np.empty((len(batch_idx), length), np.float32)
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
                        synthetic: Optional[bool] = True,
                        synthetic_size: int = 64,
                        synthetic_length: int = AUDIO_LEN,
                        num_shards: int = 1, shard_index: int = 0):
    """(train, val, test) loaders + task constants: (trainloader,
    valloader, testloader, n_classes, seq_len, in_dim, train_size)."""
    if synthetic is False:
        raise NotImplementedError(
            "the WAV-corpus reader is not ported yet: synthetic data only")
    # keep synthetic audio hop-aligned so STFT -> iSTFT round-trips exactly
    synthetic_length = max(512, (synthetic_length // 512) * 512)
    eval_size = max(synthetic_size // 4, batch_size * num_shards)
    sets = {
        "TRAIN": SyntheticNDNS(synthetic_size, synthetic_length, seed),
        "VALIDATION": SyntheticNDNS(eval_size, synthetic_length, seed + 1),
        "TEST": SyntheticNDNS(eval_size, synthetic_length, seed + 2),
    }
    mk = lambda ds, shuf: NDNSLoader(  # noqa: E731
        ds, batch_size, shuffle=shuf, seed=seed,
        num_shards=num_shards, shard_index=shard_index)
    seq_len = synthetic_length // 128 + 1
    return (mk(sets["TRAIN"], True), mk(sets["VALIDATION"], False),
            mk(sets["TEST"], False), N_CLASSES, seq_len, IN_DIM,
            len(sets["TRAIN"]))
