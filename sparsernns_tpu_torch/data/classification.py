"""Sequence-classification datasets (counterpart of
``sparsernns_tpu/data/classification.py``, numpy only): a synthetic
separable task with the sMNIST shape contract, the batch loader (shards,
a seeded shuffle per epoch), and sequential MNIST read from the IDX files
(``SMNIST_DATA_DIR`` or an explicit ``data_dir``; ``.gz`` allowed), with
the bit-reversal permutation of psMNIST and a seeded 0.1 validation split
of the training set. The draws equal the JAX package's from the same
seeds.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Iterator, Optional, Tuple

import numpy as np


class SyntheticSequenceClassification:
    """Separable synthetic task: class k = noisy sum of k-specific
    sinusoid bank. Shapes match the sMNIST contract (L, d_input)."""

    def __init__(self, size: int = 128, seq_len: int = 128,
                 d_input: int = 1, n_classes: int = 4, seed: int = 0):
        self.size = size
        self.seq_len = seq_len
        self.d_input = d_input
        self.n_classes = n_classes
        self.seed = seed

    def __len__(self):
        return self.size

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, int]:
        rng = np.random.RandomState(self.seed * 99991 + idx)
        label = idx % self.n_classes
        t = np.linspace(0, 1, self.seq_len, dtype=np.float32)[:, None]
        freq = 2.0 + 3.0 * label
        x = np.sin(2 * np.pi * freq * t + rng.uniform(0, 6.28))
        x = np.repeat(x, self.d_input, axis=1).astype(np.float32)
        x += 0.3 * rng.randn(self.seq_len, self.d_input).astype(np.float32)
        return x, label


class ClassificationLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, num_shards: int = 1, shard_index: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.epoch = 0

    def __len__(self):
        return (len(self.dataset) // self.num_shards) // self.batch_size

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        self.epoch += 1
        idx = idx[self.shard_index::self.num_shards]
        for b in range(len(self)):
            batch = idx[b * self.batch_size:(b + 1) * self.batch_size]
            xs = np.stack([self.dataset[int(i)][0] for i in batch])
            ys = np.asarray([self.dataset[int(i)][1] for i in batch],
                            np.int32)
            yield xs, ys


def create_classification_dataset(batch_size: int, seed: int = 0,
                                  size: int = 128, seq_len: int = 128,
                                  d_input: int = 1, n_classes: int = 4,
                                  num_shards: int = 1, shard_index: int = 0):
    """Returns (train, val, test, n_classes, seq_len, d_input, train_size)
    — the same tuple contract as create_ndns_dataset."""
    mk = lambda s, shuffle: ClassificationLoader(
        SyntheticSequenceClassification(size, seq_len, d_input, n_classes,
                                        seed + s),
        batch_size, shuffle=shuffle, seed=seed,
        num_shards=num_shards, shard_index=shard_index)
    return (mk(0, True), mk(1, False), mk(2, False), n_classes, seq_len,
            d_input, size)


# ---------------------------------------------------------------------------
# Sequential MNIST (torch-free IDX reader) — reference basic.py:14-60
# ---------------------------------------------------------------------------

def read_idx(path: str) -> np.ndarray:
    """Pure-numpy reader for the MNIST IDX format (big-endian header:
    2 zero bytes, dtype code, ndim; then ndim uint32 dims; then data).
    ``.gz`` files are decompressed transparently."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        zeros, dtype_code, ndim = struct.unpack(">HBB", f.read(4))
        if zeros != 0:
            raise ValueError(f"{path}: bad IDX magic")
        dtypes = {0x08: np.uint8, 0x09: np.int8, 0x0B: np.dtype(">i2"),
                  0x0C: np.dtype(">i4"), 0x0D: np.dtype(">f4"),
                  0x0E: np.dtype(">f8")}
        if dtype_code not in dtypes:
            raise ValueError(f"{path}: unknown IDX dtype 0x{dtype_code:x}")
        dims = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtypes[dtype_code])
    if data.size != int(np.prod(dims)):
        raise ValueError(f"{path}: truncated IDX payload "
                         f"({data.size} vs {dims})")
    return data.reshape(dims)


def bitreversal_permutation(n: int) -> np.ndarray:
    """Bit-reversal permutation of [0, n) (n need not be a power of two:
    computed on the next power of two, then filtered) — the psMNIST
    permutation the reference applies (basic.py:40-43)."""
    m = 1 << max(1, (n - 1).bit_length())
    bits = m.bit_length() - 1
    perm = np.arange(m)
    rev = np.zeros(m, np.int64)
    for b in range(bits):
        rev |= ((perm >> b) & 1) << (bits - 1 - b)
    return rev[rev < n]


_IDX_NAMES = {
    "train_images": ("train-images-idx3-ubyte", "train-images.idx3-ubyte"),
    "train_labels": ("train-labels-idx1-ubyte", "train-labels.idx1-ubyte"),
    "test_images": ("t10k-images-idx3-ubyte", "t10k-images.idx3-ubyte"),
    "test_labels": ("t10k-labels-idx1-ubyte", "t10k-labels.idx1-ubyte"),
}


def _find_idx(data_dir: str, key: str) -> str:
    for name in _IDX_NAMES[key]:
        for cand in (os.path.join(data_dir, name),
                     os.path.join(data_dir, name + ".gz"),
                     os.path.join(data_dir, "MNIST", "raw", name),
                     os.path.join(data_dir, "MNIST", "raw", name + ".gz")):
            if os.path.exists(cand):
                return cand
    raise FileNotFoundError(
        f"MNIST IDX file for {key!r} not found under {data_dir!r} "
        f"(looked for {_IDX_NAMES[key]}, optionally .gz, optionally "
        "under MNIST/raw/)")


class SMNIST:
    """Sequential MNIST: each 28x28 image as a (784, 1) float32 sequence
    in [0, 1]; ``permute=True`` applies the bit-reversal permutation
    (psMNIST). Same __len__/__getitem__ contract as the synthetic task.

    ``split``: "train" / "val" / "test" — train/val carved from the
    60k training set with a seeded shuffle (reference val_split=0.1,
    seed 42; basic.py:22-27)."""

    d_input = 1
    n_classes = 10
    seq_len = 784

    def __init__(self, data_dir: Optional[str] = None,
                 split: str = "train", permute: bool = False,
                 val_split: float = 0.1, seed: int = 42):
        data_dir = data_dir or os.environ.get("SMNIST_DATA_DIR")
        if not data_dir:
            raise FileNotFoundError(
                "sMNIST needs the MNIST IDX files: pass data_dir or set "
                "SMNIST_DATA_DIR")
        if split == "test":
            images = read_idx(_find_idx(data_dir, "test_images"))
            labels = read_idx(_find_idx(data_dir, "test_labels"))
        else:
            images = read_idx(_find_idx(data_dir, "train_images"))
            labels = read_idx(_find_idx(data_dir, "train_labels"))
            idx = np.arange(len(images))
            np.random.RandomState(seed).shuffle(idx)
            n_val = int(round(val_split * len(images)))
            idx = idx[:n_val] if split == "val" else idx[n_val:]
            images, labels = images[idx], labels[idx]
        if images.ndim != 3 or images.shape[1] * images.shape[2] != 784:
            raise ValueError(f"unexpected MNIST image shape {images.shape}")
        self.images = images.reshape(len(images), 784, 1)
        self.labels = labels.astype(np.int64)
        self.perm = bitreversal_permutation(784) if permute else None

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, int]:
        x = self.images[idx].astype(np.float32) / 255.0
        if self.perm is not None:
            x = x[self.perm]
        return x, int(self.labels[idx])


def create_smnist_dataset(batch_size: int, data_dir: Optional[str] = None,
                          permute: bool = False, seed: int = 0,
                          num_shards: int = 1, shard_index: int = 0):
    """Same tuple contract as create_classification_dataset /
    create_ndns_dataset: (train, val, test, n_classes, seq_len, d_input,
    train_size). Raises FileNotFoundError when the IDX files are absent
    (callers gate availability on that, not on an import)."""
    mk = lambda split, shuffle: ClassificationLoader(
        SMNIST(data_dir, split=split, permute=permute),
        batch_size, shuffle=shuffle, seed=seed,
        num_shards=num_shards, shard_index=shard_index)
    train = mk("train", True)
    return (train, mk("val", False), mk("test", False), SMNIST.n_classes,
            SMNIST.seq_len, SMNIST.d_input, len(train.dataset))
