"""Seeds of a run's parts, derived from ``--seed`` and a tag, so that the
weights, the traffic, the dropout masks and the sampled answers are
independent draws of one seed."""

from __future__ import annotations

import zlib

import numpy as np


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for ``tag`` from any non-negative whole ``seed``."""
    words = [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF,
             (seed >> 64) & 0xFFFFFFFF, zlib.crc32(tag.encode())]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return int((int(state[0]) << 31) ^ int(state[1]))


def rng(seed: int, tag: str) -> np.random.Generator:
    return np.random.default_rng(derive(seed, tag))
