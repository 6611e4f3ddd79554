"""Published peaks of the cards the benchmark runs on, by a substring of
``torch.cuda.get_device_name``: NVIDIA's H100 SXM data sheet, dense, at
the card's full power limit of 700 W. Every roofline share and ``mfu``
is taken against the bf16 tensor-core rate: no implementation of the
configurations' float32 and w8a16 dots can beat it, so a sound change
never reads above 100 %."""

from __future__ import annotations

from typing import Tuple

#: (dense bf16 FLOP/s, memory bytes/s)
PEAKS = {
    "H100 80GB HBM3": (989e12, 3.35e12),
    "H100 SXM": (989e12, 3.35e12),
}


def peaks(device_name: str) -> Tuple[float, float]:
    """Raises ``ValueError`` for a card the table does not hold."""
    for key, value in PEAKS.items():
        if key in device_name:
            return value
    raise ValueError(f"no published peaks for {device_name!r}")


def least_seconds(flops: float, nbytes: float, device_name: str) -> float:
    flop_rate, byte_rate = peaks(device_name)
    return max(flops / flop_rate, nbytes / byte_rate)
