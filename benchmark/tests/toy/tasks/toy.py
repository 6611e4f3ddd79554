"""Task ``toy``: sequence classification by a linear read-out of each
sequence's time-mean. Its own leaves, shape and small sizes."""

from __future__ import annotations

from typing import NamedTuple

from benchmark.harness.weights import draw
from benchmark.tasks import Prepared

TINY = {"mix": {"length": 12, "pool_rows": 16, "batch": 4}}


class Shape(NamedTuple):
    b: int          # sequences a step
    l: int          # steps of a sequence
    classes: int


def leaves(classes: int):
    return [("head.weight", (classes, 1), "normal", 0.0, 1.0),
            ("head.bias", (classes,), "normal", 0.0, 0.1)]


def prepare(cell: dict, seed: int, device, generator) -> Prepared:
    mix = cell["mix"]
    inputs, labels = generator.make_pool(mix, seed, device)
    weights = draw(leaves(mix["classes"]), seed, device)
    shape = Shape(mix["batch"], mix["length"], mix["classes"])
    return Prepared({"inputs": inputs, "labels": labels}, weights, [], shape)
