"""On the card, at the cells' own sizes: the program within each cell's
limits and the control (the reference one precision below the
configuration's in the program's place) beyond them, on three seeds.
Skips without a card."""

import time

import pytest

from benchmark.harness import core, spec

SEEDS = [2147500001, 2147500002, 2147500003]


@pytest.mark.card
@pytest.mark.parametrize("cell", ["float_train_b32", "float_denoise_b32",
                                  "w8a16_denoise_b32"])
def test_the_control_fails_at_the_cells_size(card, cell):
    rows = core.run_cell(cell, 0, 0.0, False, time.time(),
                         {"readings": {"seeds": SEEDS, "control": True}})
    limits = spec.cell(cell)["limits"]
    for row in rows:
        assert all(v <= limits[k] for k, v in row["program"].items()), row
        assert any(v > limits[k] for k, v in row["control"].items()), row
