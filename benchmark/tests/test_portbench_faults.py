"""The check sees what it has to see: with the timed path broken
underneath (the harness's look for a card skipped, the CPU at small
shapes), each fault a cell can have makes ``correct`` false; and the
control, the reference one precision below the configuration's in the
program's place, fails each cell's limits."""

import pytest

from benchmark.harness import spec
from benchmark.tests.tiny import tiny_run, tiny_run_isolated

FAULTS = [("float_train_b32", "state_unchanged"),
          ("float_train_b32", "half_batch"),
          ("float_denoise_b32", "half_batch"),
          ("float_denoise_b32", "answer_altered"),
          ("w8a16_denoise_b32", "half_batch"),
          ("w8a16_denoise_b32", "answer_altered")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_planted_fault_makes_the_run_incorrect(cell, fault):
    out = tiny_run(cell, fault=fault)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", ["exchange_dropped", "state_unchanged",
                                   "half_batch", None])
def test_data_parallel_cell_on_four_gloo_ranks(fault):
    out = tiny_run_isolated("float_train_dp4", fault=fault)
    assert out["correct"] == (fault is None), out["checks"]
    assert out["device"]["count"] == 4


def test_a_forbidden_module_on_another_rank_refuses_the_run():
    """Rank 1 holds ``jax`` once the window has closed: no result."""
    with pytest.raises(RuntimeError, match=r"rank 1: \['jax'\]"):
        tiny_run_isolated("float_train_dp4", fault="jax_on_rank1")


@pytest.mark.parametrize("cell", ["float_train_b32", "float_denoise_b32",
                                  "w8a16_denoise_b32"])
def test_the_control_fails_the_limits(cell):
    rows = tiny_run(cell, readings={"seeds": [7, 8, 9], "control": True})
    limits = spec.cell(cell)["limits"]
    for row in rows:
        assert all(v <= limits[k] for k, v in row["program"].items()), row
        assert any(v > limits[k] for k, v in row["control"].items()), row
