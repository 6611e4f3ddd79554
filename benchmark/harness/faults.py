"""Faults planted underneath the timed path, for the tests that show the
check catching them (``benchmark/tests/test_portbench_faults.py``). A run
of the benchmark plants none.

- ``state_unchanged``: the train step runs, then the parameters are put
  back as they were: a step that returns its state unchanged;
- ``half_batch``: the program gets the first half of the batch only: the
  train step's loss is the mean over those rows; a request's second half
  gets the first half's answers;
- ``exchange_dropped``: the data-parallel gradient all-reduce is left out;
- ``answer_altered``: a request's last clip gets its first clip's mask;
- ``jax_on_rank1``: rank 1 holds a module named ``jax`` once the window
  has closed, which the run has to refuse.
"""

from __future__ import annotations

import sys
import types
from typing import Optional

import torch

FAULTS = ("state_unchanged", "half_batch", "exchange_dropped",
          "answer_altered", "jax_on_rank1")


class Faults:
    def __init__(self, name: Optional[str] = None):
        if name is not None and name not in FAULTS:
            raise ValueError(f"fault {name!r}")
        self.name = name
        self._undo = []

    def undo(self) -> None:
        """Put back what a fault replaced in the program's modules."""
        while self._undo:
            self._undo.pop()()

    def apply_rank(self, rank: int) -> None:
        if self.name == "jax_on_rank1" and rank == 1:
            sys.modules["jax"] = types.ModuleType("jax")

    def apply_train(self, runner) -> None:
        step = runner.step_fn
        if self.name == "state_unchanged":
            def unchanged(state, *args):
                before = [p.detach().clone()
                          for p in state.model.parameters()]
                out = step(state, *args)
                with torch.no_grad():
                    for p, b in zip(state.model.parameters(), before):
                        p.copy_(b)
                return out
            runner.step_fn = unchanged
        elif self.name == "half_batch":
            def half(state, *args):
                n = args[0].shape[0] // 2
                return step(state, *(a[:n] for a in args))
            runner.step_fn = half
        elif self.name == "exchange_dropped":
            from sparsernns_tpu_torch.train import steps
            original = steps.reduce_gradients
            steps.reduce_gradients = lambda model, mesh, metrics: metrics
            self._undo.append(
                lambda: setattr(steps, "reduce_gradients", original))

    def apply_denoise(self, runner) -> None:
        model = runner.model
        if self.name == "half_batch":
            def half(x):
                n = x.shape[0] // 2
                y = model(x[:n])
                return torch.cat([y, y[:x.shape[0] - n]], 0)
            runner.model = half
        elif self.name == "answer_altered":
            def altered(x):
                y = model(x).clone()
                y[-1] = y[0]
                return y
            runner.model = altered
