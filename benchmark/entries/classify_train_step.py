"""Entry ``classify_train_step``: the classification training step of the
program, one step in flight (closed loop), on one card.

A step takes its rows of the pool (the traffic's schedule), the
sequences (B, L, d_in) and their labels, and
``train/steps.make_classification_train_step``: forward, cross entropy,
backward and AdamW. The model is the one ``train(cfg)`` builds for a
classification dataset (``train/loop.build_model`` with the pool's
features in and the mix's classes out, ``create_run_state``).

Set-up, the kept steps and the check are ``entries/train_step``'s: the
benchmark's weights go into the program's model (the configuration has
no dropout), the first three steps run through the same call on distinct
rows, and their losses, the first gradient and the parameters after
three steps are held to the plain reference
(``benchmark/reference/pathx.py``) by ``entries/train_step.compare``.
The window goes on from step four.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.profiler import record_function

from benchmark.entries import train_step
from benchmark.reference import pathx
from benchmark.tasks.pathx import recipe_of

#: the numbers of a run, as ``entries/train_step`` takes them
check = train_step.check


class Runner(train_step.Runner):
    """The program objects and each step."""

    def __init__(self, ctx):
        from sparsernns_tpu_torch.train.loop import (build_model,
                                                     create_run_state)
        from sparsernns_tpu_torch.train.steps import \
            make_classification_train_step
        from sparsernns_tpu_torch.utils.config import RunConfig
        if ctx.ranks != 1:
            raise ValueError("classify_train_step runs on one card")
        self.ctx = ctx
        self.recipe = recipe_of(ctx.config)
        cfg = dataclasses.replace(RunConfig(), **self.recipe)
        model = build_model(cfg, ctx.shape.d_in, ctx.shape.classes,
                            training=True, device=ctx.device)
        missing, unexpected = model.load_state_dict(ctx.weights, strict=False)
        if unexpected or any("num_batches_tracked" not in k for k in missing):
            raise KeyError(f"weights do not fit the model: missing {missing}, "
                           f"unexpected {unexpected}")
        self.model = model
        self.state = create_run_state(
            cfg, model, ctx.config["assumed"]["steps_per_epoch"])
        self.step_fn = make_classification_train_step(model)
        self.bad = torch.zeros((), dtype=torch.int64, device=ctx.device)
        self.kept = {}
        ctx.faults.apply_train(self)

    def batch(self, i: int):
        rows = self.ctx.schedule[i]
        return self.ctx.data["inputs"][rows], self.ctx.data["labels"][rows]

    def step(self, i: int) -> None:
        """Enqueue step ``i`` (no synchronize)."""
        inputs, labels = self.batch(i)
        with record_function("bench.train_step"):
            _, metrics = self.step_fn(self.state, inputs, labels)
        loss = metrics["loss"]
        self.bad += (~torch.isfinite(loss)).to(torch.int64)
        self.last_loss = loss

    def reference(self, prec: str = "fp32"):
        """(losses, first gradients, parameters after the first steps) of
        the reference on the same rows."""
        ctx = self.ctx
        return pathx.train_steps(
            ctx.weights, list(self.kept["params"]),
            [self.batch(i) for i in range(train_step.CHECK_STEPS)],
            self.recipe, ctx.config["assumed"]["steps_per_epoch"], prec)
