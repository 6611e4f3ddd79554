"""Entry ``train_step``: the recipe's training step of the program, one
step in flight (closed loop).

A step takes its rows of the clip pool (the traffic's schedule), the STFTs
of noisy and clean audio (``train/loop.prep_ndns_batch``) and
``train/steps.make_ndns_train_step``: forward, loss, backward and AdamW.
On ``ranks`` > 1 the step is one rank's part of a data-parallel step
(``parallel/``: the gradients and BatchNorm statistics averaged over the
ranks), each rank on its ``batch`` rows of the global batch.

Set-up loads the benchmark's weights into the program's model, builds the
optimizer state and hands the dropout generator, seeded by the benchmark
per rank, to the state; then the first three steps run through the same
call on distinct rows and their losses, the first gradient (from AdamW's
first moment after one step) and the parameters after three steps are
kept for the check. The window goes on from step four.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch.profiler import record_function

from benchmark.harness.seeds import derive
from benchmark.reference import ndns
from benchmark.reference.train import BETAS, train_steps

CHECK_STEPS = 3


def dropout_seed(seed: int, rank: int) -> int:
    return derive(seed, f"dropout.{rank}")


class Runner:
    """One rank's program objects and its part of each step."""

    #: the window goes on after the checked steps
    first_step, min_steps = CHECK_STEPS, 0
    #: steps of a traced run's profiled stretch
    traced_steps = 6

    def __init__(self, ctx):
        from sparsernns_tpu_torch.train.loop import (build_model,
                                                     create_run_state,
                                                     prep_ndns_batch)
        from sparsernns_tpu_torch.train.steps import make_ndns_train_step
        from sparsernns_tpu_torch.utils.config import RunConfig
        self.ctx = ctx
        cfg = dataclasses.replace(RunConfig(), **ctx.config["defaults"],
                                  **ctx.config["recipe"])
        self.per_rank = ctx.mix["batch"]
        self.rows = slice(ctx.rank * self.per_rank,
                          (ctx.rank + 1) * self.per_rank)
        model = build_model(cfg, ctx.shape.d_io, ctx.shape.d_io,
                            training=True, device=ctx.device, mesh=ctx.mesh)
        missing, unexpected = model.load_state_dict(ctx.weights, strict=False)
        if unexpected or any("num_batches_tracked" not in k for k in missing):
            raise KeyError(f"weights do not fit the model: missing {missing}, "
                           f"unexpected {unexpected}")
        spe = ctx.config["assumed"]["steps_per_epoch"]
        state = create_run_state(cfg, model, spe, mesh=ctx.mesh)
        if ctx.mesh is not None:
            from sparsernns_tpu_torch.parallel.sharding import \
                shard_train_state
            shard_train_state(state, ctx.mesh)
        state.generator = torch.Generator(device=ctx.device).manual_seed(
            dropout_seed(ctx.seed, ctx.rank))
        self.model, self.state = model, state
        self.prep = prep_ndns_batch
        self.step_fn = make_ndns_train_step(model)
        self.bad = torch.zeros((), dtype=torch.int64, device=ctx.device)
        self.kept: Dict[str, object] = {}
        ctx.faults.apply_train(self)

    def step(self, i: int) -> None:
        """Enqueue step ``i`` (no synchronize)."""
        rows = self.ctx.schedule[i, self.rows]
        data = self.ctx.data
        noisy, clean = data["noisy"][rows], data["clean"][rows]
        with record_function("bench.stft"):
            feats = self.prep(noisy, clean)
        with record_function("bench.train_step"):
            _, metrics = self.step_fn(self.state, *feats, clean)
        loss = metrics["loss"]
        self.bad += (~torch.isfinite(loss)).to(torch.int64)
        self.last_loss = loss

    def setup(self) -> None:
        """The first steps, kept for the check; they build every kernel."""
        losses = []
        for i in range(CHECK_STEPS):
            self.step(i)
            losses.append(self.last_loss.detach().clone())
            if i == 0:
                self.kept["first_grad"] = {
                    n: self.state.optimizer.state[p]["exp_avg"].detach()
                    / (1.0 - BETAS[0])
                    for n, p in self.model.named_parameters()}
        self.kept["params"] = {n: p.detach().clone()
                               for n, p in self.model.named_parameters()}
        self.kept["losses"] = [float(x) for x in losses]

    def failed(self) -> int:
        return int(self.bad)

    def release(self) -> None:
        del self.model, self.state, self.step_fn
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ check

    def reference_inputs(self):
        """The global rows of the first steps, as (noisy, clean)."""
        ctx = self.ctx
        batches = []
        for i in range(CHECK_STEPS):
            rows = ctx.schedule[i]
            batches.append((ctx.data["noisy"][rows],
                            ctx.data["clean"][rows]))
        return batches

    def reference(self, prec: str = "fp32"):
        """(losses, first gradients, parameters after the first steps) of
        the reference on the global batch."""
        ctx = self.ctx
        recipe = {**ctx.config["defaults"], **ctx.config["recipe"]}
        gens = [torch.Generator(device=ctx.device).manual_seed(
            dropout_seed(ctx.seed, r)) for r in range(ctx.ranks)]
        layers = recipe["n_layers"]
        keep = 1.0 - recipe["p_dropout"]
        masks = [ndns.dropout_masks(gens, self.per_rank, recipe["d_model"],
                                    layers, keep, ctx.device)
                 for _ in range(CHECK_STEPS)]
        return train_steps(ctx.weights, list(self.kept["params"]),
                           self.reference_inputs(), masks, recipe,
                           ctx.config["assumed"]["steps_per_epoch"], prec)


def compare(prog: dict, ref):
    """The numbers the check compares: the largest relative gap of a
    step's loss; by the worst leaf, the gap of the first gradient's norm
    and of the norm of the parameters' change over the first steps, each
    against the reference's norm of that leaf or of the median leaf,
    whichever is larger. Leaves whose reference gradient is below a
    thousandth of the median leaf's move by round-off alone and are left
    out of the change; they come back as the second value."""
    losses, first, params = ref
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                        losses))
    init = prog["init"]
    gnorm = {k: float(first[k].norm()) for k in first}
    med_g = float(torch.tensor(list(gnorm.values())).median())
    grad_gap = max(abs(float(prog["first_grad"][k].norm()) - gnorm[k])
                   / max(gnorm[k], med_g) for k in gnorm)
    moved = [k for k in gnorm if gnorm[k] >= 1e-3 * med_g]
    cref = {k: float((params[k] - init[k]).norm()) for k in moved}
    med_c = float(torch.tensor(list(cref.values())).median())
    change_gap = max(abs(float((prog["params"][k] - init[k]).norm())
                         - cref[k]) / max(cref[k], med_c) for k in moved)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap}, sorted(set(gnorm) - set(moved))


def check(runner: Runner, control: Optional[str] = None) -> Dict[str, float]:
    """The numbers of this run: the program against the reference, or
    with ``control`` the reference in TF32 in the program's place."""
    ctx = runner.ctx
    init = {k: ctx.weights[k] for k in runner.kept["params"]}
    ref = runner.reference("fp32")
    if control is None:
        prog = dict(runner.kept, init=init)
    else:
        c_losses, c_first, c_params = runner.reference("tf32")
        prog = dict(losses=c_losses, first_grad=c_first, params=c_params,
                    init=init)
    numbers, runner.left_out = compare(prog, ref)
    return numbers
