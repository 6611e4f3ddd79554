"""Entry ``toy_classify``: the toy task's forward and loss, one batch in
flight. The check compares the logits and loss of the first steps with a
float64 reference."""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

CHECKED = 2


def _forward(w, x, labels):
    logits = x.mean(1) @ w["head.weight"].T + w["head.bias"]
    return logits, F.cross_entropy(logits, labels)


class Runner:
    first_step, min_steps = 0, CHECKED
    traced_steps = 3

    def __init__(self, ctx):
        self.ctx = ctx
        self.bad = torch.zeros((), dtype=torch.int64, device=ctx.device)
        self.kept: Dict[int, tuple] = {}

    def _batch(self, i: int):
        rows = self.ctx.schedule[i]
        return self.ctx.data["inputs"][rows], self.ctx.data["labels"][rows]

    def step(self, i: int) -> None:
        logits, loss = _forward(self.ctx.weights, *self._batch(i))
        self.bad += (~torch.isfinite(loss)).to(torch.int64)
        if i < CHECKED:
            self.kept[i] = (logits, loss)

    def setup(self) -> None:
        _forward(self.ctx.weights, *self._batch(-1))

    def failed(self) -> int:
        return int(self.bad)

    def release(self) -> None:
        pass


def check(runner: Runner, control: Optional[str] = None) -> Dict[str, float]:
    w = {k: v.double() for k, v in runner.ctx.weights.items()}
    logit_gap = loss_gap = 0.0
    for i, (logits, loss) in runner.kept.items():
        x, labels = runner._batch(i)
        ref, ref_loss = _forward(w, x.double(), labels)
        logit_gap = max(logit_gap, float((logits - ref).abs().max()
                                         / ref.abs().max()))
        loss_gap = max(loss_gap, abs(float(loss) - float(ref_loss))
                       / abs(float(ref_loss)))
    return {"logit_gap": logit_gap, "loss_gap": loss_gap}
