"""Plain reference of the recipe's training step: the NDNS loss of the
reference model (``ndns.py``) in training mode, its gradient by autograd
in float32, and AdamW as the recipe sets it (``opt_config`` noBCdecay).

AdamW, per parameter, at step k (0 for the first update), with the
learning rate ``lr_k`` of its group: ``p <- p - lr_k * wd * p``, then
``m <- b1 m + (1 - b1) g``, ``v <- b2 v + (1 - b2) g^2`` and
``p <- p - lr_k * (m / (1 - b1^(k+1))) / (sqrt(v / (1 - b2^(k+1))) + eps)``
with b1 0.9, b2 0.999, eps 1e-8. noBCdecay puts B, C, D, Lambda, the
time steps and the norms in the "ssm" group (``ssm_lr_base``, no weight
decay) and the denses in the "regular" group (``lr_factor * ssm_lr_base``,
``weight_decay``). Each group warms up linearly from ``base / warmup`` to
``base`` over ``warmup`` steps (one epoch), then follows a cosine to
``lr_min`` at ``epochs`` epochs.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from benchmark.reference import ndns

BETAS = (0.9, 0.999)
EPS = 1e-8
SSM_KEYS = {"B", "C", "C1", "C2", "D", "Lambda_re", "Lambda_im", "norm",
            "log_step"}


def is_ssm(name: str) -> bool:
    return any(part in SSM_KEYS for part in name.split("."))


def scheduled_lr(base: float, step: int, total: int, warmup: int,
                 end: float) -> float:
    warmup = max(min(warmup, total - 1), 0)
    init = base / warmup if warmup > 0 else base
    warm = max(warmup, 1) if total > 1 else 0
    decay = max(total, 2) - warm
    if step < warm:
        return init + (base - init) * (step / warm)
    count = min(step - warm, decay)
    alpha = 0.0 if base == 0.0 else end / base
    cosine = 0.5 * (1.0 + math.cos(math.pi * count / decay))
    return base * ((1.0 - alpha) * cosine + alpha)


class AdamW:
    """The recipe's optimizer over a dict of leaf tensors."""

    def __init__(self, params: Dict[str, torch.Tensor], recipe: dict,
                 steps_per_epoch: int):
        if recipe.get("opt_config") != "noBCdecay" or recipe.get(
                "grad_clip_threshold") is not None:
            raise NotImplementedError("the reference optimizer is AdamW "
                                      "noBCdecay without clipping")
        self.params = params
        self.ssm_lr = recipe["ssm_lr_base"]
        self.lr = recipe["lr_factor"] * recipe["ssm_lr_base"]
        self.wd = recipe["weight_decay"]
        self.total = steps_per_epoch * recipe["epochs"]
        self.warmup = steps_per_epoch * recipe["warmup_end"]
        self.lr_min = recipe["lr_min"]
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.step_count = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        k = self.step_count
        b1, b2 = BETAS
        for name, p in self.params.items():
            ssm = is_ssm(name)
            lr = scheduled_lr(self.ssm_lr if ssm else self.lr, k, self.total,
                              self.warmup, self.lr_min)
            wd = 0.0 if ssm else self.wd
            g = grads[name]
            p.mul_(1.0 - lr * wd)
            self.m[name].mul_(b1).add_(g, alpha=1.0 - b1)
            self.v[name].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            m_hat = self.m[name] / (1.0 - b1 ** (k + 1))
            v_hat = self.v[name] / (1.0 - b2 ** (k + 1))
            p.sub_(lr * m_hat / (v_hat.sqrt() + EPS))
        self.step_count += 1


def train_steps(weights: Dict[str, torch.Tensor], param_names: List[str],
                batches, masks_per_step, recipe: dict,
                steps_per_epoch: int, prec: str = "fp32"):
    """Run ``len(batches)`` steps from ``weights`` (copied). ``batches``:
    (noisy, clean) audio (B, T) each; ``masks_per_step``: the dropout
    masks of each step (``ndns.dropout_masks``). Returns (losses, the
    first step's gradients by name, the parameters after the last step)."""
    w = {k: v.detach().clone() for k, v in weights.items()}
    params = {k: w[k] for k in param_names}
    opt = AdamW(params, recipe, steps_per_epoch)
    losses, first = [], None
    for (noisy, clean), masks in zip(batches, masks_per_step):
        x, mag, phase = ndns.features(noisy)
        clean_mag, _ = ndns.stft(clean)
        leaves = {k: v.requires_grad_(True) for k, v in params.items()}
        mask = ndns.forward({**w, **leaves}, x, training=True, masks=masks,
                            prec=prec)
        loss, _, _ = ndns.ndns_loss(mask, mag, phase, clean_mag, clean)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        grads = dict(zip(leaves, grads))
        for v in leaves.values():
            v.requires_grad_(False)
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        opt.step(grads)
        losses.append(float(loss.detach()))
        del mask, loss, grads
    return losses, first, params
