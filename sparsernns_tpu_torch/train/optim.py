"""Optimizer configurations (counterpart of
``sparsernns_tpu/train/optim.py``).

The six ``opt_config``s (standard / qaft / constant / BandCdecay /
BfastandCdecay / noBCdecay) sort the parameters into three groups by name:

  "none":    frozen parameters (lr 0)
  "ssm":     SSM parameters (Adam, ssm_lr, no weight decay)
  "regular": everything else (AdamW, lr, weight decay; plain SGD under qaft)

:func:`create_optimizer` returns one ``torch.optim`` optimizer (AdamW, or
SGD for ``qaft``) with one param group per label. A group carries its
schedule as plain numbers (``base_lr``, ``schedule``, ``total_steps``,
``warmup_steps``, ``lr_min``, ``clip``), so the optimizer's ``state_dict``
holds all of it, and :func:`optimizer_step` is the update: it sets each
group's ``lr`` from the step (the counterpart of optax's
``inject_hyperparams``), clips each group's raw gradients to a global norm
where asked, and calls ``optimizer.step()``. A group's optional
``schedule_start`` is the step at which its schedule's count is 0: optax
counts the schedule in the optimizer's own state, so a fresh optimizer on a
state whose step count goes on (the conversion pipeline's finetuning over
the frozen tree) starts its schedule again. The arithmetic is optax's:
``adamw`` decays by ``lr * weight_decay * p`` (biases too), bias-corrected
moments, eps 1e-8 outside the root.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

LABELS = ("none", "ssm", "regular")


def warmup_cosine(base_lr: float, total_steps: int, warmup_steps: int,
                  end_value: float = 1e-6) -> Callable[[int], float]:
    """Linear warm-up to ``base_lr`` over ``warmup_steps``, then a cosine
    to ``end_value`` at ``total_steps``: step -> learning rate, with the
    JAX package's edge rules (``total_steps <= 0`` is constant; the warm-up
    is cut to ``total_steps - 1``)."""
    if total_steps <= 0:
        return lambda step: base_lr
    warmup = max(min(warmup_steps, total_steps - 1), 0)
    init = base_lr / warmup if warmup > 0 else base_lr
    warm = (max(warmup, 1) if total_steps > 1 else 0)
    decay = max(total_steps, 2) - warm
    alpha = 0.0 if base_lr == 0.0 else end_value / base_lr

    def schedule(step: int) -> float:
        if step < warm:
            return init + (base_lr - init) * (step / warm)
        count = min(step - warm, decay)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / decay))
        return base_lr * ((1.0 - alpha) * cosine + alpha)

    return schedule


# Parameter-name -> group rules per opt config. A parameter whose name has
# a matching component goes to the given group.
_SSM_KEYS_BASE = ("B", "Lambda_re", "Lambda_im", "norm")
_OPT_CONFIG_RULES = {
    # opt_config: (ssm_keys, none_keys)
    "standard": (_SSM_KEYS_BASE, ()),
    "qaft": (_SSM_KEYS_BASE, ()),
    "constant": (_SSM_KEYS_BASE, ()),
    "BandCdecay": (("Lambda_re", "Lambda_im", "norm"), ("B",)),
    "BfastandCdecay": (("Lambda_re", "Lambda_im", "norm"), ()),
    "noBCdecay": (("B", "C", "C1", "C2", "D", "Lambda_re", "Lambda_im",
                   "norm"), ()),
}

OPT_CONFIGS = tuple(_OPT_CONFIG_RULES)


def _is_quant_scale(names) -> bool:
    """A quantization scale (never optimized directly); a norm's scale is
    an ordinary parameter."""
    return bool(names) and names[-1] == "scale" and "norm" not in names


def param_label(name: str, opt_config: str, dt_global: bool = False) -> str:
    """The group of the parameter called ``name`` (dotted module path, as
    ``named_parameters`` gives it)."""
    ssm_keys, none_keys = _OPT_CONFIG_RULES[opt_config]
    ssm_keys = set(ssm_keys)
    if not dt_global:
        ssm_keys |= {"log_step"}
    names = name.split(".")
    if _is_quant_scale(names):
        return "none"
    for n in names:
        if n in none_keys:
            return "none"
        if n in ssm_keys:
            return "ssm"
    return "regular"


def create_optimizer(
    named_params: Iterable[Tuple[str, torch.nn.Parameter]],
    opt_config: str = "standard",
    lr: float = 1e-3,
    ssm_lr: float = 1e-3,
    weight_decay: float = 0.0,
    total_steps: int = 0,
    warmup_steps: int = 0,
    grad_clip_threshold: Optional[float] = None,
    dt_global: bool = False,
    lr_min: float = 1e-6,
    schedule: str = "cosine",
) -> torch.optim.Optimizer:
    """``named_params``: ``model.named_parameters()``. ``schedule=
    "constant"`` keeps the learning rates flat whatever the opt_config:
    the base for reduce-on-plateau control, where the loop overrides them
    per epoch through :func:`set_learning_rates`."""
    if opt_config not in _OPT_CONFIG_RULES:
        raise ValueError(
            f"opt_config {opt_config!r} not in {sorted(_OPT_CONFIG_RULES)}")
    if schedule not in ("cosine", "constant"):
        raise ValueError(f"schedule {schedule!r}: cosine or constant")
    if opt_config == "constant":
        schedule = "constant"
    members: Dict[str, list] = {label: [] for label in LABELS}
    for name, param in named_params:
        members[param_label(name, opt_config, dt_global)].append(param)
    base = {"none": 0.0, "ssm": ssm_lr, "regular": lr}
    groups = []
    for label in LABELS:
        flat = schedule == "constant" or label == "none"
        groups.append(dict(
            params=members[label], label=label, base_lr=base[label],
            lr=base[label], schedule="constant" if flat else "cosine",
            total_steps=total_steps, warmup_steps=warmup_steps,
            lr_min=lr_min, clip=grad_clip_threshold,
            weight_decay=weight_decay if label == "regular" else 0.0))
    if opt_config == "qaft":
        # QAFT tunes with plain SGD everywhere, no weight decay
        for g in groups:
            g["weight_decay"] = 0.0
        return torch.optim.SGD(groups, lr=0.0)
    return torch.optim.AdamW(groups, lr=0.0, betas=(0.9, 0.999), eps=1e-8)


def scheduled_lr(group: dict, step: int) -> float:
    """The learning rate of a param group at optimizer step ``step``."""
    if group["schedule"] == "constant":
        return group["base_lr"]
    return warmup_cosine(group["base_lr"], group["total_steps"],
                         group["warmup_steps"], group["lr_min"])(
        step - group.get("schedule_start", 0))


def clip_group_gradients(optimizer: torch.optim.Optimizer,
                         norms: Optional[Dict[str, torch.Tensor]] = None
                         ) -> None:
    """Scale each group's gradients so that the group's global norm is at
    most its ``clip`` (per group, on the raw gradients, before the
    update). ``norms``: each group's norm by label, where the group's
    gradients here are slices of the whole (tensor parallelism); None: the
    norm of the gradients here."""
    for group in optimizer.param_groups:
        max_norm = group.get("clip")
        grads = [p.grad for p in group["params"] if p.grad is not None]
        if max_norm is None or not grads:
            continue
        if norms is not None:
            norm = norms[group["label"]]
        else:
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
        # optax: unchanged below the threshold, else g / norm * max_norm
        factor = torch.where(norm < max_norm, torch.ones_like(norm),
                             max_norm / norm)
        for g in grads:
            g.mul_(factor)


def optimizer_step(optimizer: torch.optim.Optimizer, step: int,
                   norms: Optional[Dict[str, torch.Tensor]] = None) -> None:
    """One update from the gradients in ``.grad``: learning rates of step
    ``step`` (0 for the first update), per-group clipping (by ``norms``
    where given, :func:`clip_group_gradients`), then the optimizer's own
    step."""
    for group in optimizer.param_groups:
        group["lr"] = scheduled_lr(group, step)
    clip_group_gradients(optimizer, norms)
    optimizer.step()


def reduce_lr_on_plateau(lr: float, ssm_lr: float, count: int,
                         new_metric: float, best_metric: float,
                         factor: float = 0.2, patience: int = 20,
                         lr_min: float = 1e-6):
    """Host-side plateau decay of both learning rates on a quality metric
    that should grow. Returns (lr, ssm_lr, count, best_metric)."""
    if new_metric > best_metric:
        count = 0
        best_metric = new_metric
    else:
        count += 1
    if count > patience:
        lr = max(factor * lr, lr_min)
        ssm_lr = max(factor * ssm_lr, lr_min)
        count = 0
    return lr, ssm_lr, count, best_metric


def set_learning_rates(optimizer: torch.optim.Optimizer, lr: float,
                       ssm_lr: float) -> None:
    """Override the base learning rates of the "regular" and "ssm" groups
    (the plateau-schedule hook)."""
    for group in optimizer.param_groups:
        new = {"ssm": ssm_lr, "regular": lr}.get(group["label"])
        if new is not None:
            group["base_lr"] = group["lr"] = float(new)


def extract_learning_rates(optimizer: torch.optim.Optimizer
                           ) -> Dict[str, float]:
    """The live learning rate of every group, as ``{"<label>/lr": lr}``."""
    return {f"{g['label']}/lr": float(g["lr"])
            for g in optimizer.param_groups}


def _quant_scale_params(model: torch.nn.Module):
    for name, param in model.named_parameters():
        if _is_quant_scale(name.split(".")):
            yield param


def zero_scale_gradients(model: torch.nn.Module) -> None:
    """Zero the gradients of frozen quantization scale parameters."""
    for param in _quant_scale_params(model):
        if param.grad is not None:
            param.grad.zero_()


def scale_gradient_leak_norm(model: torch.nn.Module) -> torch.Tensor:
    """Total |grad| mass on quantization scale parameters: zero after
    :func:`zero_scale_gradients`; anything else is a leak."""
    total = torch.zeros(())
    for param in _quant_scale_params(model):
        if param.grad is not None:
            total = total + param.grad.abs().sum().cpu()
    return total
