"""Magnitude, state-channel and tile pruning with straight-through masks
(counterpart of ``sparsernns_tpu/train/pruning.py``).

- iterative pruning on a cubic sparsity schedule, masks updated every
  ``update_freq`` steps between ``update_start`` and ``update_end``;
- ERK or uniform per-layer sparsity;
- three mask rules: per-weight magnitude, whole SSM state channels (B̄ rows
  and C columns together) and whole (32, 128) tiles of the 2-D dense
  kernels, which the serving engine skips (``ops/cuda/block_sparse.py``);
- STE: the forward sees the masked weights, the gradient reaches the dense
  weights whole (``mode="hard"`` masks the gradient too and zeroes the
  pruned weights after each optimizer step).

Masks are a dict keyed by the JAX package's leaf paths
(``jax.tree_util.keystr`` form, ``"['encoder']['encoder']['kernel']"``),
one for every parameter of the model, each with its parameter's shape: a
dense kernel's mask is (out, in) like ``nn.Linear.weight``, though tiles
and prunability are decided on the JAX leaf, the (in, out) kernel. Masks
live on the parameters' device and are updated in place in the dict.

The schedule and the cut index are computed in float32, as in the JAX
package, so the masks equal its masks element for element on the same
weights; a tile's Frobenius score is a sum, which the two frameworks take
in another order, so a near-tie between two tiles could fall either way.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sparsernns_tpu_torch.weights import flax_path

Masks = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class PruningConfig:
    """Schedule and distribution of iterative pruning."""

    final_sparsity: float = 0.0
    update_start: int = 0      # first step at which masks may update
    update_end: int = 1        # step at which final sparsity is reached
    update_freq: int = 1       # steps between mask updates
    distribution: str = "erk"  # "erk" | "uniform"
    mode: str = "ste"          # "ste" | "hard"
    min_ndim: int = 2          # only prune leaves with >= this many dims
    #: "unstructured" (per weight), "state" (whole state channels) or
    #: "block" (whole ``block_shape`` tiles of the 2-D dense kernels)
    structure: str = "unstructured"
    block_shape: tuple = (32, 128)

    @property
    def enabled(self) -> bool:
        return self.final_sparsity > 0.0

    @staticmethod
    def iterative_ste(final_sparsity: float, epochs: int,
                      steps_per_epoch: int) -> "PruningConfig":
        """The ``iterative-ste-mag-X`` recipe: an update every half-epoch
        from 5 % to 90 % of the training steps, ERK."""
        total = epochs * steps_per_epoch
        return PruningConfig(
            final_sparsity=final_sparsity,
            update_start=int(0.05 * total),
            update_end=int(0.9 * total),
            update_freq=max(1, steps_per_epoch // 2),
            distribution="erk",
            mode="ste",
        )


def pruning_recipes(epochs: int, steps_per_epoch: int) -> dict:
    """Name -> config: ``no_prune`` and, for ten final sparsities, the
    magnitude (``iterative-ste-mag-X``), state-channel
    (``iterative-ste-state-X``) and tile (``iterative-ste-block-X``)
    recipes, the last two uniform across layers."""
    recipes = {"no_prune": PruningConfig()}
    for s in (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 0.95):
        base = PruningConfig.iterative_ste(s, epochs, steps_per_epoch)
        recipes[f"iterative-ste-mag-{s}"] = base
        recipes[f"iterative-ste-state-{s}"] = dataclasses.replace(
            base, structure="state", distribution="uniform")
        recipes[f"iterative-ste-block-{s}"] = dataclasses.replace(
            base, structure="block", distribution="uniform")
    return recipes


_NEVER_PRUNE = (
    # quantization scales / norm parameters
    "scale", "bias", "mean", "var",
    # SSM dynamics (log_step is (P, 1), so its rank alone does not keep it)
    "log_step", "Lambda_re", "Lambda_im",
)


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One parameter of the model under its JAX leaf path."""

    key: str                    # the JAX keystr
    path: Tuple[str, ...]
    name: str                   # the port's parameter name
    param: torch.nn.Parameter
    transposed: bool            # the port's tensor is the JAX leaf's .T

    @property
    def shape(self) -> Tuple[int, ...]:
        """The JAX leaf's shape."""
        shape = tuple(self.param.shape)
        return shape[::-1] if self.transposed else shape

    def flax_view(self) -> torch.Tensor:
        """The parameter in the JAX leaf's layout (a view), detached."""
        p = self.param.detach()
        return p.T if self.transposed else p

    def from_flax(self, t: torch.Tensor) -> torch.Tensor:
        """A tensor of the JAX leaf's layout in the parameter's layout."""
        return t.T.contiguous() if self.transposed else t


def model_leaves(model: torch.nn.Module) -> List[Leaf]:
    """Every parameter of ``model`` as a :class:`Leaf`, in the JAX
    package's leaf order (dict keys sorted at every level)."""
    out = []
    for name, param in model.named_parameters():
        path, transposed = flax_path(name)
        key = "".join(f"['{p}']" for p in path)
        out.append(Leaf(key, path, name, param, transposed))
    return sorted(out, key=lambda leaf: leaf.path)


def _prunable(leaf: Leaf, cfg: PruningConfig) -> bool:
    ndim = len(leaf.shape)
    if ndim < cfg.min_ndim:
        return False
    # block mode prunes exactly the 2-D dense kernels
    if cfg.structure == "block" and ndim != 2:
        return False
    return not any(n in _NEVER_PRUNE for n in leaf.path)


def _erk_density_factor(shape) -> float:
    """ERK keeps density proportional to sum(dims)/prod(dims)."""
    n = 1
    s = 0
    for d in shape:
        n *= d
        s += d
    return s / n


def sparsity_distribution(model: torch.nn.Module, cfg: PruningConfig
                          ) -> Dict[str, float]:
    """Per-leaf multipliers of the scheduled global sparsity, keyed like
    the masks: the global (parameter-weighted) sparsity is the schedule's
    when every layer takes its multiple; 0 for leaves that are not pruned.
    ERK is solved at the final target with saturation at density 1."""
    leaves = model_leaves(model)
    prunable = {leaf.key: leaf.shape for leaf in leaves
                if _prunable(leaf, cfg)}
    if not prunable:
        return {leaf.key: 0.0 for leaf in leaves}

    if cfg.distribution == "uniform":
        per_layer = {k: 1.0 for k in prunable}
    elif cfg.distribution == "erk":
        s_final = max(cfg.final_sparsity, 1e-6)
        factors = {k: _erk_density_factor(s) for k, s in prunable.items()}
        sizes = {k: int(np.prod(s)) for k, s in prunable.items()}
        total = sum(sizes.values())
        saturated: set = set()
        eps = 0.0
        for _ in range(len(prunable) + 1):
            rhs = (1.0 - s_final) * total - sum(
                sizes[k] for k in saturated)
            denom = sum(sizes[k] * factors[k]
                        for k in prunable if k not in saturated)
            if denom <= 0:
                break
            eps = rhs / denom
            newly = {k for k in prunable
                     if k not in saturated and eps * factors[k] >= 1.0}
            if not newly:
                break
            saturated |= newly
        per_layer = {}
        for k in prunable:
            density = 1.0 if k in saturated else min(1.0, eps * factors[k])
            per_layer[k] = max(0.0, (1.0 - density) / s_final)
    else:
        raise ValueError(f"unknown distribution {cfg.distribution}")
    return {leaf.key: per_layer.get(leaf.key, 0.0) for leaf in leaves}


def scheduled_sparsity(cfg: PruningConfig, step: int) -> np.float32:
    """Cubic ramp from 0 at ``update_start`` to ``final_sparsity`` at
    ``update_end``, in float32 as the JAX package computes it."""
    f32 = np.float32
    span = max(1, cfg.update_end - cfg.update_start)
    progress = f32(step - cfg.update_start) / f32(span)
    progress = min(max(progress, f32(0.0)), f32(1.0))
    rest = f32(1.0) - progress
    return f32(cfg.final_sparsity) * (f32(1.0) - rest * (rest * rest))


def _cut(sparsity: np.float32, n: int) -> int:
    """The sorted index of the threshold: ``int32(sparsity * n)`` in
    float32, clipped to [0, n - 1]."""
    return min(max(int(np.float32(sparsity) * np.float32(n)), 0), n - 1)


def _keep(score: torch.Tensor, cut: int) -> torch.Tensor:
    """score >= its ``cut``-th smallest value (ties kept); all at cut 0."""
    if cut == 0:
        return torch.ones_like(score, dtype=torch.bool)
    return score >= score.kthvalue(cut + 1).values


def _mask_for_leaf(w: torch.Tensor, sparsity: np.float32) -> torch.Tensor:
    """Keep the (1 - sparsity) largest-magnitude entries (elementwise, so
    any layout)."""
    mag = w.detach().abs()
    keep = _keep(mag.reshape(-1), _cut(sparsity, mag.numel()))
    return keep.reshape(w.shape).to(w.dtype)


def _block_mask_for_leaf(w: torch.Tensor, sparsity: np.float32,
                         block_shape) -> torch.Tensor:
    """Keep the (1 - sparsity) largest-Frobenius-norm tiles of a 2-D
    kernel ``w`` in the JAX (in, out) layout; edge tiles are scored on
    their content. Returns the mask in that layout."""
    bk, bn = block_shape
    k, n = w.shape
    kt, nt = -(-k // bk), -(-n // bn)
    pad = F.pad(w.detach().to(torch.float32), (0, nt * bn - n, 0, kt * bk - k))
    tiles = pad.reshape(kt, bk, nt, bn)
    score = (tiles * tiles).sum(dim=(1, 3)).reshape(-1)
    keep = _keep(score, _cut(sparsity, kt * nt)).reshape(kt, 1, nt, 1)
    mask = keep.expand(kt, bk, nt, bn).reshape(kt * bk, nt * bn)
    return mask[:k, :n].to(w.dtype)


@dataclasses.dataclass
class MagnitudePruner:
    """Computes and applies the masks; they live in the run's
    ``TrainState``."""

    cfg: PruningConfig
    #: per-leaf multipliers (:func:`sparsity_distribution`), set by
    #: :meth:`init_masks`
    relative_sparsity: Optional[Dict[str, float]] = None

    def init_masks(self, model: torch.nn.Module) -> Masks:
        """Masks of ones for every parameter."""
        self.relative_sparsity = sparsity_distribution(model, self.cfg)
        return {leaf.key: torch.ones_like(leaf.param, requires_grad=False)
                for leaf in model_leaves(model)}

    @torch.no_grad()
    def update_masks(self, model: torch.nn.Module, masks: Masks,
                     step: int) -> Masks:
        """Recompute the masks in place where the schedule has an update at
        ``step`` (the state-channel rule at every call: the caller gates
        the calls, :func:`~sparsernns_tpu_torch.train.steps.make_mask_update_fn`).
        Returns ``masks``."""
        cfg = self.cfg
        if not cfg.enabled:
            return masks
        if cfg.structure == "state":
            return self._update_state_masks(model, masks, step)
        if self.relative_sparsity is None:
            self.relative_sparsity = sparsity_distribution(model, cfg)
        due = (cfg.update_start <= step <= cfg.update_end
               and (step - cfg.update_start) % cfg.update_freq == 0)
        if not due:
            return masks
        s_global = scheduled_sparsity(cfg, step)
        for leaf in model_leaves(model):
            rel = self.relative_sparsity[leaf.key]
            if rel == 0.0:
                continue
            s_layer = min(max(s_global * np.float32(rel), np.float32(0.0)),
                          np.float32(0.999))
            if cfg.structure == "block":
                masks[leaf.key] = leaf.from_flax(_block_mask_for_leaf(
                    leaf.flax_view(), s_layer, cfg.block_shape))
            else:
                masks[leaf.key] = _mask_for_leaf(leaf.param, s_layer)
        return masks

    def _update_state_masks(self, model: torch.nn.Module, masks: Masks,
                            step: int) -> Masks:
        """Per mixer, channel c scores ||B̄[c, :]|| * ||C[:, c]|| (summed
        over C1 and C2, and over both halves of a bidirectional C) and the
        lowest-scored share is pruned whole: B rows and C columns zero
        together, so the serving engine compacts the channel away."""
        s_global = min(max(scheduled_sparsity(self.cfg, step),
                           np.float32(0.0)), np.float32(0.999))
        by_path = {leaf.path: leaf for leaf in model_leaves(model)}
        for path, b_leaf in by_path.items():
            if path[-1] != "B":
                continue
            c_leaves = [by_path[path[:-1] + (ck,)] for ck in ("C", "C1", "C2")
                        if path[:-1] + (ck,) in by_path]
            if not c_leaves:
                continue
            b = b_leaf.param.detach().to(torch.float32)      # (P, H, 2)
            p = b.shape[0]
            b_score = torch.sqrt((b * b).sum(dim=(1, 2)))
            c_sq = torch.zeros((p,), dtype=torch.float32, device=b.device)
            for c_leaf in c_leaves:
                c = c_leaf.param.detach().to(torch.float32)  # (H, P[*2], 2)
                cs = (c * c).sum(dim=(0, 2))
                if cs.shape[0] == 2 * p:
                    cs = cs[:p] + cs[p:]
                c_sq = c_sq + cs
            keep = _keep(b_score * torch.sqrt(c_sq), _cut(s_global, p))
            masks[b_leaf.key] = keep[:, None, None].expand(b.shape).to(
                b_leaf.param.dtype)
            for c_leaf in c_leaves:
                c = c_leaf.param
                ck = keep if c.shape[1] == p else torch.cat([keep, keep])
                masks[c_leaf.key] = ck[None, :, None].expand(c.shape).to(
                    c.dtype)
        return masks

    def apply_masks(self, model: torch.nn.Module, masks: Masks
                    ) -> Dict[str, torch.Tensor]:
        """The forward weights of the pruned leaves, by the port's parameter
        names (for ``torch.func.functional_call``): ``p * m``, in STE mode
        with the gradient of the identity (``p + (p * m - p).detach()``).
        Empty when pruning is off."""
        if not self.cfg.enabled:
            return {}
        out = {}
        for leaf in model_leaves(model):
            if not _prunable(leaf, self.cfg):
                continue
            p, m = leaf.param, masks[leaf.key]
            masked = p * m
            out[leaf.name] = (p + (masked - p).detach()
                              if self.cfg.mode == "ste" else masked)
        return out

    @torch.no_grad()
    def post_gradient_update(self, model: torch.nn.Module,
                             masks: Masks) -> None:
        """In hard mode, zero the pruned weights in place (after the
        optimizer step); STE keeps the weights dense."""
        if not self.cfg.enabled or self.cfg.mode == "ste":
            return
        for leaf in model_leaves(model):
            leaf.param.mul_(masks[leaf.key])


@torch.no_grad()
def summarize_sparsity(model: torch.nn.Module,
                       masks: Optional[Masks] = None) -> Dict[str, float]:
    """Share of exact zeros per leaf (of the weights times their masks) and
    over all, ``_total_sparsity``."""
    out = {}
    total_zero, total = 0, 0
    for leaf in model_leaves(model):
        w = leaf.param if masks is None else leaf.param * masks[leaf.key]
        nz = int((w == 0).sum())
        out[leaf.key] = nz / w.numel()
        total_zero += nz
        total += w.numel()
    out["_total_sparsity"] = total_zero / max(1, total)
    return out


def masked_state_dict(model: torch.nn.Module, masks: Optional[Masks]
                      ) -> Dict[str, torch.Tensor]:
    """The model's ``state_dict`` with every parameter times its mask (the
    pruned weights zeroed), the model left as it is."""
    state = dict(model.state_dict())
    if masks:
        for leaf in model_leaves(model):
            state[leaf.name] = leaf.param.detach() * masks[leaf.key]
    return state
