"""Hyperparameter search (counterpart of ``sparsernns_tpu/train/tune.py``):
a random search over a configuration space, each trial a whole training
run (``train/loop.train``). The trials draw from ``numpy`` with the
search's seed, so the same seed picks the same configurations as the JAX
package's search."""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Any, Callable, Dict, Optional

import numpy as np

from sparsernns_tpu_torch.utils.config import RunConfig

logger = logging.getLogger("sparsernns_tpu_torch")


def sample_config(base: RunConfig, space: Dict[str, list],
                  rng: np.random.RandomState) -> RunConfig:
    """``base`` with one value of each key of ``space`` drawn from
    ``rng``, in the order of the keys."""
    picks = {k: v[rng.randint(len(v))] for k, v in space.items()}
    return dataclasses.replace(base, **picks)


DEFAULT_SPACE = {
    "ssm_lr_base": [1e-4, 3e-4, 1e-3, 3e-3],
    "lr_factor": [1.0, 2.0, 4.0],
    "p_dropout": [0.0, 0.1, 0.2],
    "weight_decay": [0.0, 0.01, 0.04],
    "bn_momentum": [0.9, 0.95],
}


def tune(base: RunConfig, n_trials: int = 8,
         space: Optional[Dict[str, list]] = None,
         train_fn: Optional[Callable] = None, seed: int = 0,
         device="cuda") -> Dict[str, Any]:
    """``n_trials`` runs of ``train_fn`` (default ``train(cfg, device)``)
    on configurations sampled from ``space`` (default
    :data:`DEFAULT_SPACE`). Returns ``{"best", "trials"}``, one record a
    trial (its sampled values, best validation loss and quality); with
    ``base.checkpoint_dir`` each trial checkpoints into ``trial_<i>``
    there and the result goes to ``tune_results.json``."""
    if train_fn is None:
        from sparsernns_tpu_torch.train.loop import train

        def train_fn(cfg):
            return train(cfg, device=device)
    space = space or DEFAULT_SPACE
    rng = np.random.RandomState(seed)
    trials = []
    best = None
    for i in range(n_trials):
        cfg = sample_config(base, space, rng)
        if base.checkpoint_dir:
            cfg = dataclasses.replace(
                base, **{k: getattr(cfg, k) for k in space},
                checkpoint_dir=os.path.join(base.checkpoint_dir,
                                            f"trial_{i}"))
        out = train_fn(cfg)
        record = {"trial": i,
                  "config": {k: getattr(cfg, k) for k in space},
                  "best_val_loss": out["metadata"]["best_val_loss"],
                  "best_quality": out["metadata"].get("best_si_snr")}
        trials.append(record)
        logger.info("trial %d: %s", i, record)
        if best is None or record["best_val_loss"] < best["best_val_loss"]:
            best = record
    result = {"best": best, "trials": trials}
    if base.checkpoint_dir:
        os.makedirs(base.checkpoint_dir, exist_ok=True)
        with open(os.path.join(base.checkpoint_dir, "tune_results.json"),
                  "w") as f:
            json.dump(result, f, indent=2, default=float)
    return result
