"""Experiment logging: metric sinks and model telemetry (counterpart of
``sparsernns_tpu/utils/logging.py``).

:func:`compute_eigenvalue_logs` (the per-layer Λ statistics),
:func:`activation_sparsity` (the share of zero activations of a captured
forward), :func:`gradient_norms`, and the sinks a training run logs its
epochs to: :class:`JsonlSink` (``metrics.jsonl`` and ``best.json`` in a
directory), :class:`WandbSink` (which logs a warning and nothing else
where ``wandb`` is not installed, as the JAX package's does) and
:class:`NullSink`. Only the first process of a ``torch.distributed`` run
writes.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

logger = logging.getLogger("sparsernns_tpu_torch")


def _is_main_process() -> bool:
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def _numpy(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().float().cpu().numpy()
    return np.asarray(value)


def compute_eigenvalue_logs(params) -> Dict[str, float]:
    """Per-layer statistics of the continuous-time eigenvalues Λ: the
    largest and mean |Λ| and the range of Re Λ, as
    ``<path>/eig_mag_max`` … . ``params`` is the JAX-named parameter tree
    (nested dicts, ``weights.to_flax``) or a model, whose tree is taken."""
    if isinstance(params, torch.nn.Module):
        from sparsernns_tpu_torch.weights import to_flax
        params = to_flax(params)[0]
    out: Dict[str, float] = {}

    def visit(tree, prefix):
        if not isinstance(tree, Mapping):
            return
        if "Lambda_re" in tree and "Lambda_im" in tree:
            lr = _numpy(tree["Lambda_re"])
            li = _numpy(tree["Lambda_im"])
            mag = np.abs(lr + 1j * li)
            out[f"{prefix}eig_mag_max"] = float(mag.max())
            out[f"{prefix}eig_mag_mean"] = float(mag.mean())
            out[f"{prefix}eig_re_max"] = float(lr.max())
            out[f"{prefix}eig_re_min"] = float(lr.min())
        for k, v in tree.items():
            if isinstance(v, Mapping):
                visit(v, f"{prefix}{k}/")

    visit(params, "")
    return out


def jax_keystr(key: str) -> str:
    """A key of ``train/steps.capture_intermediates``
    (``encoder.layers_0.pre_s5.0``) as the JAX package's path string of
    the same leaf (``['encoder']['layers_0']['pre_s5'][0]``)."""
    return "".join(f"[{p}]" if p.isdigit() else f"['{p}']"
                   for p in key.split("."))


def activation_sparsity(intermediates: Mapping[str, Any],
                        atol: float = 1e-8) -> Dict[str, float]:
    """Share of activations within ``atol`` of 0, per captured leaf of
    ``capture_intermediates``' dump, keyed by the JAX package's path
    strings."""
    out = {}
    for key, leaf in intermediates.items():
        arr = _numpy(leaf)
        if arr.size > 0:
            out[jax_keystr(key)] = float(np.mean(np.isclose(arr, 0.0,
                                                            atol=atol)))
    return out


def sparsity_key(keystr: str) -> str:
    """A path string as the epoch log names it: ``encoder/layers_0/...``
    (the JAX loop's cleaning)."""
    return keystr.replace("['", "/").replace("']", "").strip("/")


def gradient_norms(grads: Mapping[str, Any]) -> Dict[str, float]:
    """Global gradient norm and one per top-level branch of a nested
    gradient tree (``weights.grads_to_flax``)."""
    def sq(tree) -> float:
        if isinstance(tree, Mapping):
            return sum(sq(v) for v in tree.values())
        return float(np.sum(_numpy(tree).astype(np.float64) ** 2))

    out = {"grad_norm": float(np.sqrt(sq(grads)))}
    for key, sub in grads.items():
        if not isinstance(sub, Mapping) or sub:
            out[f"grad_norm/{key}"] = float(np.sqrt(sq(sub)))
    return out


class MetricsSink:
    """Where a run's epoch metrics go."""

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None):
        raise NotImplementedError

    def log_best(self, metrics: Dict[str, Any]):
        pass

    def finish(self):
        pass

    @property
    def run_id(self) -> Optional[str]:
        return None


class NullSink(MetricsSink):
    def log(self, metrics, step=None):
        pass


class JsonlSink(MetricsSink):
    """One JSON record a call appended to ``<directory>/metrics.jsonl``
    (``_time``, ``_step`` and the metrics as floats where they are
    numbers); the best metrics so far in ``<directory>/best.json``."""

    def __init__(self, directory: str):
        self._active = _is_main_process()
        self.path = os.path.join(directory, "metrics.jsonl")
        if self._active:
            os.makedirs(directory, exist_ok=True)
        self._best: Dict[str, Any] = {}

    def log(self, metrics, step=None):
        if not self._active:
            return
        rec = {"_time": time.time()}
        if step is not None:
            rec["_step"] = int(step)
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def log_best(self, metrics):
        self._best.update(metrics)
        if self._active:
            with open(self.path.replace("metrics.jsonl", "best.json"),
                      "w") as f:
                json.dump({k: float(v) for k, v in self._best.items()}, f)


class WandbSink(MetricsSink):
    """A ``wandb`` run (resumed with ``run_id``). Where ``wandb`` cannot be
    imported or started, a warning is logged and the sink drops every
    metric."""

    def __init__(self, project: str, config: Optional[dict] = None,
                 run_id: Optional[str] = None, name: Optional[str] = None):
        self._run = None
        if not _is_main_process():
            return
        try:
            import wandb
            self._run = wandb.init(
                project=project, config=config, id=run_id, name=name,
                resume="must" if run_id else None)
        except Exception as e:  # not installed, or offline
            logger.warning("wandb unavailable (%s); metrics not logged", e)

    def log(self, metrics, step=None):
        if self._run is not None:
            self._run.log(metrics, step=step)

    def log_best(self, metrics):
        if self._run is not None:
            for k, v in metrics.items():
                self._run.summary[k] = v

    def finish(self):
        if self._run is not None:
            self._run.finish()

    @property
    def run_id(self):
        return self._run.id if self._run is not None else None


def make_sink(kind: str, directory: str = ".", **kw) -> MetricsSink:
    """``"wandb"`` (``kw``: project, config, run_id, name), ``"jsonl"``
    (into ``directory``), anything else :class:`NullSink`."""
    if kind == "wandb":
        return WandbSink(**kw)
    if kind == "jsonl":
        return JsonlSink(directory)
    return NullSink()
