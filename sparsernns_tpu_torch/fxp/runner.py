"""Fixed-point inference / verification / export runner (counterpart of
``sparsernns_tpu/fxp/runner.py``), over the artifacts of the conversion
pipeline (``quantize/convert.py``) in ``<checkpoint_dir>/conversion``,
the port's :class:`~sparsernns_tpu_torch.train.checkpoint.ArtifactStore`
(the JAX package's orbax items are not read):

- :func:`run_inference`: NDNS validation of the integer model, written to
  ``<checkpoint_dir>/fxp_val_metrics.json``;
- :func:`run_verification`: every captured block of the integer model on
  the stored golden inputs against the float model's activation dump,
  reported under ``<checkpoint_dir>/verification``;
- :func:`export_bundle`: the self-describing integer bundle,
  ``weights.npz`` + ``manifest.json`` under ``<checkpoint_dir>/fxp_export``.

Each builds the model on ``device`` (default ``cuda``; the recurrence
then runs the ``fxp_scan`` kernel, one launch per layer).
"""

from __future__ import annotations

import json
import logging
import os
import re
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from sparsernns_tpu_torch.fxp.derive import FxpModelConfig, build_fxp_model
from sparsernns_tpu_torch.fxp.reporter import Reporter
from sparsernns_tpu_torch.quantize.config import quantization_recipes
from sparsernns_tpu_torch.train.checkpoint import ArtifactStore
from sparsernns_tpu_torch.train.loop import build_dataset, prep_ndns_batch
from sparsernns_tpu_torch.train.losses import (STFT_MAG_MEAN,
                                               ndns_loss_from_mask)
from sparsernns_tpu_torch.utils.config import RunConfig

logger = logging.getLogger("sparsernns_tpu_torch")


def _store(cfg: RunConfig) -> ArtifactStore:
    return ArtifactStore(os.path.join(cfg.checkpoint_dir or ".",
                                      "conversion"))


def load_fxp_model(cfg: RunConfig, device="cuda"):
    """Frozen conversion artifacts -> (integer model on ``device``,
    frozen_params, frozen_stats)."""
    store = _store(cfg)
    frozen_params = store.load("frozen_params")
    frozen_stats = store.load("frozen_stats")
    q_config = quantization_recipes[cfg.convert_quantization](
        static_quant=True, calibrating=False)
    model_cfg = FxpModelConfig.infer(
        frozen_params, glu_variant=cfg.glu_variant,
        relufication=cfg.relufication, prenorm=cfg.prenorm,
        clip_eigs=cfg.clip_eigs, conj_sym=cfg.conj_sym,
        discretization=cfg.discretization, topk=cfg.topk,
        approx_topk=cfg.approx_topk)
    model = build_fxp_model(frozen_params, frozen_stats, q_config,
                            model_cfg=model_cfg, device=device)
    return model, frozen_params, frozen_stats


def run_inference(cfg: RunConfig, device="cuda") -> Dict[str, float]:
    """NDNS validation of the integer model: 'Val Loss - fxp', 'Val Acc -
    fxp' (mean SI-SNR) and the loop's wall seconds, also written to
    ``fxp_val_metrics.json``."""
    fxp_model, _, _ = load_fxp_model(cfg, device)
    _, valloader, _, _, _, _, _ = build_dataset(cfg)
    losses, snrs = [], []
    t0 = time.perf_counter()
    for noisy, clean in valloader:
        noisy = torch.as_tensor(noisy, device=device)
        clean = torch.as_tensor(clean, device=device)
        noisy_mag, noisy_phase, clean_mag = prep_ndns_batch(noisy, clean)
        x = (noisy_mag - STFT_MAG_MEAN).transpose(1, 2)
        mask = fxp_model(x).to_float().transpose(1, 2)
        loss, snr, _ = ndns_loss_from_mask(
            mask, noisy_mag, noisy_phase, clean_mag, clean)
        losses.append(float(loss))
        snrs.append(float(snr))
    wall = time.perf_counter() - t0
    metrics = {"Val Loss - fxp": float(np.mean(losses)),
               "Val Acc - fxp": float(np.mean(snrs)),
               "fxp_forward_seconds": wall}
    logger.info("fxp inference: %s", metrics)
    out_path = os.path.join(cfg.checkpoint_dir or ".",
                            "fxp_val_metrics.json")
    with open(out_path, "w") as f:
        json.dump(metrics, f, indent=2)
    return metrics


def _numpy(value):
    if isinstance(value, tuple):
        return tuple(_numpy(v) for v in value)
    return value.detach().cpu().numpy()


def run_verification(cfg: RunConfig, output_dir: Optional[str] = None,
                     device="cuda") -> Dict[str, Any]:
    """Replay the integer model on the stored golden inputs and compare
    every captured block against the float activations. Returns the
    reporter's summary with ``matched_blocks``."""
    fxp_model, _, _ = load_fxp_model(cfg, device)
    store = _store(cfg)
    golden = store.load("activations")
    inputs = store.load("activation_inputs")

    fxp_model.set_store_intermediates(True)
    fxp_model(torch.as_tensor(inputs["x"], device=device))
    fxp_inter = {}
    for name, val in fxp_model.collect_intermediates().items():
        val = _numpy(val)
        if isinstance(val, tuple) and len(val) == 2:  # complex -> re/im
            fxp_inter[f"{name}.re"], fxp_inter[f"{name}.im"] = val
        else:
            fxp_inter[name] = val

    reporter = Reporter(output_dir or os.path.join(
        cfg.checkpoint_dir or ".", "verification"))
    golden_flat = _flatten(golden)
    matched = 0
    for fxp_name, fxp_val in fxp_inter.items():
        gold = _match_block(fxp_name, golden_flat, fxp_val.shape)
        if gold is None:
            continue
        reporter.add_block(fxp_name, gold, fxp_val)
        matched += 1
    path = reporter.write()
    summary = reporter.summary()
    summary["matched_blocks"] = matched
    logger.info("verification: %s -> %s", summary, path)
    return summary


def _flatten(tree, prefix="") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}."))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}."))
    else:
        out[prefix.rstrip(".")] = tree
    return out


#: fxp intermediate suffix -> (golden-name fragments, required ending)
_BLOCK_MAP = {
    "encoder.encoder.output": (("encoder_output",), None),
    "ssm.states.re": (("pre_C",), "0.0"),
    "ssm.states.im": (("pre_C",), "0.1"),
    "ssm.input": (("pre_s5",), None),
    "pre_GLU": (("pre_GLU",), None),
}


def _match_block(fxp_name: str, golden_flat: Dict[str, Any],
                 shape) -> Optional[Any]:
    """Name alignment between the integer module tree and the float dump
    (e.g. 'encoder.layers_0.ssm.states.re' <-> '...layers_0.pre_C.0.0'),
    gated on equal shapes."""
    m = re.search(r"layers_(\d+)", fxp_name)
    layer = m.group(0) if m else None
    for suffix, (gold_frags, ending) in _BLOCK_MAP.items():
        if not fxp_name.endswith(suffix):
            continue
        for gname, gval in golden_flat.items():
            if not all(f in gname for f in gold_frags):
                continue
            if ending is not None and not gname.endswith(ending):
                continue
            if layer is not None and layer not in gname:
                continue
            if layer is None and "layers_" in gname:
                continue
            if np.asarray(gval).shape == tuple(shape):
                return gval
    return None


def export_bundle(cfg: RunConfig, path: Optional[str] = None,
                  device="cuda") -> str:
    """Write the self-describing integer export (int weights + formats):
    ``weights.npz`` and ``manifest.json`` (``format_version`` 1)."""
    fxp_model, _, _ = load_fxp_model(cfg, device)
    bundle = fxp_model.export()
    path = path or os.path.join(cfg.checkpoint_dir or ".", "fxp_export")
    os.makedirs(path, exist_ok=True)

    arrays: Dict[str, np.ndarray] = {}
    manifest: Dict[str, Any] = {"format_version": 1}

    def walk(node, prefix):
        if isinstance(node, dict):
            if "data" in node and isinstance(node["data"], np.ndarray):
                arrays[prefix] = node["data"]
                return {k: v for k, v in node.items() if k != "data"} | {
                    "array": prefix}
            return {k: walk(v, f"{prefix}.{k}" if prefix else k)
                    for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, f"{prefix}.{i}") for i, v in enumerate(node)]
        return node

    manifest["model"] = walk(bundle, "")
    np.savez_compressed(os.path.join(path, "weights.npz"), **arrays)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2, default=str)
    logger.info("exported %d integer tensors to %s", len(arrays), path)
    return path
