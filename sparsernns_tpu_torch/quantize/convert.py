"""Post-training quantization / conversion pipeline (counterpart of
``sparsernns_tpu/quantize/convert.py``): stages gated by their flags, in
the JAX package's order,

  restore the checkpoint (its best epoch) -> re-apply the sparsity masks
  -> [validate_baseline] -> [store_activations] -> [validate_naive_scan]
  -> [validate_aqt] -> [train_aqt: QAT finetuning] -> [calibrate_quant:
  observers over the validation set, frozen scales] ->
  [validate_static_quant] -> [validate_engine] -> [train_static_quant:
  finetuning with the scales frozen]

over the synthetic NDNS loader (``train/loop.build_dataset``). Artifacts
go to an :class:`~sparsernns_tpu_torch.train.checkpoint.ArtifactStore`
under ``<checkpoint_dir>/conversion`` (``activations``,
``activation_inputs``, ``frozen_params``, ``frozen_stats``,
``qaft_params``) and the validation metrics to
``<checkpoint_dir>/val_metrics.json``; without a ``checkpoint_dir``
nothing is written (the JAX package writes into the working directory).
:func:`engine_from_frozen` builds the serving engine of a frozen tree,
which ``W8A16Engine.from_artifacts`` reads back from the store.
"""

from __future__ import annotations

import contextlib
import copy
import json
import logging
import os
import re
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from sparsernns_tpu_torch.fxp.derive import FxpModelConfig
from sparsernns_tpu_torch.ops.stft import stft_splitter
from sparsernns_tpu_torch.quantize.calibrate import calibrate
from sparsernns_tpu_torch.quantize.config import quantization_recipes
from sparsernns_tpu_torch.quantize.engine import W8A16Engine
from sparsernns_tpu_torch.quantize.static import \
    merge_trained_params_into_calibrated
from sparsernns_tpu_torch.train.checkpoint import (ArtifactStore,
                                                   CheckpointManager)
from sparsernns_tpu_torch.train.loop import (build_dataset, build_model,
                                             create_run_state,
                                             run_ndns_epoch, validate_ndns)
from sparsernns_tpu_torch.train.losses import (STFT_MAG_MEAN,
                                               ndns_loss_from_mask_tm)
from sparsernns_tpu_torch.train.optim import create_optimizer
from sparsernns_tpu_torch.train.pruning import Masks, model_leaves
from sparsernns_tpu_torch.train.state import TrainState
from sparsernns_tpu_torch.train.steps import (capture_intermediates,
                                              make_ndns_eval_step,
                                              make_ndns_train_step)
from sparsernns_tpu_torch.utils.config import RunConfig
from sparsernns_tpu_torch.weights import flat_leaves, from_flax, to_flax

logger = logging.getLogger("sparsernns_tpu_torch")

#: callables ``(stage, seconds, results)`` told when each stage of
#: :func:`convert` has run, in order (the stage names are the keys of its
#: results, plus "restore" and "calibrate"): the stage's wall time, the
#: device synchronized, and the results so far
stage_listeners: List[Callable[[str, float, Dict[str, Any]], None]] = []

#: result keys that are not metrics: kept out of ``val_metrics.json``
_TREES = ("frozen_params", "frozen_stats")


def engine_from_frozen(cfg: RunConfig, frozen_params, frozen_stats,
                       device="cuda", **engine_kw) -> W8A16Engine:
    """The serving engine of ``cfg`` over a frozen tree."""
    q_config = quantization_recipes[cfg.convert_quantization](
        static_quant=True, calibrating=False)
    model_cfg = FxpModelConfig.infer(
        frozen_params, glu_variant=cfg.glu_variant,
        relufication=cfg.relufication, prenorm=cfg.prenorm,
        clip_eigs=cfg.clip_eigs, conj_sym=cfg.conj_sym,
        discretization=cfg.discretization, topk=cfg.topk,
        approx_topk=cfg.approx_topk)
    kw = dict(block_t=cfg.block_t, mxu16=cfg.engine_mxu16,
              route=cfg.engine_route, device=device)
    kw.update(engine_kw)
    return W8A16Engine(frozen_params, frozen_stats, q_config, model_cfg,
                       **kw)


def _features(noisy, clean, device):
    """Host audio -> (noisy_mag, noisy_phase, clean_mag, clean) on
    ``device``, spectra (B, F, L)."""
    noisy = torch.as_tensor(noisy, device=device)
    clean = torch.as_tensor(clean, device=device)
    noisy_mag, noisy_phase = stft_splitter(noisy)
    clean_mag, _ = stft_splitter(clean)
    return noisy_mag, noisy_phase, clean_mag, clean


def _validate_engine(engine: W8A16Engine, loader, device) -> Dict[str, float]:
    losses, snrs = [], []
    for noisy, clean in loader:
        noisy_mag, noisy_phase, clean_mag, clean = _features(noisy, clean,
                                                             device)
        noisy_mag_tm = noisy_mag.transpose(1, 2)
        loss, snr, _ = ndns_loss_from_mask_tm(
            engine(noisy_mag_tm - STFT_MAG_MEAN), noisy_mag_tm,
            noisy_phase.transpose(1, 2), clean_mag.transpose(1, 2), clean)
        losses.append(float(loss))
        snrs.append(float(snr))
    return {"loss": float(np.mean(losses)), "si_snr": float(np.mean(snrs))}


def _restore(directory: str, state: TrainState) -> TrainState:
    """The latest checkpoint of ``directory`` into ``state``, then, where
    its metadata names another best epoch, that epoch: from the main stack
    while it is kept there, else from the single-slot ``<dir>/best``."""
    mngr = CheckpointManager(directory)
    step = mngr.latest_step()
    metadata = None
    if step is not None:
        state, metadata = mngr.restore(state, step)
    best = (metadata or {}).get("best_epoch")
    if best is not None and best != step:
        best_dir = os.path.join(directory, "best")
        if best in mngr.all_steps():
            state, _ = mngr.restore(state, best)
            step = best
        elif os.path.isdir(best_dir):
            best_mngr = CheckpointManager(best_dir, max_to_keep=1)
            if best_mngr.latest_step() is not None:
                step = best_mngr.latest_step()
                state, _ = best_mngr.restore(state, step)
    if step is not None:
        logger.info("restored checkpoint step %s", step)
    return state


@torch.no_grad()
def _apply_masks(model: torch.nn.Module, masks: Optional[Masks]) -> None:
    """Every parameter times its mask, in place."""
    for leaf in model_leaves(model) if masks else ():
        if leaf.key in masks:
            leaf.param.mul_(masks[leaf.key])


def _nested(items) -> Dict[str, Any]:
    """(path, leaf) pairs -> a nested dict."""
    tree: Dict[str, Any] = {}
    for (*path, name), leaf in items:
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[name] = leaf
    return tree


def _finetune_state(cfg: RunConfig, model, state: TrainState,
                    steps_per_epoch: int, fresh: bool) -> TrainState:
    """A train state for ``model`` carrying ``state``'s weights' step count
    and masks (with ones for leaves the masks lack), and either
    ``state``'s optimizer state (``fresh`` False) or a fresh optimizer
    whose schedule starts at the step count (``fresh``: the JAX package's
    ``TrainState.create`` over the frozen tree, whose optax state starts
    its schedule again), a dropout generator seeded with
    ``cfg.jax_seed + 1``."""
    optimizer = create_optimizer(
        model.named_parameters(), cfg.opt_config, lr=cfg.lr,
        ssm_lr=cfg.ssm_lr_base, weight_decay=cfg.weight_decay,
        total_steps=steps_per_epoch * cfg.epochs,
        warmup_steps=steps_per_epoch * cfg.warmup_end,
        grad_clip_threshold=cfg.grad_clip_threshold,
        dt_global=cfg.dt_global, lr_min=cfg.lr_min,
        schedule="constant" if cfg.lr_schedule == "plateau" else "cosine")
    if fresh:
        for group in optimizer.param_groups:
            group["schedule_start"] = int(state.step)
    else:
        optimizer.load_state_dict(state.optimizer.state_dict())
    masks = None
    if state.masks is not None:
        # as the JAX package's convert: the trained masks over ones for
        # every leaf of the new model, merged by their JAX leaf paths
        leaves = model_leaves(model)
        ones = _nested((leaf.path, torch.ones_like(leaf.param))
                       for leaf in leaves)
        trained = _nested((tuple(re.findall(r"\['([^']*)'\]", key)), mask)
                          for key, mask in state.masks.items())
        merged = dict(flat_leaves(
            merge_trained_params_into_calibrated(trained, ones)))
        masks = {leaf.key: merged[leaf.path] for leaf in leaves}
    device = next(model.parameters()).device
    generator = torch.Generator(device=device).manual_seed(cfg.jax_seed + 1)
    return TrainState(model=model, optimizer=optimizer, step=int(state.step),
                      generator=generator, masks=masks, pruner=state.pruner)


def _finetune(state: TrainState, trainloader, valloader, epochs: int,
              static_quant: bool) -> Dict[str, Any]:
    """Epochs of the standard train step over ``trainloader`` with the
    masks frozen, each followed by a validation pass. Returns
    ``{"state", "history"}``, one dict of train and ``val_`` metrics an
    epoch."""
    step_fn = make_ndns_train_step(state.model, static_quant=static_quant)
    eval_fn = make_ndns_eval_step(state.model, state.pruner, state.masks)
    history = []
    for epoch in range(epochs):
        metrics = run_ndns_epoch(state, step_fn, trainloader)
        val = validate_ndns(state.model, eval_fn, valloader)
        history.append({**metrics, **{f"val_{k}": v for k, v in val.items()}})
        logger.info("qaft epoch %d: %s", epoch, history[-1])
    return {"state": state, "history": history}


def convert(cfg: RunConfig, model: Optional[torch.nn.Module] = None,
            masks: Optional[Masks] = None, device="cuda") -> Dict[str, Any]:
    """Run the stages of ``cfg`` (after :meth:`RunConfig.apply_dim_scale`).

    Without ``model`` the float model is built on ``device`` and the
    latest checkpoint of ``cfg.checkpoint_dir`` is restored into it (its
    best epoch, see :func:`_restore`), with its masks. With ``model`` (a
    float model of ``cfg``, on its own device) a copy of it is converted,
    with its weights times the pruning ``masks`` (a pruned run's
    ``TrainState.masks``); the model itself is left as it is.

    Returns the JAX package's result keys for the stages that ran
    (``baseline``, ``store_activations``, ``naive_scan``, ``qat``,
    ``qaft``, ``calibrated``, ``static_quant``, ``engine``,
    ``qaft_static``; the finetuning stages as ``{"history": [...]}``),
    plus ``frozen_params`` / ``frozen_stats`` (nested dicts of numpy
    arrays) when calibration ran."""
    cfg = cfg.apply_dim_scale()
    results: Dict[str, Any] = {}
    trainloader, valloader, _, n_out, _, d_input, _ = build_dataset(cfg)
    steps_per_epoch = max(1, len(trainloader))
    q_recipe = quantization_recipes[cfg.convert_quantization]

    @contextlib.contextmanager
    def stage(name: str):
        t0 = time.perf_counter()
        yield
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
        logger.info("stage %s: %.3f s", name, seconds)
        for listener in stage_listeners:
            listener(name, seconds, results)

    with stage("restore"):
        if model is None:
            fp_model = build_model(cfg, d_input, n_out, device=device)
            state = create_run_state(cfg, fp_model, steps_per_epoch)
            if cfg.checkpoint_dir:
                state = _restore(cfg.checkpoint_dir, state)
            if state.pruner is None:
                state.masks = None
        else:
            device = next(model.parameters()).device
            fp_model = copy.deepcopy(model).eval()
            state = create_run_state(cfg, fp_model, steps_per_epoch)
            state.masks = masks
        # conversion sees the pruned weights
        _apply_masks(fp_model, state.masks)

    store = (ArtifactStore(os.path.join(cfg.checkpoint_dir, "conversion"))
             if cfg.checkpoint_dir else None)

    def variant(**kw):
        """A model of ``cfg`` with the current weights of ``state``."""
        m = build_model(cfg, d_input, n_out, device=device, **kw)
        m.load_state_dict(state.model.state_dict())
        return m

    def validate(m):
        return validate_ndns(m, make_ndns_eval_step(m), valloader)

    if cfg.validate_baseline:
        with stage("baseline"):
            results["baseline"] = validate(fp_model)
        logger.info("baseline: %s", results["baseline"])

    if cfg.store_activations:
        with stage("store_activations"):
            noisy, clean = next(iter(valloader))
            noisy_mag = _features(noisy, clean, device)[0]
            x = (noisy_mag - STFT_MAG_MEAN).transpose(1, 2)
            _, inter = capture_intermediates(fp_model, x)
            if store is not None:
                store.save("activations", inter)
                store.save("activation_inputs", {
                    "x": x.cpu().numpy(), "noisy": np.asarray(noisy),
                    "clean": np.asarray(clean)})
            results["store_activations"] = {"n": len(inter)}

    if cfg.validate_naive_scan:
        with stage("naive_scan"):
            results["naive_scan"] = validate(variant(scan_mode="sequential"))
        logger.info("naive scan: %s", results["naive_scan"])

    # the QAT stages run the associative scan, as in the JAX package: the
    # fused kernels skip the in-scan activation fake-quant that
    # calibration and serving apply
    if cfg.validate_aqt:
        with stage("qat"):
            results["qat"] = validate(variant(q_config=q_recipe(),
                                              scan_mode="associative"))
        logger.info("QAT fake-quant: %s", results["qat"])
    if cfg.train_aqt:
        with stage("qaft"):
            qat_train = variant(training=True, q_config=q_recipe(),
                                scan_mode="associative")
            results["qaft"] = _finetune(
                _finetune_state(cfg, qat_train, state, steps_per_epoch,
                                fresh=False),
                trainloader, valloader, cfg.qaft_epochs, static_quant=False)
            state = results["qaft"].pop("state")

    frozen_params = frozen_stats = None
    if cfg.calibrate_quant:
        with stage("calibrate"):
            cal_model = build_model(
                cfg, d_input, n_out, device=device,
                q_config=q_recipe(static_quant=True, calibrating=True),
                scan_mode="sequential")

            def batches():
                for noisy, clean in valloader:
                    noisy_mag = _features(noisy, clean, device)[0]
                    yield (noisy_mag - STFT_MAG_MEAN).transpose(1, 2)

            frozen_params, frozen_stats = calibrate(
                cal_model, state.model.state_dict(), batches())
            if store is not None:
                store.save("frozen_params", frozen_params)
                store.save("frozen_stats", frozen_stats)
            results.update(calibrated=True, frozen_params=frozen_params,
                           frozen_stats=frozen_stats)

    sq_config = q_recipe(static_quant=True, calibrating=False)
    if cfg.validate_static_quant and frozen_params is not None:
        with stage("static_quant"):
            sq_model = build_model(cfg, d_input, n_out, device=device,
                                   q_config=sq_config, scan_mode="sequential")
            sq_model.load_state_dict(from_flax(frozen_params, frozen_stats))
            results["static_quant"] = validate(sq_model)
        logger.info("static quant: %s", results["static_quant"])
        if cfg.checkpoint_dir:
            with open(os.path.join(cfg.checkpoint_dir, "val_metrics.json"),
                      "w") as f:
                json.dump({k: v for k, v in results.items()
                           if isinstance(v, dict) and k not in _TREES},
                          f, indent=2, default=float)

    if cfg.validate_engine and frozen_params is not None:
        with stage("engine"):
            engine = engine_from_frozen(cfg, frozen_params, frozen_stats,
                                        device=device)
            results["engine"] = _validate_engine(engine, valloader, device)
        logger.info("w8a16 engine: %s", results["engine"])

    if cfg.train_static_quant and frozen_params is not None:
        with stage("qaft_static"):
            sq_train = build_model(cfg, d_input, n_out, training=True,
                                   device=device, q_config=sq_config,
                                   scan_mode="sequential")
            sq_train.load_state_dict(from_flax(frozen_params, frozen_stats))
            # a fresh optimizer over the frozen tree; the step count goes on
            results["qaft_static"] = _finetune(
                _finetune_state(cfg, sq_train, state, steps_per_epoch,
                                fresh=True),
                trainloader, valloader, cfg.qaft_epochs, static_quant=True)
            new_state = results["qaft_static"].pop("state")
            if store is not None:
                store.save("qaft_params", to_flax(new_state.model)[0])
    return results
