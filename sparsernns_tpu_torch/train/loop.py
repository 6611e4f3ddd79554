"""Training orchestrator: dataset -> model -> epoch loop -> checkpoints
(counterpart of ``sparsernns_tpu/train/loop.py``), for the NDNS task on the
synthetic loader.

:func:`build_model` assembles the model of a :class:`RunConfig` and
:func:`build_dataset` its loaders (shared with the conversion pipeline);
:func:`create_run_state` adds the optimizer, the step count, the dropout
generator and, for a ``cfg.pruning`` recipe, the pruner and its masks;
:func:`run_ndns_epoch` and :func:`validate_ndns` drive one pass over a
loader (with the mask update before each step); :func:`train` is the whole
run: epochs with validation and test passes, the cosine or plateau
schedule, the weight sparsity of a pruned run, latest and best checkpoints,
early stopping and resume. Not ported, and raising where a configuration
asks for them: device meshes, the activation-sparsity capture and
profiling; metrics go to Python ``logging`` only.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Callable, Dict, Optional

import torch

from sparsernns_tpu_torch.data.ndns import create_ndns_dataset
from sparsernns_tpu_torch.models.seq_model import (RegressionModel,
                                                   check_stream_dtype)
from sparsernns_tpu_torch.models.ssm import S5SSM
from sparsernns_tpu_torch.models.ssm_init import (blocked_dplr_init,
                                                  lecun_normal)
from sparsernns_tpu_torch.ops.stft import stft_splitter
from sparsernns_tpu_torch.quantize.config import (QuantizationConfig,
                                                  quantization_recipes)
from sparsernns_tpu_torch.train.checkpoint import CheckpointManager
from sparsernns_tpu_torch.train.optim import (create_optimizer,
                                              extract_learning_rates,
                                              reduce_lr_on_plateau,
                                              set_learning_rates)
from sparsernns_tpu_torch.train.pruning import (MagnitudePruner,
                                                pruning_recipes,
                                                summarize_sparsity)
from sparsernns_tpu_torch.train.state import TrainState, count_params
from sparsernns_tpu_torch.train.steps import (make_mask_update_fn,
                                              make_ndns_eval_step,
                                              make_ndns_train_step)
from sparsernns_tpu_torch.utils.config import RunConfig

logger = logging.getLogger("sparsernns_tpu_torch")


#: the QAT mixer's time block where ``cfg.block_t`` is None (the JAX
#: package's hand-set default; it reads measured ones from
#: ``runs/autotune.json``, which the port does not)
QAT_BLOCK_T = 256


def build_model(cfg: RunConfig, d_input: int, d_output: int,
                training: bool = False, device="cuda",
                seed: Optional[int] = None,
                q_config: Optional[QuantizationConfig] = None,
                scan_mode: Optional[str] = None) -> RegressionModel:
    """The NDNS regression model of ``cfg`` on ``device``, in eval mode
    or, with ``training``, in training mode (batch statistics, dropout
    ``cfg.p_dropout``), with parameters drawn from ``seed`` (default
    ``cfg.seed``) by the JAX package's initializer distributions. Every
    float model trains: prenorm or postnorm, BatchNorm or LayerNorm,
    unidirectional or ``cfg.bidirectional``, with activation top-k
    (``cfg.topk < 1`` with ``cfg.approx_topk``) or without.

    ``q_config`` defaults to ``quantization_recipes[cfg.quantization]()``:
    a dynamic fake-quant recipe (``"w8a16"`` …) builds the
    quantization-aware (QAT) model, which trains and evaluates with
    ``cfg.block_t`` (None: :data:`QAT_BLOCK_T`) as the time block of its
    QAT scans and, with ``cfg.qat_global_scales``, one global state scale
    in the mixer kernel. ``q_config`` with ``static_quant`` builds the
    static-quant model (the calibration model when it is ``calibrating``);
    it runs the sequential scan, so ``scan_mode`` must then be
    ``"sequential"``, as the JAX package's conversion pipeline passes it;
    with ``training`` it finetunes its weights with the scales frozen. The
    float and QAT models run ``"fused"`` (the whole-layer kernel or the
    mixer kernel, whichever the layer admits), ``"pallas"`` (the JAX
    package's name for the stand-alone scan kernel between two matmuls),
    ``"associative"`` (the associative scan in plain PyTorch, with the QAT
    hadamards) or ``"sequential"`` (the step-by-step scan in plain
    PyTorch: the naive scan of the conversion pipeline); the other scan
    modes of the JAX package are not ported.

    A training model takes ``cfg.train_stream_dtype`` as the dtype of the
    stream between its layers (``"bfloat16"``: bf16 where every layer runs
    the whole-layer kernel with BatchNorm, ``models/seq_model.py``); an
    eval model keeps float32, as the JAX package builds it. Another value
    raises ``ValueError``."""
    if cfg.dataset != "ndns":
        raise NotImplementedError(f"dataset {cfg.dataset!r}: only ndns")
    check_stream_dtype(cfg.train_stream_dtype)
    if q_config is None:
        q_config = quantization_recipes[cfg.quantization]()
    scan_mode = scan_mode or cfg.scan_mode
    if q_config.static_quant:
        if scan_mode != "sequential":
            raise NotImplementedError(
                "the static-quant model requantizes the state every step: "
                "build it with scan_mode='sequential'")
    elif scan_mode not in ("fused", "pallas", "associative", "sequential"):
        raise NotImplementedError(
            f"scan_mode {scan_mode!r}: the float and QAT port runs 'fused', "
            "'pallas', 'associative' and 'sequential'")
    gen = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
    init = blocked_dplr_init(cfg.ssm_size_base, cfg.blocks, cfg.conj_sym)
    block_t = QAT_BLOCK_T if cfg.block_t is None else cfg.block_t

    def make_mixer():
        return S5SSM(
            init["Lambda"], init["V"], init["Vinv"], h=cfg.d_model,
            p=init["P"], c_init=cfg.C_init,
            discretization=cfg.discretization, dt_min=cfg.dt_min,
            dt_max=cfg.dt_max, conj_sym=cfg.conj_sym,
            clip_eigs=cfg.clip_eigs, bidirectional=cfg.bidirectional,
            relufication=cfg.relufication, generator=gen,
            q_config=q_config, scan_mode=scan_mode, topk=cfg.topk,
            approx_topk=cfg.approx_topk, block_t=block_t,
            qat_global_scales=cfg.qat_global_scales)

    model = RegressionModel(
        make_mixer, d_input, d_output, cfg.n_layers, cfg.d_model,
        q_config=q_config, quant_input=cfg.quant_input,
        glu_variant=cfg.glu_variant,
        relufication=cfg.relufication, batchnorm=cfg.batchnorm,
        prenorm=cfg.prenorm, dropout=cfg.p_dropout,
        bn_momentum=cfg.bn_momentum, topk=cfg.topk,
        approx_topk=cfg.approx_topk,
        stream_dtype=cfg.train_stream_dtype if training else "float32")
    # dense layers: lecun_normal kernel, zero bias (as in the JAX package)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.Linear):
                k = lecun_normal((mod.in_features, mod.out_features), gen)
                mod.weight.copy_(k.T)
                mod.bias.zero_()
    return model.to(device).train(training)


def build_dataset(cfg: RunConfig):
    """The NDNS loaders of ``cfg`` (seeded with ``cfg.seed``):
    (trainloader, valloader, testloader, n_out, seq_len, d_input,
    train_size), as ``data/ndns.create_ndns_dataset`` returns them. As in
    the JAX package, ``synthetic_data`` False leaves the choice to the
    loader, which takes the synthetic set (the WAV-corpus reader is not
    ported). ``train`` and the conversion pipeline share it."""
    if cfg.dataset != "ndns":
        raise NotImplementedError(f"dataset {cfg.dataset!r}: only ndns")
    return create_ndns_dataset(
        cfg.bsz, seed=cfg.seed, synthetic=True if cfg.synthetic_data else None,
        synthetic_size=cfg.synthetic_size,
        synthetic_length=int(cfg.synthetic_seconds * 16000))


def prep_ndns_batch(noisy: torch.Tensor, clean: torch.Tensor):
    """Audio (B, T) on the device -> (noisy_mag, noisy_phase, clean_mag),
    (B, F, L) each."""
    noisy_mag, noisy_phase = stft_splitter(noisy)
    clean_mag, _ = stft_splitter(clean)
    return noisy_mag, noisy_phase, clean_mag


def _check_ported(cfg: RunConfig) -> None:
    if cfg.mesh_data > 1 or cfg.mesh_model > 1 or cfg.mesh_seq > 1:
        raise NotImplementedError(
            f"mesh ({cfg.mesh_data},{cfg.mesh_model},{cfg.mesh_seq}): "
            "device meshes are not ported yet, training runs on one device")
    if cfg.lr_schedule not in ("cosine", "plateau"):
        raise ValueError(f"lr_schedule {cfg.lr_schedule!r}")


def create_run_state(cfg: RunConfig, model: RegressionModel,
                     steps_per_epoch: int) -> TrainState:
    """Optimizer of ``cfg`` over the model's parameters (schedules sized
    by ``steps_per_epoch * cfg.epochs``), step 0, a dropout generator on
    the model's device seeded with ``cfg.seed`` and, when
    ``pruning_recipes(cfg.epochs, steps_per_epoch)[cfg.pruning]`` prunes,
    its pruner with masks of ones."""
    _check_ported(cfg)
    recipes = pruning_recipes(cfg.epochs, steps_per_epoch)
    if cfg.pruning not in recipes:
        raise ValueError(f"unknown pruning recipe {cfg.pruning!r}")
    prune_cfg = recipes[cfg.pruning]
    pruner = MagnitudePruner(prune_cfg) if prune_cfg.enabled else None
    optimizer = create_optimizer(
        model.named_parameters(), cfg.opt_config, lr=cfg.lr,
        ssm_lr=cfg.ssm_lr_base, weight_decay=cfg.weight_decay,
        total_steps=steps_per_epoch * cfg.epochs,
        warmup_steps=steps_per_epoch * cfg.warmup_end,
        grad_clip_threshold=cfg.grad_clip_threshold,
        dt_global=cfg.dt_global, lr_min=cfg.lr_min,
        schedule="constant" if cfg.lr_schedule == "plateau" else "cosine")
    device = next(model.parameters()).device
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    logger.info("trainable parameters: %d", count_params(model))
    return TrainState(model=model, optimizer=optimizer, step=0,
                      generator=generator,
                      masks=pruner.init_masks(model) if pruner else None,
                      pruner=pruner)


def _place(batch, device):
    return tuple(torch.from_numpy(a).to(device) for a in batch)


def _epoch_means(acc: Dict[str, list], prefix: str = "") -> Dict[str, float]:
    # one host read per metric and epoch, none per step
    return {f"{prefix}{k}": float(torch.stack(v).mean())
            for k, v in acc.items()}


def run_ndns_epoch(state: TrainState, step_fn: Callable, loader,
                   mask_update: Optional[Callable] = None
                   ) -> Dict[str, float]:
    """One pass of ``step_fn`` over ``loader``, each step after
    ``mask_update(state)`` (:func:`make_mask_update_fn`); ``state`` moves
    on in place. Returns the epoch means of the step metrics as
    ``train_<key>``."""
    device = next(state.model.parameters()).device
    acc: Dict[str, list] = {}
    for batch in loader:
        noisy, clean = _place(batch, device)
        if mask_update is not None:
            state = mask_update(state)
        state, metrics = step_fn(state, *prep_ndns_batch(noisy, clean),
                                 clean)
        for k, v in metrics.items():
            acc.setdefault(k, []).append(v)
    return _epoch_means(acc, "train_")


def validate_ndns(model: RegressionModel, eval_fn: Callable, loader
                  ) -> Dict[str, float]:
    """Mean loss and SI-SNR of ``eval_fn`` over ``loader``."""
    device = next(model.parameters()).device
    acc: Dict[str, list] = {}
    for batch in loader:
        noisy, clean = _place(batch, device)
        metrics = eval_fn(*prep_ndns_batch(noisy, clean), clean)
        for k in ("loss", "si_snr"):
            acc.setdefault(k, []).append(metrics[k])
    return _epoch_means(acc)


def train(cfg: RunConfig, device="cuda") -> Dict[str, Any]:
    """Full training run of ``cfg`` (after :meth:`RunConfig.apply_dim_scale`)
    on the synthetic NDNS set. Returns ``{"state", "metadata"}``; with
    ``cfg.checkpoint_dir`` the latest checkpoints go there and the best one
    to ``<dir>/best``, and a run that finds a checkpoint resumes from it
    (``cfg.restore_checkpoint``; with ``cfg.reset_optimizer`` only the
    weights are restored)."""
    cfg = cfg.apply_dim_scale()
    _check_ported(cfg)
    if not cfg.synthetic_data:
        raise NotImplementedError(
            "the WAV-corpus reader is not ported yet: set synthetic_data")
    trainloader, valloader, testloader, n_out, _, d_input, _ = \
        build_dataset(cfg)
    steps_per_epoch = max(1, len(trainloader))
    model = build_model(cfg, d_input, n_out, training=True, device=device)
    state = create_run_state(cfg, model, steps_per_epoch)

    mngr = best_mngr = None
    metadata: Dict[str, Any] = {"best_val_loss": float("inf"),
                                "best_si_snr": -float("inf"),
                                "next_epoch": 0}
    if cfg.checkpoint_dir:
        # the latest checkpoints serve resume; the best epoch has a
        # single-slot manager of its own, so retention never drops it
        mngr = CheckpointManager(cfg.checkpoint_dir)
        best_mngr = CheckpointManager(
            os.path.join(cfg.checkpoint_dir, "best"), max_to_keep=1)
        if cfg.restore_checkpoint:
            if cfg.reset_optimizer:
                state = mngr.restore_params_only(state)
            else:
                state, restored = mngr.restore(state)
                if restored:
                    metadata.update(restored)

    step_fn = make_ndns_train_step(model, microbatch=cfg.microbatch)
    eval_fn = make_ndns_eval_step(model, state.pruner, state.masks)
    mask_update = make_mask_update_fn(state.pruner)
    patience = 0
    for epoch in range(int(metadata.get("next_epoch", 0)), cfg.epochs):
        log = run_ndns_epoch(state, step_fn, trainloader, mask_update)
        val = validate_ndns(model, eval_fn, valloader)
        test = validate_ndns(model, eval_fn, testloader)

        if cfg.lr_schedule == "plateau":
            # the decay state lives in the checkpoint metadata, the live
            # learning rates in the optimizer's param groups
            lr_now = float(metadata.get("plateau_lr", cfg.lr))
            ssm_now = float(metadata.get("plateau_ssm_lr", cfg.ssm_lr_base))
            new_lr, new_ssm, count, best = reduce_lr_on_plateau(
                lr_now, ssm_now, int(metadata.get("plateau_count", 0)),
                val["si_snr"],
                float(metadata.get("plateau_best", -float("inf"))),
                factor=cfg.plateau_factor, patience=cfg.plateau_patience,
                lr_min=cfg.lr_min)
            metadata.update(plateau_lr=new_lr, plateau_ssm_lr=new_ssm,
                            plateau_count=count, plateau_best=best)
            if (new_lr, new_ssm) != (lr_now, ssm_now):
                set_learning_rates(state.optimizer, new_lr, new_ssm)
                logger.info("plateau: lr -> %.3e, ssm_lr -> %.3e",
                            new_lr, new_ssm)

        log.update({f"val_{k}": v for k, v in val.items()})
        log.update({f"test_{k}": v for k, v in test.items()})
        log.update(extract_learning_rates(state.optimizer))
        if state.pruner is not None:
            log["weight_sparsity"] = summarize_sparsity(
                model, state.masks)["_total_sparsity"]
        logger.info("epoch %d: %s", epoch, log)

        improved = val["loss"] < metadata["best_val_loss"]
        if improved:
            metadata.update(best_val_loss=val["loss"],
                            best_si_snr=val["si_snr"], best_epoch=epoch)
            patience = 0
        else:
            patience += 1
        metadata["next_epoch"] = epoch + 1
        metadata["last_log"] = log

        if mngr is not None:
            mngr.save(epoch, state, metadata=metadata)
        if best_mngr is not None and improved:
            best_mngr.save(epoch, state, metadata=metadata)
        if patience >= cfg.early_stop_patience:
            logger.info("early stopping at epoch %d", epoch)
            break
    return {"state": state, "metadata": metadata}
