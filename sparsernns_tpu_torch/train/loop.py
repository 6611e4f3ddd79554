"""Training orchestrator: dataset -> model -> epoch loop -> checkpoints
(counterpart of ``sparsernns_tpu/train/loop.py``), for every dataset of
the JAX package's registry: the NDNS regression task (synthetic, or the
WAV corpus of ``NDNS_{TRAIN,VALIDATION,TEST}_SET``) and the classification
tasks (``synthetic-classification``, ``smnist``, ``psmnist``).

:func:`build_model` assembles the model of a :class:`RunConfig` and
:func:`build_dataset` its loaders (shared with the conversion pipeline);
:func:`create_run_state` adds the optimizer, the step count, the dropout
generator and, for a ``cfg.pruning`` recipe, the pruner and its masks;
:func:`run_ndns_epoch` / :func:`validate_ndns` and
:func:`run_classification_epoch` / :func:`validate_classification` drive
one pass over a loader (with the mask update before each step);
:func:`act_sparsity_metrics` is the per-epoch activation-sparsity capture;
:func:`train` is the whole run: epochs with validation and test passes,
the cosine or plateau schedule, the eigenvalue, weight-sparsity and
activation-sparsity logs, the gradient-norm warning, the metrics sink
(into the checkpoint directory, and nowhere without one), a
``torch.profiler`` trace of the second epoch with ``cfg.profile``, latest
and best checkpoints, early stopping and resume. On a device mesh
(``cfg.mesh_data`` / ``mesh_model`` / ``mesh_seq``, one process a rank,
``parallel/``) every rank runs :func:`train`: its data rank's rows of each
batch, the P-slices of a tensor-parallel model, the time chunks of
``scan_mode="sp"`` (which ``mesh_seq > 1`` sets, as in the JAX package),
with the sink and the checkpoint files written by rank 0. A
classification model on a seq axis raises ``NotImplementedError`` (its
pooling would need the whole sequence).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from sparsernns_tpu_torch.data.ndns import create_ndns_dataset
from sparsernns_tpu_torch.models.seq_model import (ClassificationModel,
                                                   RegressionModel,
                                                   check_stream_dtype)
from sparsernns_tpu_torch.models.ssm import S5SSM
from sparsernns_tpu_torch.models.ssm_init import (blocked_dplr_init,
                                                  lecun_normal)
from sparsernns_tpu_torch.ops.stft import stft_splitter
from sparsernns_tpu_torch.parallel import comms
from sparsernns_tpu_torch.parallel.mesh import (DATA_AXIS, SEQ_AXIS, Mesh,
                                                MeshConfig,
                                                local_data_shard_info,
                                                make_mesh)
from sparsernns_tpu_torch.parallel.sharding import (forward_params,
                                                    seq_bounds,
                                                    shard_train_state,
                                                    whole_model)
from sparsernns_tpu_torch.quantize.config import (QuantizationConfig,
                                                  quantization_recipes)
from sparsernns_tpu_torch.train.checkpoint import CheckpointManager
from sparsernns_tpu_torch.train.losses import STFT_MAG_MEAN
from sparsernns_tpu_torch.train.optim import (create_optimizer,
                                              extract_learning_rates,
                                              reduce_lr_on_plateau,
                                              set_learning_rates)
from sparsernns_tpu_torch.train.pruning import (MagnitudePruner,
                                                pruning_recipes,
                                                summarize_sparsity)
from sparsernns_tpu_torch.train.state import TrainState, count_params
from sparsernns_tpu_torch.train.steps import (
    capture_intermediates, make_classification_eval_step,
    make_classification_train_step, make_mask_update_fn, make_ndns_eval_step,
    make_ndns_train_step)
from sparsernns_tpu_torch.utils.config import RunConfig
from sparsernns_tpu_torch.utils.logging import (activation_sparsity,
                                                compute_eigenvalue_logs,
                                                make_sink, sparsity_key)

logger = logging.getLogger("sparsernns_tpu_torch")


#: the QAT mixer's time block where ``cfg.block_t`` is None (the JAX
#: package's hand-set default; it reads measured ones from
#: ``runs/autotune.json``, which the port does not)
QAT_BLOCK_T = 256

#: the float and QAT scan modes of the port (``S5SSM``)
SCAN_MODES = ("fused", "pallas", "associative", "sequential", "blocked",
              "sp")


def build_model(cfg: RunConfig, d_input: int, d_output: int,
                training: bool = False, device="cuda",
                seed: Optional[int] = None,
                q_config: Optional[QuantizationConfig] = None,
                scan_mode: Optional[str] = None,
                mesh: Optional[Mesh] = None) -> torch.nn.Module:
    """The model of ``cfg`` on ``device``: the NDNS regression model for
    ``cfg.dataset == "ndns"``, else the classification model with
    ``cfg.mode`` pooling; in eval mode or, with ``training``, in training
    mode (batch statistics, dropout ``cfg.p_dropout``), with parameters
    drawn from ``seed`` (default ``cfg.jax_seed``) by the JAX package's
    initializer distributions. Every float model trains: prenorm or
    postnorm, BatchNorm (with or without its scale and bias,
    ``cfg.batchnorm_use_scale`` / ``_bias``, folded into the mixers with
    ``cfg.fuse_batchnorm_linear``) or LayerNorm, unidirectional or
    ``cfg.bidirectional``, with activation top-k (``cfg.topk < 1`` with
    ``cfg.approx_topk``) or without.

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
    hadamards), ``"sequential"`` (the step-by-step scan in plain PyTorch:
    the naive scan of the conversion pipeline) or ``"blocked"`` (the
    block-parallel matmul scan, float only: kernel-free, as in the JAX
    package); or ``"sp"``, the sequence-parallel scan over the seq axis of
    ``mesh``, which a mesh with ``seq > 1`` sets whatever ``scan_mode``
    says, as the JAX package's ``sp_mesh`` does (without such a mesh
    ``"sp"`` raises ``ValueError``; a classification model raises
    ``NotImplementedError`` there). With ``mesh`` the BatchNorm
    statistics of training cover the rows of every data and seq rank.

    A training model takes ``cfg.train_stream_dtype`` as the dtype of the
    stream between its layers (``"bfloat16"``: bf16 where every layer runs
    the whole-layer kernel with BatchNorm, ``models/seq_model.py``); an
    eval model keeps float32, as the JAX package builds it. Another value
    raises ``ValueError``."""
    check_stream_dtype(cfg.train_stream_dtype)
    if q_config is None:
        q_config = quantization_recipes[cfg.quantization]()
    scan_mode = scan_mode or cfg.scan_mode
    seq_mesh = mesh is not None and mesh.size(SEQ_AXIS) > 1
    if seq_mesh and cfg.dataset != "ndns":
        raise NotImplementedError(
            "a classification model on a seq axis: its pooling needs the "
            "whole sequence")
    if seq_mesh:
        scan_mode = "sp"
    elif scan_mode == "sp":
        raise ValueError("scan_mode='sp' requires a mesh with a seq axis "
                         "(mesh_seq > 1)")
    if q_config.static_quant:
        if scan_mode != "sequential":
            raise NotImplementedError(
                "the static-quant model requantizes the state every step: "
                "build it with scan_mode='sequential'")
    elif scan_mode not in SCAN_MODES:
        raise NotImplementedError(
            f"scan_mode {scan_mode!r}: the float and QAT port runs "
            f"{', '.join(repr(m) for m in SCAN_MODES)}")
    gen = torch.Generator().manual_seed(cfg.jax_seed if seed is None
                                        else seed)
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

    common = dict(
        q_config=q_config, quant_input=cfg.quant_input,
        glu_variant=cfg.glu_variant,
        relufication=cfg.relufication, batchnorm=cfg.batchnorm,
        prenorm=cfg.prenorm, dropout=cfg.p_dropout,
        bn_momentum=cfg.bn_momentum, topk=cfg.topk,
        approx_topk=cfg.approx_topk,
        stream_dtype=cfg.train_stream_dtype if training else "float32",
        fuse_batchnorm_linear=cfg.fuse_batchnorm_linear,
        use_batchnorm_scale=cfg.batchnorm_use_scale,
        use_batchnorm_bias=cfg.batchnorm_use_bias)
    args = (make_mixer, d_input, d_output, cfg.n_layers, cfg.d_model)
    if cfg.dataset == "ndns":
        model = RegressionModel(*args, **common)
    else:
        model = ClassificationModel(*args, mode=cfg.mode, **common)
    # dense layers: lecun_normal kernel, zero bias (as in the JAX package)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.Linear):
                k = lecun_normal((mod.in_features, mod.out_features), gen)
                mod.weight.copy_(k.T)
                mod.bias.zero_()
    if mesh is not None:
        for mod in model.modules():
            if hasattr(mod, "stat_group"):
                mod.stat_group = mesh.group((DATA_AXIS, SEQ_AXIS))
            if isinstance(mod, S5SSM) and seq_mesh:
                mod.seq_group = mesh.group(SEQ_AXIS)
    return model.to(device).train(training)


def build_dataset(cfg: RunConfig, num_shards: int = 1, shard_index: int = 0):
    """The loaders of ``cfg.dataset`` (the JAX package's registry), seeded
    with ``cfg.data_seed`` (None: ``cfg.jax_seed``): (trainloader,
    valloader, testloader, n_out, seq_len, d_input, train_size).

    - ``"ndns"``: ``data/ndns.create_ndns_dataset``; ``synthetic_data``
      False leaves the choice to the loader, which reads the WAV corpus
      where ``NDNS_{TRAIN,VALIDATION,TEST}_SET`` are all set and takes the
      synthetic set otherwise;
    - ``"synthetic-classification"``: the synthetic sequence task of
      ``cfg.synthetic_size`` sequences;
    - ``"smnist"`` / ``"psmnist"``: sequential MNIST from the IDX files of
      ``SMNIST_DATA_DIR`` (``FileNotFoundError`` without them), psMNIST
      bit-reversal permuted.

    ``train`` and the conversion pipeline share it."""
    from sparsernns_tpu_torch.data import classification
    data_seed = cfg.jax_seed if cfg.data_seed is None else cfg.data_seed
    shards = dict(num_shards=num_shards, shard_index=shard_index)
    if cfg.dataset == "ndns":
        return create_ndns_dataset(
            cfg.bsz, seed=data_seed,
            synthetic=True if cfg.synthetic_data else None,
            synthetic_size=cfg.synthetic_size,
            synthetic_length=int(cfg.synthetic_seconds * 16000), **shards)
    if cfg.dataset == "synthetic-classification":
        return classification.create_classification_dataset(
            cfg.bsz, seed=data_seed, size=cfg.synthetic_size, **shards)
    if cfg.dataset in ("smnist", "psmnist"):
        return classification.create_smnist_dataset(
            cfg.bsz, permute=cfg.dataset == "psmnist", seed=data_seed,
            **shards)
    raise NotImplementedError(f"dataset {cfg.dataset!r} not registered")


def prep_ndns_batch(noisy: torch.Tensor, clean: torch.Tensor):
    """Audio (B, T) on the device -> (noisy_mag, noisy_phase, clean_mag),
    (B, F, L) each."""
    noisy_mag, noisy_phase = stft_splitter(noisy)
    clean_mag, _ = stft_splitter(clean)
    return noisy_mag, noisy_phase, clean_mag


def _check_config(cfg: RunConfig) -> None:
    if cfg.lr_schedule not in ("cosine", "plateau"):
        raise ValueError(f"lr_schedule {cfg.lr_schedule!r}")


def run_mesh(cfg: RunConfig, device="cuda") -> Optional[Mesh]:
    """The mesh of a run: None on a world of one rank without the mesh
    flags; else ``make_mesh`` of ``cfg.mesh_data`` (-1: the rest of the
    world), ``mesh_model`` and ``mesh_seq`` on ``device``. Mesh flags on
    a world of one rank raise ``ValueError``, as in the JAX package: one
    device would fake a parallel run."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    requested = cfg.mesh_data > 1 or cfg.mesh_model > 1 or cfg.mesh_seq > 1
    if requested and world == 1:
        raise ValueError(
            f"mesh ({cfg.mesh_data},{cfg.mesh_model},{cfg.mesh_seq}) "
            "requested but the world has one rank: start the run with one "
            "process a rank (torchrun); one device would fake the mesh")
    if world == 1:
        return None
    return make_mesh(MeshConfig(data=cfg.mesh_data, model=cfg.mesh_model,
                                seq=cfg.mesh_seq), device=device)


def create_run_state(cfg: RunConfig, model: torch.nn.Module,
                     steps_per_epoch: int,
                     mesh: Optional[Mesh] = None) -> TrainState:
    """Optimizer of ``cfg`` over the model's parameters (schedules sized
    by ``steps_per_epoch * cfg.epochs``), step 0, a dropout generator on
    the model's device seeded with ``cfg.jax_seed`` (on a ``mesh``: with
    (``cfg.jax_seed``, the data rank), so that the data ranks draw other
    masks and the model and seq ranks of one data rank the same) and,
    when ``pruning_recipes(cfg.epochs, steps_per_epoch)[cfg.pruning]``
    prunes, its pruner with masks of ones. The state is whole: the
    caller shards it over ``mesh``
    (``parallel/sharding.shard_train_state``)."""
    _check_config(cfg)
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
    seed = cfg.jax_seed
    if mesh is not None:
        seed = int(np.random.SeedSequence(
            [cfg.jax_seed, local_data_shard_info(mesh)[1]]).generate_state(
                1)[0])
    generator = torch.Generator(device=device).manual_seed(seed)
    logger.info("trainable parameters: %d", count_params(model))
    return TrainState(model=model, optimizer=optimizer, step=0,
                      generator=generator,
                      masks=pruner.init_masks(model) if pruner else None,
                      pruner=pruner)


def _place(batch, device):
    return tuple(torch.from_numpy(a).to(device) for a in batch)


def _place_classification(batch, device):
    """(inputs, labels) of a classification loader on ``device``, the
    labels as int64."""
    xs, ys = batch
    return (torch.from_numpy(xs).to(device),
            torch.from_numpy(ys).to(device=device, dtype=torch.int64))


def _epoch_means(acc: Dict[str, list], prefix: str = "") -> Dict[str, float]:
    # one host read per metric and epoch, none per step
    return {f"{prefix}{k}": float(torch.stack(v).mean())
            for k, v in acc.items()}


def _accumulate(acc: Dict[str, list], metrics: Dict[str, Any]) -> None:
    for k, v in metrics.items():
        acc.setdefault(k, []).append(v)


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
        _accumulate(acc, metrics)
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


def run_classification_epoch(state: TrainState, step_fn: Callable, loader,
                             mask_update: Optional[Callable] = None
                             ) -> Dict[str, float]:
    """One pass of the classification ``step_fn`` over ``loader`` (each
    step after ``mask_update(state)``); ``state`` moves on in place.
    Returns the epoch means as ``train_<key>``, the accuracy as
    ``train_acc`` (the JAX package's historical key)."""
    device = next(state.model.parameters()).device
    acc: Dict[str, list] = {}
    for batch in loader:
        if mask_update is not None:
            state = mask_update(state)
        state, metrics = step_fn(state, *_place_classification(batch,
                                                               device))
        _accumulate(acc, metrics)
    out = _epoch_means(acc, "train_")
    if "train_accuracy" in out:
        out["train_acc"] = out.pop("train_accuracy")
    return out


def validate_classification(model: torch.nn.Module, eval_fn: Callable,
                            loader) -> Dict[str, float]:
    """Mean loss and accuracy of ``eval_fn`` over ``loader``."""
    device = next(model.parameters()).device
    acc: Dict[str, list] = {}
    for batch in loader:
        metrics = eval_fn(*_place_classification(batch, device))
        for k in ("loss", "accuracy"):
            acc.setdefault(k, []).append(metrics[k])
    return _epoch_means(acc)


def act_sparsity_metrics(model: torch.nn.Module, x: torch.Tensor,
                         prefix: str, mesh: Optional[Mesh] = None
                         ) -> Dict[str, float]:
    """Activation-sparsity telemetry of one batch: a captured eval forward
    (``train/steps.capture_intermediates``) reduced to the share of zeros
    of each captured activation, as ``<prefix>/<module path>`` (the JAX
    package's names), and their mean as ``<prefix>/mean``. On a ``mesh``
    the forward runs on the whole weights and, with a seq axis, on this
    rank's time chunk: the shares are this rank's."""
    if mesh is not None and mesh.size(SEQ_AXIS) > 1:
        lo, hi = seq_bounds(x.shape[1], mesh.size(SEQ_AXIS),
                            mesh.index(SEQ_AXIS))
        x = x[:, lo:hi]
    with torch.no_grad():
        params = forward_params(model, mesh)
    _, inter = capture_intermediates(model, x, params)
    out = {f"{prefix}/{sparsity_key(k)}": frac
           for k, frac in activation_sparsity(inter).items()}
    if out:
        out[f"{prefix}/mean"] = sum(out.values()) / len(out)
    return out


def _model_input(loader, is_ndns: bool, device) -> torch.Tensor:
    """The model input of the first batch of ``loader``: the centred
    noisy magnitude (B, L, F) for NDNS, the sequences otherwise."""
    batch = next(iter(loader))
    if is_ndns:
        noisy, clean = _place(batch, device)
        noisy_mag = prep_ndns_batch(noisy, clean)[0]
        return (noisy_mag - STFT_MAG_MEAN).transpose(1, 2)
    return _place_classification(batch, device)[0]


def _mesh_mean(metrics: Dict[str, float], mesh: Optional[Mesh]
               ) -> Dict[str, float]:
    """Epoch means averaged over the data ranks (the seq ranks of a data
    rank hold the same values), equal on every rank afterwards."""
    if mesh is None or not metrics:
        return metrics
    keys = sorted(metrics)
    vals = torch.tensor([metrics[k] for k in keys], dtype=torch.float64,
                        device=mesh.device)
    comms.all_reduce(vals, mesh.group((DATA_AXIS, SEQ_AXIS)))
    vals /= mesh.size((DATA_AXIS, SEQ_AXIS))
    return dict(zip(keys, vals.tolist()))


def train(cfg: RunConfig, device="cuda") -> Dict[str, Any]:
    """Full training run of ``cfg`` (after :meth:`RunConfig.apply_dim_scale`)
    on ``cfg.dataset``. Returns ``{"state", "metadata"}``; with
    ``cfg.checkpoint_dir`` the latest checkpoints go there and the best one
    to ``<dir>/best``, the epoch logs to the ``cfg.logger`` sink in that
    directory, and a run that finds a checkpoint resumes from it
    (``cfg.restore_checkpoint``; with ``cfg.reset_optimizer`` only the
    weights are restored). The quality metric is SI-SNR for NDNS and
    accuracy for classification (kept as ``best_si_snr`` in the metadata,
    as the JAX package keeps it).

    In a process group of several ranks (:func:`run_mesh`; ``device`` is
    then ``"cuda"`` for the card of ``LOCAL_RANK``, or ``"cpu"``) every
    rank calls it: ``cfg.bsz`` is the global batch, each data rank loads
    ``cfg.bsz / mesh_data`` rows of it, and the validation metrics are
    averaged over the data ranks."""
    cfg = cfg.apply_dim_scale()
    _check_config(cfg)
    mesh = run_mesh(cfg, device)
    n_data, i_data = (1, 0) if mesh is None else local_data_shard_info(mesh)
    if mesh is not None:
        device = mesh.device
        if cfg.bsz % n_data:
            raise ValueError(f"batch {cfg.bsz} not divisible by the data "
                             f"axis ({n_data})")
    trainloader, valloader, testloader, n_out, _, d_input, _ = \
        build_dataset(dataclasses.replace(cfg, bsz=cfg.bsz // n_data),
                      num_shards=n_data, shard_index=i_data)
    steps_per_epoch = max(1, len(trainloader))
    model = build_model(cfg, d_input, n_out, training=True, device=device,
                        mesh=mesh)
    state = create_run_state(cfg, model, steps_per_epoch, mesh)
    device = next(model.parameters()).device

    sink = make_sink("none")
    if cfg.checkpoint_dir and (mesh is None or mesh.rank == 0):
        sink = make_sink(cfg.logger, directory=cfg.checkpoint_dir,
                         **({"project": cfg.wandb_project,
                             "config": cfg.to_dict(), "name": cfg.run_name}
                            if cfg.logger == "wandb" else {}))
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
                state, restored = mngr.restore(state, mesh=mesh)
                if restored:
                    metadata.update(restored)
    if mesh is not None:
        state = shard_train_state(state, mesh)

    is_ndns = cfg.dataset == "ndns"
    static_q = quantization_recipes[cfg.quantization]().static_quant
    if is_ndns:
        step_fn = make_ndns_train_step(model, microbatch=cfg.microbatch,
                                       static_quant=static_q)
        eval_fn = make_ndns_eval_step(model, state.pruner, state.masks,
                                      mesh)
        epoch_fn, val_fn = run_ndns_epoch, validate_ndns
    else:
        step_fn = make_classification_train_step(model,
                                                 static_quant=static_q)
        eval_fn = make_classification_eval_step(model, state.pruner,
                                                state.masks, mesh)
        epoch_fn, val_fn = run_classification_epoch, validate_classification
    quality_key = "si_snr" if is_ndns else "accuracy"
    mask_update = make_mask_update_fn(state.pruner)

    # one batch each for the per-epoch activation-sparsity capture
    cap_val = cap_train = None
    if cfg.log_act_sparsity in ("val", "both"):
        cap_val = _model_input(valloader, is_ndns, device)
    if cfg.log_act_sparsity in ("train", "both"):
        cap_train = _model_input(trainloader, is_ndns, device)

    patience = 0
    start_epoch = int(metadata.get("next_epoch", 0))
    for epoch in range(start_epoch, cfg.epochs):
        profiler = None
        if cfg.profile and epoch == start_epoch + 1:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(
                activities=activities,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(
                    cfg.profile_dir))
            profiler.start()
        log = epoch_fn(state, step_fn, trainloader, mask_update)
        val = _mesh_mean(val_fn(model, eval_fn, valloader), mesh)
        test = _mesh_mean(val_fn(model, eval_fn, testloader), mesh)
        if profiler is not None:
            profiler.stop()

        if cfg.lr_schedule == "plateau":
            # the decay state lives in the checkpoint metadata, the live
            # learning rates in the optimizer's param groups
            lr_now = float(metadata.get("plateau_lr", cfg.lr))
            ssm_now = float(metadata.get("plateau_ssm_lr", cfg.ssm_lr_base))
            new_lr, new_ssm, count, best = reduce_lr_on_plateau(
                lr_now, ssm_now, int(metadata.get("plateau_count", 0)),
                val[quality_key],
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
        with whole_model(state):
            log.update(compute_eigenvalue_logs(model))
            if state.pruner is not None:
                log["weight_sparsity"] = summarize_sparsity(
                    model, state.masks)["_total_sparsity"]
        if cap_val is not None:
            log.update(act_sparsity_metrics(model, cap_val,
                                            "act_sparsity_val", mesh))
        if cap_train is not None:
            log.update(act_sparsity_metrics(model, cap_train,
                                            "act_sparsity_train", mesh))

        gn = log.get("train_grad_norm")
        if gn is not None and gn > cfg.grad_norm_warn_threshold:
            detail = {k.split("/", 1)[1]: round(float(v), 3)
                      for k, v in log.items()
                      if k.startswith("train_grad_norm/")}
            logger.warning(
                "epoch %d: gradient norm %.3f exceeds threshold %.1f "
                "(per-branch: %s)", epoch, gn,
                cfg.grad_norm_warn_threshold, detail)

        sink.log(log, step=epoch)
        logger.info("epoch %d: train %.4f val %.4f (%s %.3f)", epoch,
                    log["train_loss"], log["val_loss"], quality_key,
                    val[quality_key])

        improved = val["loss"] < metadata["best_val_loss"]
        if improved:
            metadata.update(best_val_loss=val["loss"],
                            best_si_snr=val[quality_key], best_epoch=epoch)
            sink.log_best({"best_val_loss": val["loss"],
                           "best_quality": val[quality_key]})
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
    sink.finish()
    return {"state": state, "metadata": metadata}
