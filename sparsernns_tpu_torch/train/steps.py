"""Train and eval steps (counterpart of ``sparsernns_tpu/train/steps.py``):
the NDNS steps (``make_ndns_train_step`` with its microbatch form,
``make_ndns_eval_step``), the classification steps
(``make_classification_train_step``, ``make_classification_eval_step``),
``_forward_params``, ``make_mask_update_fn`` and
``capture_intermediates``.

The train step updates the model, the optimizer and the state's step count
in place (the JAX step returns a new immutable state; here the tensors are
owned by the model and the optimizer) and returns the same state object.
With pruning the model runs on its masked weights
(``torch.func.functional_call`` with the pruner's forward weights: the
parameters are swapped for the call, the BatchNorm buffers stay the
module's and move in place).

On a device mesh (``state.mesh``, ``parallel/``) a step is one rank's
part of the step: the forward runs on the whole weights gathered from the
model ranks' P-slices, a sequence-parallel model on this rank's time
chunk with the mask gathered whole for the loss, and the gradients and
metrics are averaged over the data ranks (summed over the seq ranks) in
one all-reduce before the norms and the update, which see the whole
gradient as the JAX package's partitioned step does.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from sparsernns_tpu_torch.parallel import comms
from sparsernns_tpu_torch.parallel.mesh import MODEL_AXIS, SEQ_AXIS
from sparsernns_tpu_torch.parallel.sharding import (forward_params,
                                                    grad_square_sums,
                                                    reduce_gradients,
                                                    seq_bounds, whole_model)
from sparsernns_tpu_torch.train.losses import (STFT_MAG_MEAN, accuracy,
                                               cross_entropy_loss,
                                               ndns_loss_from_mask_tm)
from sparsernns_tpu_torch.train.optim import (optimizer_step,
                                              scale_gradient_leak_norm,
                                              zero_scale_gradients)
from sparsernns_tpu_torch.train.pruning import MagnitudePruner, Masks
from sparsernns_tpu_torch.train.state import TrainState
from sparsernns_tpu_torch.utils.trace import span


def _forward_params(model, pruner: Optional[MagnitudePruner],
                    masks: Optional[Masks], mesh=None
                    ) -> Dict[str, torch.Tensor]:
    """The forward weights that replace the model's own, by name: the
    masked weights of the pruned parameters, and on a tensor-parallel mesh
    the whole P-sharded parameters (gathered from the slices); empty
    without either."""
    params = {}
    if pruner is not None and pruner.cfg.enabled and masks is not None:
        params = pruner.apply_masks(model, masks)
    return forward_params(model, mesh, params)


def make_mask_update_fn(pruner: Optional[MagnitudePruner]) -> Callable:
    """Per-step mask refresh, gated on the host against the schedule, so
    the masks are recomputed on due steps only. The host step counter starts
    from ``state.step`` (resume-safe) and then counts calls: the epoch
    loop calls this once per optimizer step, before the step."""
    if pruner is None or not pruner.cfg.enabled:
        return lambda state: state
    cfg = pruner.cfg
    counter = {"step": None}

    def maybe_update(state: TrainState) -> TrainState:
        if counter["step"] is None:
            counter["step"] = int(state.step)
        step = counter["step"]
        counter["step"] = step + 1
        if (cfg.update_start <= step <= cfg.update_end
                and (step - cfg.update_start) % cfg.update_freq == 0):
            # on a tensor-parallel mesh the magnitudes are the whole
            # tensors' and every model rank keeps its slice of the masks
            with span("train.masks"), whole_model(state):
                pruner.update_masks(state.model, state.masks, step)
        return state

    return maybe_update


def _loss(model, generator, noisy_mag, noisy_phase, clean_mag, clean,
          params: Optional[Dict[str, torch.Tensor]] = None, mesh=None):
    """(loss, mean SI-SNR) of one (micro)batch. The whole loss path runs
    time-major (B, L, F), the model's own layout; the spectra are
    transposed once here (only the mask carries gradients). ``params``
    replace the model's parameters of those names for the call. On a
    mesh with a seq axis the model sees this rank's time chunk and its
    mask is gathered whole for the loss (iSTFT and SI-SNR need the clip),
    which every seq rank then computes alike."""
    noisy_mag_tm = noisy_mag.transpose(1, 2)
    x = noisy_mag_tm - STFT_MAG_MEAN
    n_seq = 1 if mesh is None else mesh.size(SEQ_AXIS)
    if n_seq > 1:
        lo, hi = seq_bounds(x.shape[1], n_seq, mesh.index(SEQ_AXIS))
        x = x[:, lo:hi]
    out = (functional_call(model, params, (x, generator)) if params
           else model(x, generator))
    if n_seq > 1:
        out = comms.gather_cat(out, mesh.group(SEQ_AXIS), dim=1,
                               length=noisy_mag_tm.shape[1])
    loss, snr, _ = ndns_loss_from_mask_tm(
        out, noisy_mag_tm, noisy_phase.transpose(1, 2),
        clean_mag.transpose(1, 2), clean)
    return loss, snr


def _grad_norm_metrics(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Global gradient norm and one per top-level branch of the model
    (``grad_norm/encoder``, ``grad_norm/decoder``)."""
    squares: Dict[str, torch.Tensor] = {}
    for name, param in model.named_parameters():
        if param.grad is None:
            continue
        branch = name.split(".")[0]
        sq = (param.grad * param.grad).sum()
        squares[branch] = squares[branch] + sq if branch in squares else sq
    out = {f"grad_norm/{k}": torch.sqrt(v) for k, v in squares.items()}
    out["grad_norm"] = torch.sqrt(sum(squares.values()))
    return out


def _reduce_and_norms(state: TrainState, metrics: Dict[str, torch.Tensor]):
    """On a mesh: the gradients and ``metrics`` averaged over the data
    ranks, then the norm metrics of the whole gradient and, with tensor
    parallelism, each param group's norm for the clip. Returns (metrics
    with the norms, group norms or None)."""
    model, mesh = state.model, state.mesh
    if mesh is None:
        return {**metrics, **_grad_norm_metrics(model)}, None
    metrics = reduce_gradients(model, mesh, metrics)
    if mesh.size(MODEL_AXIS) == 1:
        return {**metrics, **_grad_norm_metrics(model)}, None
    labels = {p: g["label"] for g in state.optimizer.param_groups
              for p in g["params"]}
    sums = grad_square_sums(model, mesh, lambda name, p: (
        name.split(".")[0], ("label", labels[p])))
    branches = {k: v for k, v in sums.items() if isinstance(k, str)}
    out = {f"grad_norm/{k}": torch.sqrt(v) for k, v in branches.items()}
    out["grad_norm"] = torch.sqrt(sum(branches.values()))
    norms = {k[1]: torch.sqrt(v) for k, v in sums.items()
             if isinstance(k, tuple)}
    return {**metrics, **out}, norms


def make_ndns_train_step(model: torch.nn.Module,
                         microbatch: Optional[int] = None,
                         static_quant: bool = False) -> Callable:
    """NDNS denoising train step: ``step(state, noisy_mag, noisy_phase,
    clean_mag, clean)`` -> ``(state, metrics)``. Spectra are (B, F, L) as
    :func:`~sparsernns_tpu_torch.ops.stft.stft_splitter` gives them, clean
    audio (B, T); metrics are 0-dim tensors on the model's device:
    ``loss``, ``si_snr``, ``grad_norm`` and ``grad_norm/<branch>``.

    ``microbatch``: gradient-accumulation microbatch size. The batch is
    split into B / microbatch chunks that run one after the other; the
    gradients are their sum / k, which for equal chunks of a batch-mean
    loss is the full-batch mean gradient, and one optimizer update follows.
    BatchNorm normalizes each chunk with its own statistics and moves the
    running statistics chunk by chunk; dropout draws fresh masks per
    chunk. The dropout masks come from ``state.generator``, which moves on
    with every draw, so every step sees other masks.

    With ``state.pruner`` the forward sees the weights times
    ``state.masks`` (STE: the gradient reaches the dense weights whole);
    in hard mode the pruned weights are zeroed after the update.

    ``static_quant`` (the finetuning of a static-quant model): the metrics
    add ``scale_grad_leak``, the gradient mass on quantization-scale
    parameters before they are zeroed. The port keeps the scales as
    buffers, out of every param group, so it is 0 unless a scale became a
    parameter."""

    def step(state: TrainState, noisy_mag, noisy_phase, clean_mag, clean):
        if state.model is not model:
            raise ValueError("the state holds another model than the step")
        batch = noisy_mag.shape[0]
        size = batch if microbatch is None else microbatch
        if batch % size:
            raise ValueError(
                f"batch {batch} not divisible by microbatch {size}")
        k = batch // size
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        losses, snrs = [], []
        for i in range(k):
            rows = slice(i * size, (i + 1) * size)
            with span("train.forward"):
                loss, snr = _loss(model, state.generator, noisy_mag[rows],
                                  noisy_phase[rows], clean_mag[rows],
                                  clean[rows],
                                  _forward_params(model, state.pruner,
                                                  state.masks, state.mesh),
                                  state.mesh)
            with span("train.backward"):
                loss.backward()         # .grad accumulates the sum
            losses.append(loss.detach())
            snrs.append(snr.detach())
        with span("train.reduce"):
            if k > 1:
                for param in model.parameters():
                    if param.grad is not None:
                        param.grad.div_(k)
            metrics, norms = _reduce_and_norms(state, {
                "loss": torch.stack(losses).mean(),
                "si_snr": torch.stack(snrs).mean()})
        with span("train.optimizer"):
            if static_quant:
                metrics["scale_grad_leak"] = scale_gradient_leak_norm(model)
                zero_scale_gradients(model)
            optimizer_step(state.optimizer, state.step, norms)
            if state.pruner is not None:
                state.pruner.post_gradient_update(model, state.masks)
        state.step += 1
        return state, metrics

    return step


def make_ndns_eval_step(model: torch.nn.Module,
                        pruner: Optional[MagnitudePruner] = None,
                        masks: Optional[Masks] = None,
                        mesh=None) -> Callable:
    """Returns ``step(noisy_mag, noisy_phase, clean_mag, clean)`` ->
    ``{"loss", "si_snr"}`` (0-dim tensors). Spectra are (B, F, L) as
    :func:`~sparsernns_tpu_torch.ops.stft.stft_splitter` gives them; the
    model runs in eval mode on its own device (a model in training mode is
    switched to eval for the call and back), with ``pruner`` on its
    weights times ``masks`` as they are at the call, on ``mesh`` as the
    train step runs (this rank's rows; the metrics are this rank's)."""

    @torch.no_grad()
    def step(noisy_mag, noisy_phase, clean_mag, clean
             ) -> Dict[str, torch.Tensor]:
        was_training = model.training
        model.eval()
        try:
            loss, snr = _loss(model, None, noisy_mag, noisy_phase,
                              clean_mag, clean,
                              _forward_params(model, pruner, masks, mesh),
                              mesh)
        finally:
            model.train(was_training)
        return {"loss": loss, "si_snr": snr}

    return step


def _call(model, params: Dict[str, torch.Tensor], inputs, generator):
    """The model's forward on ``inputs`` (a tensor, or ``(x, lengths)`` for
    a padded head), with ``params`` in place of the model's parameters of
    those names where there are any."""
    if params:
        return functional_call(model, params, (inputs, generator))
    return model(inputs, generator)


def make_classification_train_step(model: torch.nn.Module,
                                   static_quant: bool = False) -> Callable:
    """Classification train step: ``step(state, inputs, labels)`` ->
    ``(state, metrics)``. ``inputs`` are (B, L, d_input), or
    ``(x, lengths)`` for a padded head; ``labels`` (B,) integers. Metrics
    are 0-dim tensors on the model's device: ``loss`` (the cross entropy of
    the log-probabilities), ``accuracy``, ``grad_norm`` and
    ``grad_norm/<branch>``. Dropout masks come from ``state.generator``;
    with ``state.pruner`` the forward sees the masked weights (STE), and
    in hard mode the pruned weights are zeroed after the update.
    ``static_quant`` (finetuning a static-quant model) zeroes the
    gradients of the quantization scales before the update, as the JAX
    step does (it reports no leak metric here)."""

    def step(state: TrainState, inputs, labels):
        if state.model is not model:
            raise ValueError("the state holds another model than the step")
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        with span("train.forward"):
            logits = _call(model, _forward_params(model, state.pruner,
                                                  state.masks, state.mesh),
                           inputs, state.generator)
            loss = cross_entropy_loss(logits, labels)
        with span("train.backward"):
            loss.backward()
        with span("train.reduce"):
            metrics, norms = _reduce_and_norms(state, {
                "loss": loss.detach(),
                "accuracy": accuracy(logits.detach(), labels)})
        with span("train.optimizer"):
            if static_quant:
                zero_scale_gradients(model)
            optimizer_step(state.optimizer, state.step, norms)
            if state.pruner is not None:
                state.pruner.post_gradient_update(model, state.masks)
        state.step += 1
        return state, metrics

    return step


def make_classification_eval_step(model: torch.nn.Module,
                                  pruner: Optional[MagnitudePruner] = None,
                                  masks: Optional[Masks] = None,
                                  mesh=None) -> Callable:
    """Returns ``step(inputs, labels)`` -> ``{"loss", "accuracy"}`` (0-dim
    tensors): the model in eval mode (switched for the call and back),
    with ``pruner`` on its weights times ``masks``, on the whole weights
    of a tensor-parallel ``mesh``."""

    @torch.no_grad()
    def step(inputs, labels) -> Dict[str, torch.Tensor]:
        was_training = model.training
        model.eval()
        try:
            logits = _call(model, _forward_params(model, pruner, masks,
                                                  mesh), inputs, None)
        finally:
            model.train(was_training)
        return {"loss": cross_entropy_loss(logits, labels),
                "accuracy": accuracy(logits, labels)}

    return step


def _flax_module_path(name: str) -> str:
    """A ``named_modules`` name under the JAX package's module names
    (``layers.0`` -> ``layers_0``), as ``weights.flax_path`` maps them."""
    return re.sub(r"layers\.(\d+)", r"layers_\1", name)


def _numeric_leaves(value, key: str, out: Dict[str, np.ndarray]) -> None:
    """Tensors of a (nested tuple) output under ``key.<i>...``; None
    entries are no leaves, as in a JAX pytree."""
    if isinstance(value, (tuple, list)):
        for i, item in enumerate(value):
            _numeric_leaves(item, f"{key}.{i}", out)
    elif isinstance(value, torch.Tensor):
        out[key] = value.detach().float().cpu().numpy()


@torch.no_grad()
def capture_intermediates(model: torch.nn.Module, x: torch.Tensor,
                          params: Optional[Dict[str, torch.Tensor]] = None
                          ) -> Tuple[torch.Tensor, Dict[str, np.ndarray]]:
    """Eval forward of ``model`` on ``x`` (B, L, d_input) recording the
    output of every submodule's ``forward``, the golden-activation dump of
    the conversion pipeline (the JAX package's ``capture_intermediates``
    over ``__call__``). Returns (the output, {key: numpy array}) with the
    keys of the JAX package's flattened dump: ``<module path>.__call__.
    <call>[.<tuple index>...]``, and for the values the JAX package sows,
    ``<layer>.input`` (a layer's input), ``<layer>.pre_s5`` (the mixer's
    input), ``<layer>.pre_C`` (the mixer's states, where it returns them),
    ``<layer>.pre_GLU`` (the mixer's output), ``encoder.pre_encoder``,
    ``encoder.encoder_output`` (the encoder dense after its activation,
    the JAX package's ``topk_op``) and ``pre_decoder`` (the regression head), each
    ``.<call>[.<index>]``. As in the JAX package the
    layers run their unfused route while capturing (no whole-layer
    kernel). Modules the port computes inline (BatchNorm, dropout) have no
    key. ``params`` replace the model's parameters of those names for the
    call (the whole weights of a tensor-parallel model)."""
    from sparsernns_tpu_torch.models.layers import SequenceLayer
    from sparsernns_tpu_torch.models.seq_model import RegressionModel
    from sparsernns_tpu_torch.models.ssm import S5SSM
    out: Dict[str, np.ndarray] = {}
    calls: Dict[str, int] = {}

    def record(key: str, value) -> None:
        i = calls.get(key, 0)
        calls[key] = i + 1
        _numeric_leaves(value, f"{key}.{i}", out)

    def prefix(name: str) -> str:
        return _flax_module_path(name) + "." if name else ""

    handles = []
    layers = []
    encoders = []
    for name, mod in model.named_modules():
        base = prefix(name)
        handles.append(mod.register_forward_hook(
            lambda m, args, y, base=base: record(f"{base}__call__", y)))
        if isinstance(mod, SequenceLayer):
            layers.append(mod)
            handles.append(mod.register_forward_pre_hook(
                lambda m, args, base=base: record(f"{base}input", args[0])))
        elif isinstance(mod, S5SSM):
            layer = base[:-len("mixer.")]
            handles.append(mod.register_forward_pre_hook(
                lambda m, args, layer=layer: record(f"{layer}pre_s5",
                                                    args[0])))

            def states(m, args, y, layer=layer):
                # the static-quant mixer returns its final state instead
                if y[1] is not None and not m.q_config.static_quant:
                    record(f"{layer}pre_C", y[1])
                record(f"{layer}pre_GLU", y[0])
            handles.append(mod.register_forward_hook(states))
        elif name == "encoder" and hasattr(mod, "layers"):
            handles.append(mod.register_forward_pre_hook(
                lambda m, args: record("encoder.pre_encoder", args[0])))

            def encode(x, encode=mod._encode):
                y = encode(x)
                record("encoder.encoder_output", y)
                return y
            mod._encode = encode
            encoders.append(mod)
        elif name == "decoder" and isinstance(model, RegressionModel):
            handles.append(mod.register_forward_pre_hook(
                lambda m, args: record("pre_decoder", args[0])))
    was_training = model.training
    model.eval()
    for layer in layers:
        layer.capturing = True
    try:
        y = functional_call(model, params, (x,)) if params else model(x)
    finally:
        for h in handles:
            h.remove()
        for layer in layers:
            layer.capturing = False
        for mod in encoders:
            del mod._encode
        model.train(was_training)
    return y, out
