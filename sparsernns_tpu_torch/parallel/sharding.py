"""Sharding rules: parameters, batches and the train state over the mesh
(counterpart of ``sparsernns_tpu/parallel/sharding.py``).

Tensor-parallel layout of the S5 stack, by leaf name as in the JAX
package:

  B (P, H, 2), Lambda_re, Lambda_im (P,), log_step (P, 1) -> P rows on model
  C / C1 / C2 (H, P, 2)                                   -> P cols on model
  every other parameter                                   -> replicated

Each model rank keeps, at rest, its contiguous P-slice of those
parameters, of their pruning masks and of their AdamW moments, and
updates its slice. The kernels take whole weights (as the JAX package's
batch-partitioned kernels do), so a forward gathers them first
(:func:`forward_params`, differentiable: each rank's gradient is its
slice of the whole gradient, which every model rank computes alike from
the same rows). BatchNorm statistics are replicated.

Batches: each data rank takes its rows; with sequence parallelism each
seq rank its time chunk (:func:`seq_bounds`: chunks of ceil(L / n)
frames, the last ones short where n does not divide L, which is the JAX
package's end padding).
"""

from __future__ import annotations

import contextlib
import re
from typing import Dict, Iterable, Optional, Tuple

import torch
from torch import nn

from sparsernns_tpu_torch.parallel import comms
from sparsernns_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS,
                                                SEQ_AXIS, Mesh)

_P_SHARDED_FIRST = ("B", "Lambda_re", "Lambda_im", "log_step")
_P_SHARDED_MIDDLE = ("C", "C1", "C2")
_KEY_LEAF = re.compile(r"\['([^']+)'\]$")


def param_spec(name: str) -> Optional[int]:
    """The dimension of the parameter called ``name`` (a dotted port name,
    a ``/`` path or a JAX keystr; its last component decides) that lies on
    the model axis, or None where it is replicated."""
    m = _KEY_LEAF.search(name)
    leaf = m.group(1) if m else re.split(r"[./]", name)[-1]
    if leaf in _P_SHARDED_FIRST:
        return 0
    if leaf in _P_SHARDED_MIDDLE:
        return 1
    return None


def param_sharding(named_params: Iterable[Tuple[str, torch.Tensor]]
                   ) -> Dict[str, Optional[int]]:
    """{name: the dimension on the model axis, or None} of
    ``model.named_parameters()``."""
    return {name: param_spec(name) for name, _ in named_params}


def _tp(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.size(MODEL_AXIS) > 1


def p_slice(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """This model rank's contiguous slice of ``t`` along ``dim``."""
    n = mesh.size(MODEL_AXIS)
    if t.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                         f"split over {n} model ranks")
    part = t.shape[dim] // n
    return t.narrow(dim, mesh.index(MODEL_AXIS) * part, part)


def gather_whole(t: torch.Tensor, dim: int, mesh: Mesh,
                 differentiable: bool = False) -> torch.Tensor:
    """The whole tensor of which every model rank holds the slice ``t``."""
    group = mesh.group(MODEL_AXIS)
    if differentiable:
        return comms.gather_cat(t, group, dim)
    with torch.no_grad():
        return torch.cat(comms.all_gather(t.detach(), group).unbind(0),
                         dim=dim)


def seq_bounds(length: int, n: int, index: int) -> Tuple[int, int]:
    """[start, stop) of seq rank ``index``'s frames out of ``length``:
    chunks of ceil(length / n), the last ones short. Raises
    ``ValueError`` where a rank would get no frame."""
    part = -(-length // n)
    if (n - 1) * part >= length:
        raise ValueError(f"{length} frames do not split over {n} seq ranks")
    return min(length, index * part), min(length, (index + 1) * part)


def shard_batch(batch, mesh: Mesh, time_axis_3d: Optional[int] = None):
    """This rank's part of a global batch (a tuple of tensors): the data
    rank's rows of each, and with ``time_axis_3d`` the seq rank's time
    chunk of each 3-D tensor along that axis (:func:`seq_bounds`)."""
    n_data, i_data = mesh.size(DATA_AXIS), mesh.index(DATA_AXIS)
    n_seq, i_seq = mesh.size(SEQ_AXIS), mesh.index(SEQ_AXIS)

    def place(x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] % n_data:
            raise ValueError(f"batch {x.shape[0]} not divisible by the "
                             f"data axis ({n_data})")
        rows = x.shape[0] // n_data
        x = x.narrow(0, i_data * rows, rows)
        if time_axis_3d is not None and n_seq > 1 and x.dim() == 3:
            axis = time_axis_3d % 3
            lo, hi = seq_bounds(x.shape[axis], n_seq, i_seq)
            x = x.narrow(axis, lo, hi - lo)
        return x.to(mesh.device)

    return tuple(place(x) for x in batch)


def _owner(model: nn.Module, name: str):
    *mods, leaf = name.split(".")
    mod = model
    for m in mods:
        mod = getattr(mod, m)
    return mod, leaf


def sharded_params(model: nn.Module) -> Dict[str, Tuple[nn.Parameter, int]]:
    """{name: (parameter, its dimension on the model axis)} of the
    P-sharded parameters of ``model``."""
    out = {}
    for name, p in model.named_parameters():
        dim = param_spec(name)
        if dim is not None:
            out[name] = (p, dim)
    return out


def shard_train_state(state, mesh: Mesh):
    """Keep, on this model rank, its P-slice of the P-sharded parameters
    (new parameters in the model and the optimizer), of their pruning
    masks and of their optimizer moments (``exp_avg``, ``exp_avg_sq``);
    BatchNorm statistics stay whole. Records ``mesh`` on the state, which
    the train step reads. Without tensor parallelism only the mesh is
    recorded. Returns the state."""
    state.mesh = mesh
    if not _tp(mesh):
        return state
    model, opt = state.model, state.optimizer
    swap = {}
    for name, (p, dim) in sharded_params(model).items():
        new = nn.Parameter(p_slice(p.detach(), dim, mesh).clone(),
                           requires_grad=p.requires_grad)
        mod, leaf = _owner(model, name)
        mod._parameters[leaf] = new
        swap[p] = (new, dim)
    for group in opt.param_groups:
        group["params"] = [swap[p][0] if p in swap else p
                           for p in group["params"]]
    for old, (new, dim) in swap.items():
        st = opt.state.pop(old, None)
        if st is None:
            continue
        opt.state[new] = {
            k: (p_slice(v, dim, mesh).clone()
                if torch.is_tensor(v) and v.shape == old.shape else v)
            for k, v in st.items()}
    if state.masks is not None:
        for key, m in state.masks.items():
            dim = param_spec(key)
            if dim is not None:
                state.masks[key] = p_slice(m, dim, mesh).clone()
    return state


def forward_params(model: nn.Module, mesh: Optional[Mesh],
                   params: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Dict[str, torch.Tensor]:
    """``params`` (forward weights by name, e.g. the pruner's masked ones)
    with every P-sharded parameter replaced by its whole tensor, gathered
    over the model ranks differentiably; ``params`` as it is without
    tensor parallelism."""
    params = dict(params or {})
    if not _tp(mesh):
        return params
    for name, (p, dim) in sharded_params(model).items():
        params[name] = gather_whole(params.get(name, p), dim, mesh,
                                    differentiable=True)
    return params


@contextlib.contextmanager
def whole_model(state):
    """Within: the state's model holds whole (gathered, detached) tensors
    for its P-sharded parameters and its masks are whole, for what reads
    the whole model (mask updates, logs, checkpoints). On exit the slices
    come back, the masks re-sliced from what they then are. Nothing
    happens without tensor parallelism."""
    mesh = state.mesh
    if not _tp(mesh):
        yield state
        return
    saved = {}
    for name, (p, dim) in sharded_params(state.model).items():
        mod, leaf = _owner(state.model, name)
        saved[name] = (mod, leaf, p)
        mod._parameters[leaf] = nn.Parameter(gather_whole(p, dim, mesh),
                                             requires_grad=p.requires_grad)
    masks = state.masks or {}
    for key in list(masks):
        dim = param_spec(key)
        if dim is not None:
            masks[key] = gather_whole(masks[key], dim, mesh)
    try:
        yield state
    finally:
        for mod, leaf, p in saved.values():
            mod._parameters[leaf] = p
        for key in list(masks):
            dim = param_spec(key)
            if dim is not None:
                masks[key] = p_slice(masks[key], dim, mesh).clone()


def whole_optimizer_state(state) -> dict:
    """The optimizer's ``state_dict`` with the moments of the P-sharded
    parameters gathered whole over the model ranks."""
    sd = state.optimizer.state_dict()
    if not _tp(state.mesh):
        return sd
    dims = {p: dim for p, dim in sharded_params(state.model).values()}
    index = 0
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            st = sd["state"].get(index)
            if p in dims and st is not None:
                sd["state"][index] = {
                    k: (gather_whole(v, dims[p], state.mesh)
                        if torch.is_tensor(v) and v.shape == p.shape else v)
                    for k, v in st.items()}
            index += 1
    return sd


def reduce_gradients(model: nn.Module, mesh: Mesh,
                     metrics: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """Average the gradients over the data ranks (summed over the seq
    ranks, which hold the parts of one clip's gradient) and the metrics
    over the data ranks, in one all-reduce over (data, seq). Returns the
    averaged metrics."""
    group = mesh.group((DATA_AXIS, SEQ_AXIS))
    if group is None:
        return metrics
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    keys = list(metrics)
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [torch.stack([metrics[k].float() for k in keys])])
    comms.all_reduce(flat, group)
    n_grad = flat.numel() - len(keys)
    flat[:n_grad] /= mesh.size(DATA_AXIS)
    # every seq rank of a data rank holds the same metric values
    flat[n_grad:] /= mesh.size((DATA_AXIS, SEQ_AXIS))
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    return dict(zip(keys, flat[n_grad:].unbind(0)))


def grad_square_sums(model: nn.Module, mesh: Optional[Mesh], keys_of
                     ) -> Dict[str, torch.Tensor]:
    """{key: the sum of squared gradients of the parameters that
    ``keys_of(name, param)`` puts under it}, with the P-sharded
    parameters' squares summed over the model ranks (one all-reduce): the
    norms of the whole gradient."""
    local: Dict[str, torch.Tensor] = {}
    shard: Dict[str, torch.Tensor] = {}
    tp = _tp(mesh)
    for name, p in model.named_parameters():
        if p.grad is None:
            continue
        sq = (p.grad * p.grad).sum()
        into = shard if tp and param_spec(name) is not None else local
        for key in keys_of(name, p):
            into[key] = into[key] + sq if key in into else sq
    if shard:
        names = list(shard)
        summed = comms.all_reduce(torch.stack([shard[k] for k in names]),
                                  mesh.group(MODEL_AXIS))
        for key, v in zip(names, summed.unbind(0)):
            local[key] = local[key] + v if key in local else v
    return local
