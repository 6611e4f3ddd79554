"""Rank functions of the port's parallel tests
(``tests/test_torch_parallel_*.py``): each runs on one spawned gloo rank
(``parallel/launch.run_ranks``) and returns its results. This module
imports no JAX, so the ranks start with PyTorch alone."""

import numpy as np
import torch

from sparsernns_tpu_torch.parallel import comms
from sparsernns_tpu_torch.parallel.mesh import MeshConfig, make_mesh


def _mesh(data, model, seq):
    return make_mesh(MeshConfig(data=data, model=model, seq=seq),
                     device="cpu")


def scan_rank(rank, world, lam, bu, mode):
    """The sequence-parallel scan on this rank's chunk, with the gradients
    of sum(states * weights): (states chunk, grads of lam and bu, bytes)."""
    from sparsernns_tpu_torch.parallel.seqscan import (
        make_seq_parallel_scan, make_sp_train_scan)
    mesh = _mesh(1, 1, world)
    lam_t = tuple(torch.tensor(a, requires_grad=True) for a in lam)
    bu_t = tuple(torch.tensor(a, requires_grad=True) for a in bu)
    make = make_sp_train_scan if mode == "train" else make_seq_parallel_scan
    from sparsernns_tpu_torch.parallel.sharding import seq_bounds
    lo, hi = seq_bounds(bu[0].shape[-2], world, rank)
    # weights: a fixed function of the global frame index
    w = torch.cos(torch.arange(lo, hi, dtype=torch.float32))[:, None]
    with comms.CollectiveCounter() as counter:
        xs = make(mesh)(lam_t, bu_t)
        (xs[0] * w + xs[1] * w * w).sum().backward()
    return ([x.detach().numpy() for x in xs],
            [t.grad.numpy() for t in lam_t + bu_t], counter.result())


def _torch_features(batch, rows=None):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in batch)


def train_rank(rank, world, cfg, state_dict, batches, shape, ckpt_dir=None):
    """Steps of ``make_ndns_train_step`` on the (data, model, seq) mesh
    ``shape`` from the flax weights ``state_dict``, one a global batch of
    ``batches``. Returns the metrics of each step, the collective bytes of
    each step, the whole parameters and statistics after the last step,
    and the shapes this rank keeps of every parameter, mask and moment."""
    from sparsernns_tpu_torch.parallel.sharding import (gather_whole,
                                                        param_spec,
                                                        shard_batch,
                                                        shard_train_state,
                                                        whole_model)
    from sparsernns_tpu_torch.train import loop
    from sparsernns_tpu_torch.train.checkpoint import CheckpointManager
    from sparsernns_tpu_torch.train.steps import make_ndns_train_step
    from sparsernns_tpu_torch.weights import to_flax
    mesh = _mesh(*shape)
    model = loop.build_model(cfg, 257, 257, training=True, device="cpu",
                             mesh=mesh)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in state_dict.items()})
    state = loop.create_run_state(cfg, model, 1, mesh)
    state = shard_train_state(state, mesh)
    step = make_ndns_train_step(model)
    metrics, accounts = [], []
    for i, batch in enumerate(batches):
        feats = shard_batch(_torch_features(batch), mesh)
        with comms.CollectiveCounter() as counter:
            state, m = step(state, *feats)
        metrics.append({k: float(v) for k, v in m.items()})
        accounts.append(counter.result())
        if i == 0:
            grads = {name: (gather_whole(p.grad, param_spec(name), mesh)
                            if shape[1] > 1 and param_spec(name) is not None
                            else p.grad).numpy()
                     for name, p in model.named_parameters()}
            stats1 = to_flax(model)[1]
    kept = {name: tuple(p.shape) for name, p in model.named_parameters()}
    moments = {}
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            st = state.optimizer.state.get(p, {})
            if "exp_avg" in st:
                moments[id(p)] = tuple(st["exp_avg"].shape)
    names = {id(p): n for n, p in model.named_parameters()}
    moments = {names[k]: v for k, v in moments.items()}
    masks = ({k: tuple(v.shape) for k, v in state.masks.items()}
             if state.masks else None)
    if ckpt_dir is not None:
        CheckpointManager(ckpt_dir).save(0, state, metadata={"rank": rank})
    with whole_model(state):
        params, stats = to_flax(model)
    updated = None
    if state.pruner is not None:
        # a mask update on the sharded state (the train loop's, at a due
        # step): the magnitudes are the whole tensors'
        pcfg = state.pruner.cfg
        due = pcfg.update_start + pcfg.update_freq
        with whole_model(state):
            state.pruner.update_masks(model, state.masks, due)
        with whole_model(state):
            updated = (due, {k: v.numpy().copy()
                             for k, v in state.masks.items()})
    return dict(metrics=metrics, accounts=accounts, params=params,
                stats=stats, kept=kept, moments=moments, masks=masks,
                grads=grads, stats1=stats1, updated=updated)


def resume_rank(rank, world, cfg, mesh_dir, one_dir):
    """On a data-parallel mesh of the world: the next draws of this rank's
    dropout generator after a checkpoint of the sharded state (``want``),
    after that checkpoint is restored into a fresh state (``got``), and
    after a one-device checkpoint is restored into one (``from_one``)."""
    from sparsernns_tpu_torch.parallel.sharding import shard_train_state
    from sparsernns_tpu_torch.train import loop
    from sparsernns_tpu_torch.train.checkpoint import CheckpointManager
    mesh = _mesh(world, 1, 1)

    def fresh():
        model = loop.build_model(cfg, 257, 257, training=True,
                                 device="cpu", mesh=mesh)
        return loop.create_run_state(cfg, model, 1, mesh)

    state = shard_train_state(fresh(), mesh)
    torch.rand(5, generator=state.generator)      # the run draws on
    CheckpointManager(mesh_dir).save(0, state)
    want = torch.rand(8, generator=state.generator)
    resumed, _ = CheckpointManager(mesh_dir).restore(fresh(), mesh=mesh)
    got = torch.rand(8, generator=resumed.generator)
    other, _ = CheckpointManager(one_dir).restore(fresh(), mesh=mesh)
    from_one = torch.rand(8, generator=other.generator)
    return dict(want=want.numpy(), got=got.numpy(),
                from_one=from_one.numpy())


def loop_rank(rank, world, cfg):
    """``train(cfg)`` on this rank; the metadata and the whole parameters
    of the result."""
    from sparsernns_tpu_torch.parallel.sharding import whole_model
    from sparsernns_tpu_torch.train import loop
    from sparsernns_tpu_torch.weights import to_flax
    out = loop.train(cfg, device="cpu")
    with whole_model(out["state"]):
        params, _ = to_flax(out["state"].model)
    meta = {k: v for k, v in out["metadata"].items() if k != "last_log"}
    return dict(metadata=meta, last_log=out["metadata"].get("last_log"),
                params=params)


def port_engine(frozen, block_t=32, **kw):
    """The port's w8a16 engine over the frozen tree, on the CPU (the
    engine tests' configuration: relufied, prenorm, clip_eigs)."""
    from sparsernns_tpu_torch.fxp.derive import FxpModelConfig
    from sparsernns_tpu_torch.quantize.config import quantization_recipes
    from sparsernns_tpu_torch.quantize.engine import W8A16Engine
    engine_kw = kw.pop("engine_kw", {})
    cfg_kw = {**dict(glu_variant="half1", relufication=True,
                     prenorm=True, clip_eigs=True), **kw}
    q = quantization_recipes["w8a16"](static_quant=True, calibrating=False)
    return W8A16Engine(frozen["frozen_params"], frozen["frozen_stats"], q,
                       FxpModelConfig.infer(frozen["frozen_params"],
                                            **cfg_kw),
                       act_dtype=torch.float32, block_t=block_t,
                       device="cpu", **engine_kw)


def serve_rank(rank, world, frozen, xs, mode):
    """The ``mode`` ("dp", "sp", "tp") forward of the engine on each input
    of ``xs``: [(this rank's output, collective bytes)]."""
    from sparsernns_tpu_torch.parallel import sp_engine
    shape = {"dp": (world, 1, 1), "sp": (1, 1, world),
             "tp": (1, world, 1)}[mode]
    mesh = _mesh(*shape)
    engine = port_engine(frozen)
    forward = getattr(sp_engine, f"make_{mode}_forward")(engine, mesh)
    out = []
    for x in xs:
        with comms.CollectiveCounter() as counter:
            y = forward(torch.from_numpy(x))
        out.append((y.numpy(), counter.result()))
    return out


def mesh_rank(rank, world):
    """This rank's view of a data x 2 x 2 mesh (data inferred), the
    refusal of a 3 x 3 one, and the differentiable gather on the seq
    group: (shape, coords, group sizes, data shard, error, gather)."""
    from sparsernns_tpu_torch.parallel.mesh import local_data_shard_info
    mesh = _mesh(-1, 2, 2)
    sizes = {"+".join(k): comms.group_size(g) for k, g in mesh.groups.items()}
    try:
        _mesh(3, 3, 1)
        error = None
    except ValueError as e:
        error = str(e)
    group = mesh.group("seq")
    i = mesh.index("seq")
    t = torch.arange(3.0 - i, requires_grad=True)  # 3 and 2 elements
    whole = comms.gather_cat(t, group, dim=0, length=5)
    (whole * torch.arange(1.0, 6.0)).sum().backward()
    return dict(shape=mesh.shape, coords=mesh.coords, sizes=sizes,
                shard=local_data_shard_info(mesh), error=error,
                whole=whole.detach().numpy(), rep_grad=t.grad.numpy())
