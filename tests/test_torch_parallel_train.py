"""The port's data- and tensor-parallel training against the JAX package's
unsharded step, on the CPU: the same flax weights and the same numpy
audio go through the JAX step (which the JAX package's own tests hold
equal to its sharded steps) and through the port's step on 2 or 4 gloo
ranks (``parallel/launch.run_ranks``; the rank functions are in
``tests/torch_parallel_workers.py``). Sizes as the JAX package's parallel
tests: 2 layers, d_model 12, P 8 (16 in 2 blocks), B = 4 of 37 frames.
Bars as the single-device step's (PR 3): loss 1e-3 relative, gradients
rtol 2e-3 + 1e-5 of each leaf's largest, parameters after three steps
rtol 1e-3 + 1e-5, running statistics after one step 1e-6 of
max(1, |value|) (a few float32 steps at the variances of about 3). Dropout
is 0.
Also: the slice shapes that ``shard_train_state`` keeps against the JAX
package's specs, a checkpoint of a 2 x 2 run restored into one device,
``train(cfg)`` on a 2 x 2 mesh, and the collective bytes of a step."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsernns_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from sparsernns_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sparsernns_tpu.parallel.sharding import param_sharding
from sparsernns_tpu.train import optim as jax_optim
from sparsernns_tpu.train.losses import STFT_MAG_MEAN
from sparsernns_tpu.train.losses import ndns_loss_from_mask_tm as jax_loss
from sparsernns_tpu.train.state import TrainState as JaxTrainState
from sparsernns_tpu.train.steps import make_ndns_train_step as jax_train_step
from sparsernns_tpu_torch.parallel.launch import run_ranks
from sparsernns_tpu_torch.train import loop
from sparsernns_tpu_torch.train.checkpoint import CheckpointManager
from sparsernns_tpu_torch.train.optim import param_label
from sparsernns_tpu_torch.weights import flax_path, from_flax, to_flax
from tests import torch_parallel_workers as workers
from tests.test_torch_train import (assert_trees_close, audio_batch,
                                    jax_features, paired, small_config)

CFG = dict(n_layers=2, d_model=12, ssm_size_base=16, blocks=2, bsz=4,
           grad_clip_threshold=0.5)


def _cfg(**kw):
    return small_config(**{**CFG, **kw})


def _batches():
    out = []
    for i in range(3):
        noisy, clean = audio_batch(4, seed=60 + i)
        out.append(tuple(np.asarray(a) for a in jax_features(noisy, clean)))
    return out


def jax_reference(cfg):
    """The JAX package's unsharded step of ``cfg``, three times on three
    batches: the metrics of each step, the gradients (clipped, as the
    port's step leaves them) and statistics of the first, the parameters
    and statistics after the third; and the port's starting weights (the
    same flax tree)."""
    jm, variables, tm = paired(cfg, seed=11)
    tx = jax_optim.create_optimizer(
        cfg.opt_config, lr=cfg.lr, ssm_lr=cfg.ssm_lr_base,
        weight_decay=cfg.weight_decay, total_steps=cfg.epochs,
        warmup_steps=cfg.warmup_end,
        grad_clip_threshold=cfg.grad_clip_threshold)
    jstate = JaxTrainState.create(apply_fn=jm.apply,
                                  params=variables["params"], tx=tx,
                                  batch_stats=variables["batch_stats"])
    batches = _batches()
    nm, nph, cm, cl = (jnp.asarray(a) for a in batches[0])

    def loss_fn(params):
        nm_tm = jnp.transpose(nm, (0, 2, 1))
        out, _ = jm.apply({"params": params,
                           "batch_stats": variables["batch_stats"]},
                          nm_tm - STFT_MAG_MEAN, mutable=["batch_stats"])
        return jax_loss(out, nm_tm, jnp.transpose(nph, (0, 2, 1)),
                        jnp.transpose(cm, (0, 2, 1)), cl)[0]

    grads = from_flax(jax.device_get(jax.grad(loss_fn)(
        variables["params"])), variables["batch_stats"])
    # the step leaves the gradients clipped per param group in .grad
    grads = {k: v.numpy() for k, v in grads.items()
             if k in dict(tm.named_parameters())}
    labels = {k: param_label(k, cfg.opt_config) for k in grads}
    for label in set(labels.values()):
        members = [k for k in grads if labels[k] == label]
        norm = np.sqrt(sum(float((grads[k].astype(np.float64) ** 2).sum())
                           for k in members))
        if norm >= cfg.grad_clip_threshold:
            for k in members:
                grads[k] = grads[k] * np.float32(
                    cfg.grad_clip_threshold / norm)
    step = jax_train_step(jm, batchnorm=True)
    metrics, stats1 = [], None
    for batch in batches:
        jstate, m = step(jstate, jax.random.PRNGKey(0),
                         *(jnp.asarray(a) for a in batch))
        metrics.append({k: float(v) for k, v in m.items()})
        if stats1 is None:
            stats1 = jax.device_get(jstate.batch_stats)
    return dict(cfg=cfg, batches=batches, metrics=metrics,
                grads=grads,
                stats1=stats1, params=jax.device_get(jstate.params),
                stats=jax.device_get(jstate.batch_stats),
                start={k: v.numpy() for k, v in tm.state_dict().items()},
                jax_params=variables["params"])


@pytest.fixture(scope="module")
def reference():
    return jax_reference(_cfg())


def _check_run(ref, out):
    for mine, theirs in zip(out["metrics"], ref["metrics"]):
        for key in ("loss", "si_snr", "grad_norm", "grad_norm/encoder",
                    "grad_norm/decoder"):
            assert mine[key] == pytest.approx(theirs[key], rel=1e-3,
                                              abs=1e-3), key
    for name, g in out["grads"].items():
        want = ref["grads"][name]
        np.testing.assert_allclose(g, want, rtol=2e-3,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)
    assert_trees_close(out["stats1"], ref["stats1"], rtol=1e-6, atol=1e-6)
    assert_trees_close(out["params"], ref["params"], rtol=1e-3, atol=1e-5)
    assert_trees_close(out["stats"], ref["stats"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 1, 1), (1, 2, 1)],
                         ids=["dp2", "tp2"])
def test_train_steps_match_jax_unsharded_step(reference, shape):
    """Three steps on 2 ranks, data-parallel (1 row each... 2 of 4 rows)
    or tensor-parallel (P 8 as 4 + 4), against the JAX unsharded step;
    every rank ends with the same whole parameters."""
    outs = run_ranks(workers.train_rank, 2,
                     (reference["cfg"], reference["start"],
                      reference["batches"], shape))
    for out in outs:
        _check_run(reference, out)
    assert_trees_close(outs[0]["params"], outs[1]["params"], rtol=0)
    acct = outs[0]["accounts"][0]
    cfg, start = reference["cfg"], reference["start"]
    n_params = sum(v.size for k, v in start.items()
                   if k in outs[0]["kept"])
    h = cfg.d_model
    if shape[0] == 2:
        # one all-reduce of the gradients and 2 metrics; the BatchNorm
        # sums (2H + 1 floats) forward and backward, a layer
        assert acct["per_op_counts"] == {"all-reduce": 1 + 2 * cfg.n_layers}
        assert acct["total_bytes"] == 4 * (n_params + 2) + \
            2 * cfg.n_layers * 4 * (2 * h + 1)
    else:
        # 5 P-sharded parameters a layer gathered whole, the norms' one
        # all-reduce of the sharded squares (branch and param group)
        assert acct["per_op_counts"] == {"all-gather": 5 * cfg.n_layers,
                                         "all-reduce": 1}
        assert acct["per_op_bytes"]["all-reduce"] == 2 * 4


def _grad_bytes(state_dict, kept):
    return 4 * sum(int(np.prod(s)) for s in kept.values())


def test_dp_tp_steps_sharded_state_and_checkpoint(reference, tmp_path):
    """2 x 2 (data x model) on 4 ranks: the steps against the JAX unsharded
    step; the shapes each rank keeps of every parameter, mask and Adam
    moment are the JAX package's shard shapes (``param_sharding`` on its
    4 x 2 mesh: the model axis splits alike); the collective bytes of a
    step (one all-reduce of the gradients and the two metrics over the
    data ranks, the BatchNorm sums forward (2H + 1) and backward (2H + 1)
    a layer, one gather of each P-sharded parameter over the model ranks,
    the norms' one all-reduce of the sharded squares); and the checkpoint
    (whole tensors written by rank 0) restores into a one-device state
    equal to the ranks' whole parameters; a mask update on the sharded
    state gives the one-device update's masks."""
    cfg = dataclasses.replace(reference["cfg"],
                              pruning="iterative-ste-mag-0.5")
    outs = run_ranks(workers.train_rank, 4,
                     (cfg, reference["start"], reference["batches"],
                      (2, 2, 1), str(tmp_path)))
    for out in outs:
        _check_run(reference, out)
    jmesh = jax_make_mesh(JaxMeshConfig(data=4, model=2, seq=1))
    specs = param_sharding(reference["jax_params"], jmesh)
    for out in outs:
        for name, shape in out["kept"].items():
            path, transposed = flax_path(name)
            leaf = reference["jax_params"]
            sharding = specs
            for key in path:
                leaf, sharding = leaf[key], sharding[key]
            want = sharding.shard_shape(leaf.shape)
            assert shape == (want[::-1] if transposed else want), name
            if name in out["moments"]:
                assert out["moments"][name] == shape, name
        for key, mshape in out["masks"].items():
            name = [n for n in out["kept"]
                    if "".join(f"['{p}']" for p in flax_path(n)[0]) == key]
            assert mshape == out["kept"][name[0]], key
    # collective bytes of the first step, from the sizes
    h, n_layers = cfg.d_model, cfg.n_layers
    start = reference["start"]
    whole = {k: v for k, v in start.items() if "running" not in k
             and "num_batches" not in k}
    n_params = sum(v.size for v in whole.values())
    kept = outs[0]["kept"]
    n_kept = sum(int(np.prod(s)) for s in kept.values())
    sharded = [k for k in kept if kept[k] != start[k].shape]
    acct = outs[0]["accounts"][0]
    assert acct["per_op_counts"]["all-reduce"] == 1 + 2 * n_layers + 1
    assert acct["per_op_bytes"]["all-reduce"] == (
        4 * (n_kept + 2)                      # gradients and 2 metrics
        + 2 * n_layers * 4 * (2 * h + 1)      # BatchNorm sums, fwd + bwd
        + 2 * 4)    # sharded squares: branch "encoder", group "ssm"
    assert acct["per_op_counts"]["all-gather"] == len(sharded)
    assert acct["per_op_bytes"]["all-gather"] == 4 * sum(
        start[k].size for k in sharded)
    assert n_params > n_kept
    # the checkpoint is whole and restores into one device
    tm = loop.build_model(cfg, 257, 257, training=True, device="cpu")
    state = loop.create_run_state(cfg, tm, 1)
    state, meta = CheckpointManager(str(tmp_path)).restore(state)
    assert meta == {"rank": 0} and state.step == 3
    params, _ = to_flax(tm)
    assert_trees_close(params, outs[0]["params"], rtol=0)
    for key, m in state.masks.items():
        assert m.shape == dict(tm.named_parameters())[
            [n for n in outs[0]["kept"]
             if "".join(f"['{p}']" for p in flax_path(n)[0]) == key][0]
        ].shape
    # a mask update on the sharded state = the one-device update of the
    # same whole weights
    due, masks = outs[0]["updated"]
    state.pruner.update_masks(tm, state.masks, due)
    for key, m in state.masks.items():
        np.testing.assert_array_equal(masks[key], m.numpy(), err_msg=key)
        for o in outs[1:]:
            np.testing.assert_array_equal(o["updated"][1][key], masks[key])
    assert any((m == 0).any() for m in masks.values())
    moment_shapes = {tuple(st["exp_avg"].shape)
                     for st in state.optimizer.state.values()
                     if "exp_avg" in st}
    assert {tuple(p.shape) for p in tm.parameters()} >= moment_shapes


def test_resume_on_a_dp_mesh_keeps_each_ranks_dropout(tmp_path):
    """A checkpoint of a 2-rank data-parallel run holds each rank's
    dropout generator: restored, each rank draws on as it would have, and
    the two ranks draw other masks. A one-device checkpoint restored on
    the mesh gives data rank 0 the one-device run's draws and rank 1
    others."""
    cfg = _cfg(p_dropout=0.1)
    model = loop.build_model(cfg, 257, 257, training=True, device="cpu")
    state = loop.create_run_state(cfg, model, 1)
    CheckpointManager(str(tmp_path / "one")).save(0, state)
    one_next = torch.rand(8, generator=state.generator).numpy()
    outs = run_ranks(workers.resume_rank, 2,
                     (cfg, str(tmp_path / "mesh"), str(tmp_path / "one")))
    for o in outs:
        np.testing.assert_array_equal(o["got"], o["want"])
    assert not np.array_equal(outs[0]["want"], outs[1]["want"])
    np.testing.assert_array_equal(outs[0]["from_one"], one_next)
    assert not np.array_equal(outs[1]["from_one"], one_next)


def test_train_loop_on_a_2x2_mesh(tmp_path):
    """``train(cfg)`` with mesh_data=2, mesh_model=2 on 4 ranks: one epoch,
    finite metrics equal on every rank, the same whole parameters
    everywhere, checkpoints written once."""
    cfg = _cfg(mesh_data=2, mesh_model=2, epochs=1, synthetic_size=8,
               checkpoint_dir=str(tmp_path))
    outs = run_ranks(workers.loop_rank, 4, (cfg,))
    metas = [o["metadata"] for o in outs]
    assert all(m == metas[0] for m in metas)
    assert np.isfinite(metas[0]["best_val_loss"])
    assert outs[0]["last_log"] == outs[3]["last_log"]
    for o in outs[1:]:
        assert_trees_close(o["params"], outs[0]["params"], rtol=0)
    assert CheckpointManager(str(tmp_path)).all_steps() == [0]
