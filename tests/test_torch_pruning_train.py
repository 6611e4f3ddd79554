"""Pruned training on the CPU against the JAX package: six train steps with
the mask update before each, for the three pruning structures, on the
whole-layer route (prenorm BatchNorm) and on the mixer route (postnorm);
checkpoints with masks; ``train()`` with a pruning recipe; and
``convert(..., masks)`` calibrating on the pruned weights.

Size as ``tests/test_torch_train.py`` (2 layers, d_model 16, B 2, 37
frames); dropout 0. Bars: loss 1e-3 relative per step; parameters after
six steps rtol 1e-3 + atol 1e-5 (the bars of the float train steps);
masks exactly equal.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from sparsernns_tpu.train import pruning as jp
from sparsernns_tpu.train.steps import make_mask_update_fn as jax_mask_update
from sparsernns_tpu.train.steps import make_ndns_train_step as jax_train_step
from sparsernns_tpu_torch.quantize.convert import convert
from sparsernns_tpu_torch.train import loop
from sparsernns_tpu_torch.train.checkpoint import CheckpointManager
from sparsernns_tpu_torch.train.pruning import (model_leaves,
                                                summarize_sparsity)
from sparsernns_tpu_torch.train.steps import (make_mask_update_fn,
                                              make_ndns_train_step)
from sparsernns_tpu_torch.weights import to_flax
from tests.test_torch_train import (D_IO, _paired_states, assert_trees_close,
                                    audio_batch, jax_features, leaves,
                                    small_config, torch_features)

STEPS_PER_EPOCH = 2
RECIPES = {"magnitude": "iterative-ste-mag-0.9",
           "state": "iterative-ste-state-0.9",
           "block": "iterative-ste-block-0.9"}


def _masks_equal(model, masks, jmasks):
    want = leaves(jmasks)
    for leaf in model_leaves(model):
        got = masks[leaf.key]
        got = (got.T if leaf.transposed else got).numpy()
        np.testing.assert_array_equal(got, np.asarray(want[leaf.key]),
                                      err_msg=leaf.key)


@pytest.mark.parametrize("prenorm", [True, False])
@pytest.mark.parametrize("structure", list(RECIPES))
def test_six_pruned_steps_match_jax(structure, prenorm):
    """The recipe at 4 epochs of 2 steps: updates every step from step 0
    to 7, so six steps prune a growing share, the masks recomputed from
    the moving weights."""
    cfg = small_config(epochs=4, pruning=RECIPES[structure],
                       prenorm=prenorm)
    jm, jstate, tm, state = _paired_states(cfg, seed=11,
                                           steps_per_epoch=STEPS_PER_EPOCH)
    jpruner = jp.MagnitudePruner(
        jp.pruning_recipes(cfg.epochs, STEPS_PER_EPOCH)[cfg.pruning])
    jstate = jstate.replace(masks=jpruner.init_masks(jstate.params))
    jstep = jax_train_step(jm, batchnorm=True, pruner=jpruner)
    jupdate = jax_mask_update(jpruner)
    assert dataclasses.asdict(state.pruner.cfg) == dataclasses.asdict(
        jpruner.cfg)
    step, update = make_ndns_train_step(tm), make_mask_update_fn(state.pruner)
    for i in range(6):
        noisy, clean = audio_batch(2, seed=60 + i)
        jstate = jupdate(jstate)
        jstate, jmetrics = jstep(jstate, jax.random.PRNGKey(0),
                                 *jax_features(noisy, clean))
        state = update(state)
        state, metrics = step(state, *torch_features(noisy, clean))
        assert metrics["loss"].item() == pytest.approx(
            float(jmetrics["loss"]), rel=1e-3, abs=1e-3), i
    assert state.step == 6 == int(jstate.step)
    _masks_equal(tm, state.masks, jax.device_get(jstate.masks))
    params, _ = to_flax(tm)
    assert_trees_close(params, jax.device_get(jstate.params), rtol=1e-3,
                       atol=1e-5)
    sparsity = summarize_sparsity(tm, state.masks)["_total_sparsity"]
    assert sparsity == jp.summarize_sparsity(
        jax.device_get(jstate.params),
        jax.device_get(jstate.masks))["_total_sparsity"]
    assert sparsity > 0.0


def test_checkpoint_saves_and_restores_masks(tmp_path):
    cfg = small_config(epochs=4, pruning="iterative-ste-block-0.9",
                       n_layers=1)
    tm = loop.build_model(cfg, D_IO, D_IO, training=True, device="cpu")
    state = loop.create_run_state(cfg, tm, STEPS_PER_EPOCH)
    update, step = make_mask_update_fn(state.pruner), make_ndns_train_step(tm)
    feats = torch_features(*audio_batch(2, seed=70))
    for _ in range(5):
        state, _ = step(update(state), *feats)
    saved = {k: m.clone() for k, m in state.masks.items()}
    assert any(not bool(m.all()) for m in saved.values())
    mngr = CheckpointManager(str(tmp_path))
    mngr.save(0, state)

    for restore in (lambda m, s: m.restore(s)[0], CheckpointManager
                    .restore_params_only):
        fresh_model = loop.build_model(cfg, D_IO, D_IO, training=True,
                                       device="cpu", seed=5)
        fresh = loop.create_run_state(cfg, fresh_model, STEPS_PER_EPOCH)
        held = fresh.masks
        fresh = restore(mngr, fresh)
        assert fresh.masks is held           # restored in place
        for key, mask in saved.items():
            assert torch.equal(fresh.masks[key], mask), key

    # a checkpoint without masks (an unpruned run) still loads
    plain_cfg = small_config(n_layers=1)
    plain = loop.create_run_state(plain_cfg, loop.build_model(
        plain_cfg, D_IO, D_IO, training=True, device="cpu"), 2)
    assert plain.masks is None and plain.pruner is None
    other = CheckpointManager(str(tmp_path / "plain"))
    other.save(0, plain)
    fresh = loop.create_run_state(cfg, loop.build_model(
        cfg, D_IO, D_IO, training=True, device="cpu"), STEPS_PER_EPOCH)
    fresh, _ = other.restore(fresh)
    assert all(bool(m.all()) for m in fresh.masks.values())


def test_train_with_a_pruning_recipe_logs_weight_sparsity(tmp_path):
    cfg = small_config(epochs=2, n_layers=1, p_dropout=0.1,
                       pruning="iterative-ste-mag-0.9",
                       checkpoint_dir=str(tmp_path / "run"))
    out = loop.train(cfg, device="cpu")
    state, log = out["state"], out["metadata"]["last_log"]
    assert state.step == 4 and state.pruner is not None
    assert log["weight_sparsity"] == summarize_sparsity(
        state.model, state.masks)["_total_sparsity"]
    assert 0.3 < log["weight_sparsity"] < 0.9
    # resuming restores the masks with the weights
    again = loop.train(dataclasses.replace(cfg, epochs=3), device="cpu")
    assert again["state"].step == 6
    assert again["metadata"]["last_log"]["weight_sparsity"] >= \
        log["weight_sparsity"]


def test_convert_calibrates_the_pruned_weights():
    """``convert(cfg, model, masks)``: the frozen tree holds the weights
    times the masks, the model itself stays dense."""
    cfg = small_config(n_layers=1, pruning="iterative-ste-block-0.9",
                       epochs=4, validate_static_quant=False,
                       validate_engine=False)
    tm = loop.build_model(cfg, D_IO, D_IO, training=True, device="cpu")
    state = loop.create_run_state(cfg, tm, STEPS_PER_EPOCH)
    state.pruner.update_masks(tm, state.masks, 5)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    frozen = leaves(convert(cfg, tm.eval(), state.masks)["frozen_params"])
    for leaf in model_leaves(tm):
        want = leaf.param.detach() * state.masks[leaf.key]
        want = (want.T if leaf.transposed else want).numpy()
        np.testing.assert_array_equal(np.asarray(frozen[leaf.key]), want,
                                      leaf.key)
    for key, val in tm.state_dict().items():
        assert torch.equal(val, before[key]), key     # the model is dense
    k = "['encoder']['encoder']['kernel']"
    dense = leaves(convert(cfg, tm)["frozen_params"])
    assert (dense[k] != 0).all() and (frozen[k] == 0).any()


def test_tile_pruned_grad_norm_jump_is_the_reference_behaviour():
    """The tile-pruned recipe at the flagship's width (d_model 192, P 16,
    1 layer, 37 frames), three steps with the mask update before each, in
    both packages: the grad norms agree step by step (1e-3 relative), and
    both jump at the third step. The uniform tile schedule masks the
    encoder kernel's 64-wide edge column first (a tile scores the sum of
    its squares, and those tiles hold 64 of 128 columns), so output
    features 128–191 keep only their
    bias: constant over batch and time, BatchNorm divides them by
    sqrt(eps), and the straight-through gradient of the masked encoder
    weights of those features carries the jump."""
    cfg = small_config(n_layers=1, d_model=192, ssm_size_base=32, blocks=2,
                       epochs=4, pruning="iterative-ste-block-0.9")
    jm, jstate, tm, state = _paired_states(cfg, seed=11,
                                           steps_per_epoch=STEPS_PER_EPOCH)
    jpruner = jp.MagnitudePruner(
        jp.pruning_recipes(cfg.epochs, STEPS_PER_EPOCH)[cfg.pruning])
    jstate = jstate.replace(masks=jpruner.init_masks(jstate.params))
    jstep = jax_train_step(jm, batchnorm=True, pruner=jpruner)
    jupdate = jax_mask_update(jpruner)
    step, update = make_ndns_train_step(tm), make_mask_update_fn(state.pruner)
    norms = []
    for i in range(3):
        noisy, clean = audio_batch(2, seed=60 + i)
        jstate = jupdate(jstate)
        jstate, jmetrics = jstep(jstate, jax.random.PRNGKey(0),
                                 *jax_features(noisy, clean))
        state = update(state)
        state, metrics = step(state, *torch_features(noisy, clean))
        for key in ("grad_norm", "grad_norm/encoder", "grad_norm/decoder"):
            assert metrics[key].item() == pytest.approx(
                float(jmetrics[key]), rel=1e-3), (i, key)
        norms.append(metrics["grad_norm"].item())
    assert norms[2] > 20 * norms[1], norms
    _masks_equal(tm, state.masks, jax.device_get(jstate.masks))
    enc = tm.encoder.encoder
    mask = state.masks["['encoder']['encoder']['kernel']"]
    assert tuple(mask.shape) == tuple(enc.weight.shape) == (192, 257)
    dead = (mask == 0).all(dim=1)       # output features, every input masked
    assert dead.nonzero().flatten().tolist() == list(range(128, 192))
    per_param = {n: p.grad.norm().item() for n, p in tm.named_parameters()}
    assert max(per_param, key=per_param.get) == "encoder.encoder.weight"
    assert enc.weight.grad[128:].norm() > 0.99 * per_param[
        "encoder.encoder.weight"]
