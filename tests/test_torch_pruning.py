"""The port's pruning module against the JAX package's, on the CPU: the
recipes, the schedule, the per-layer distribution, the three mask rules
(magnitude, state channels, tiles), the straight-through forward and its
gradients, hard mode and the sparsity summary. The JAX functions take the
port model's weights as a flax tree (``weights.to_flax``), so both see the
same numbers.

Bars: masks, recipes, schedule, distribution and summary exactly equal;
STE gradients rtol 2e-4 against ``jax.grad`` (atol 1e-6 of each leaf's
largest gradient).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsernns_tpu.train import pruning as jp
from sparsernns_tpu_torch.train import pruning as tp
from sparsernns_tpu_torch.train import loop
from sparsernns_tpu_torch.weights import grads_to_flax, to_flax
from tests.test_torch_train import D_IO, small_config


def leaves(tree):
    return {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_leaves_with_path(tree)}


def port_model(d_model=16, n_layers=2, **kw):
    cfg = small_config(d_model=d_model, n_layers=n_layers, **kw)
    return loop.build_model(cfg, D_IO, D_IO, training=True, device="cpu",
                            seed=3)


def jax_params(model):
    return jax.tree_util.tree_map(jnp.asarray, to_flax(model)[0])


def flax_masks(model, masks):
    """The port's masks in the JAX leaves' layouts."""
    return {leaf.key: (masks[leaf.key].T if leaf.transposed
                       else masks[leaf.key]).numpy()
            for leaf in tp.model_leaves(model)}


@pytest.mark.parametrize("epochs,steps", [(50, 100), (4, 2), (1, 1)])
def test_pruning_recipes_equal_jax(epochs, steps):
    ours = tp.pruning_recipes(epochs, steps)
    ref = jp.pruning_recipes(epochs, steps)
    assert list(ours) == list(ref) and len(ours) == 31
    for name, cfg in ref.items():
        assert dataclasses.asdict(ours[name]) == dataclasses.asdict(cfg), name
        assert ours[name].enabled == cfg.enabled


def test_scheduled_sparsity_equal_jax():
    """float32 as in the JAX package, at ten steps around the ramp."""
    cfg = tp.PruningConfig(final_sparsity=0.9, update_start=7,
                           update_end=97, update_freq=3)
    jcfg = jp.PruningConfig(**dataclasses.asdict(cfg))
    for step in (0, 7, 8, 10, 25, 51, 52, 80, 97, 150):
        ours = tp.scheduled_sparsity(cfg, step)
        ref = np.asarray(jp.scheduled_sparsity(jcfg, jnp.int32(step)))
        assert ours.dtype == np.float32 and ours == ref, (step, ours, ref)


@pytest.mark.parametrize("structure,dist", [
    ("unstructured", "erk"), ("unstructured", "uniform"),
    ("block", "uniform"), ("block", "erk"), ("state", "uniform")])
def test_sparsity_distribution_equal_jax(structure, dist):
    model = port_model(d_model=24)
    cfg = tp.PruningConfig(final_sparsity=0.8, structure=structure,
                           distribution=dist)
    ref = leaves(jp.sparsity_distribution(
        jax_params(model), jp.PruningConfig(**dataclasses.asdict(cfg))))
    ours = tp.sparsity_distribution(model, cfg)
    assert ours == ref
    assert any(v > 0 for v in ours.values())
    # the JAX leaf order
    assert [leaf.key for leaf in tp.model_leaves(model)] == list(ref)


@pytest.mark.parametrize("structure", ["unstructured", "state", "block"])
def test_masks_equal_jax_at_three_steps(structure):
    """Masks element for element at three update steps, the weights moved
    between them. Block masks on the (257, 192) encoder kernel, whose last
    input tile and last output tile are edge tiles."""
    model = port_model(d_model=192, n_layers=1, ssm_size_base=16, blocks=2)
    cfg = tp.PruningConfig(
        final_sparsity=0.9, update_start=1, update_end=9, update_freq=4,
        structure=structure,
        distribution="erk" if structure == "unstructured" else "uniform")
    jcfg = jp.PruningConfig(**dataclasses.asdict(cfg))
    ours, ref = tp.MagnitudePruner(cfg), jp.MagnitudePruner(jcfg)
    masks = ours.init_masks(model)
    jmasks = ref.init_masks(jax_params(model))
    gen = torch.Generator().manual_seed(4)
    for step in (1, 5, 9):
        with torch.no_grad():
            for p in model.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=gen))
        jmasks = ref.update_masks(jax_params(model), jmasks, jnp.int32(step))
        assert ours.update_masks(model, masks, step) is masks
        got, want = flax_masks(model, masks), leaves(jmasks)
        for key, m in want.items():
            np.testing.assert_array_equal(got[key], np.asarray(m),
                                          err_msg=f"{key} step {step}")
        assert any((np.asarray(m) == 0).any()
                   for m in want.values()) == (step > 1)
    if structure == "block":
        enc = masks["['encoder']['encoder']['kernel']"]
        assert enc.shape == (192, 257)          # nn.Linear's (out, in)
        kept = flax_masks(model, masks)[
            "['encoder']['encoder']['kernel']"]
        tiles = np.pad(kept, ((0, 31), (0, 64))).reshape(9, 32, 2, 128)
        assert ((tiles == 0).all(axis=(1, 3)) | (tiles == 1).all(
            axis=(1, 3))).all()
        assert (tiles == 0).all(axis=(1, 3)).sum() >= 15     # 90 % of 18


def test_off_schedule_steps_keep_the_masks():
    model = port_model()
    cfg = tp.PruningConfig(final_sparsity=0.5, update_start=10,
                           update_end=20, update_freq=5)
    pruner = tp.MagnitudePruner(cfg)
    masks = pruner.init_masks(model)
    for step in (3, 16, 21):
        pruner.update_masks(model, masks, step)
        assert all(bool((m == 1).all()) for m in masks.values()), step
    pruner.update_masks(model, masks, 15)
    assert tp.summarize_sparsity(model, masks)["_total_sparsity"] > 0.3
    off = tp.MagnitudePruner(tp.PruningConfig())
    assert off.apply_masks(model, off.init_masks(model)) == {}


def _pruned(model, structure, mode="ste"):
    cfg = tp.PruningConfig(final_sparsity=0.7, update_start=0, update_end=1,
                           update_freq=1, structure=structure,
                           distribution="uniform", mode=mode,
                           block_shape=(8, 8))
    pruner = tp.MagnitudePruner(cfg)
    masks = pruner.update_masks(model, pruner.init_masks(model), 1)
    return cfg, pruner, masks


@pytest.mark.parametrize("structure", ["unstructured", "block"])
def test_ste_forward_is_masked_and_gradients_dense(structure):
    """The forward on the masked weights equals the model with the pruned
    weights zeroed; the gradients reach the dense weights whole and equal
    ``jax.grad`` through the JAX package's ``apply_masks``."""
    from tests.test_torch_train import jax_training_model
    model = port_model(p_dropout=0.0)
    cfg, pruner, masks = _pruned(model, structure)
    params = jax_params(model)
    jmasks = jax.tree_util.tree_map(
        jnp.asarray, _unflatten(params, flax_masks(model, masks)))
    rng = np.random.RandomState(5)
    x = rng.randn(2, 19, D_IO).astype(np.float32)
    v = rng.randn(2, 19, D_IO).astype(np.float32)
    jm = jax_training_model(small_config(p_dropout=0.0))
    _, stats = to_flax(model)
    jpruner = jp.MagnitudePruner(jp.PruningConfig(**dataclasses.asdict(cfg)))

    def loss(p):
        out, _ = jm.apply({"params": jpruner.apply_masks(p, jmasks),
                           "batch_stats": stats}, jnp.asarray(x),
                          mutable=["batch_stats"])
        return jnp.sum(out * v)

    ref = leaves(jax.grad(loss)(params))
    fwd = pruner.apply_masks(model, masks)
    out = torch.func.functional_call(model, fwd, (torch.from_numpy(x),))
    (out * torch.from_numpy(v)).sum().backward()
    for key, g in leaves(grads_to_flax(model)).items():
        want = np.asarray(ref[key])
        np.testing.assert_allclose(g, want, rtol=2e-4,
                                   atol=1e-6 * np.abs(want).max(),
                                   err_msg=key)
    # dense gradients at the pruned coordinates
    kern, = [leaf for leaf in tp.model_leaves(model)
             if leaf.key == "['encoder']['encoder']['kernel']"]
    pruned = masks[kern.key] == 0
    assert pruned.any() and (kern.param.grad[pruned] != 0).any()
    # the forward is the model with the pruned weights zeroed
    zeroed = port_model(p_dropout=0.0)
    zeroed.load_state_dict(tp.masked_state_dict(model, masks))
    with torch.no_grad():
        again = torch.func.functional_call(model, fwd,
                                           (torch.from_numpy(x),))
        np.testing.assert_array_equal(
            again.numpy(), zeroed(torch.from_numpy(x)).numpy())


def _unflatten(params, flat):
    """A tree shaped like ``params`` from keystr -> array."""
    return jax.tree_util.tree_map_with_path(
        lambda path, _: flat[jax.tree_util.keystr(path)], params)


def test_hard_mode_zeroes_the_pruned_weights():
    """Hard mode: the pruned coordinates get no gradient, and a train step
    leaves them at exactly zero (``post_gradient_update`` after the
    optimizer step)."""
    from sparsernns_tpu_torch.train.steps import make_ndns_train_step
    from tests.test_torch_train import audio_batch, torch_features
    cfg = small_config(p_dropout=0.0)
    model = loop.build_model(cfg, D_IO, D_IO, training=True, device="cpu",
                             seed=3)
    state = loop.create_run_state(cfg, model, steps_per_epoch=2)
    _, state.pruner, state.masks = _pruned(model, "unstructured", "hard")
    state, _ = make_ndns_train_step(model)(
        state, *torch_features(*audio_batch(2, seed=6)))
    for leaf in tp.model_leaves(model):
        off = state.masks[leaf.key] == 0
        if off.any():
            assert not leaf.param[off].any(), leaf.key
            assert not leaf.param.grad[off].any(), leaf.key
    assert tp.summarize_sparsity(model)["_total_sparsity"] > 0.5


@pytest.mark.parametrize("structure", ["unstructured", "state", "block"])
def test_summarize_sparsity_equal_jax(structure):
    model = port_model()
    _, _, masks = _pruned(model, structure)
    params = jax_params(model)
    jmasks = _unflatten(params, flax_masks(model, masks))
    ref = jp.summarize_sparsity(params, jmasks)
    assert tp.summarize_sparsity(model, masks) == ref
    assert ref["_total_sparsity"] > 0.0
    assert tp.summarize_sparsity(model) == jp.summarize_sparsity(params)
