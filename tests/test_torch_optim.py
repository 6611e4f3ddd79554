"""The port's optimizer module against the JAX package's (optax): the
warm-up cosine schedule, the group labels of the six opt_configs, and
optimizer steps on identical numpy gradients."""

import dataclasses
import os

import jax
import numpy as np
import optax
import pytest
import torch

from sparsernns_tpu.train import optim as jax_optim
from sparsernns_tpu_torch.train import optim
from sparsernns_tpu_torch.train.loop import build_model
from sparsernns_tpu_torch.utils.config import RunConfig
from sparsernns_tpu_torch.weights import from_flax, grads_to_flax, to_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def flagship_shaped(**kw) -> RunConfig:
    """The flagship recipe's tree (3 layers, GLU, prenorm BatchNorm) at
    narrow widths."""
    small = dict(d_model=16, ssm_size_base=16, blocks=2)
    return dataclasses.replace(
        RunConfig().with_recipe(os.path.join(ROOT, "recipes", "ndns.json")),
        **{**small, **kw})


@pytest.mark.parametrize("total,warmup", [(100, 10), (7, 3), (50, 0),
                                          (5, 20), (2, 1), (1, 1), (1, 0),
                                          (0, 5)])
def test_warmup_cosine_matches_optax(total, warmup):
    """Steps 0, 1, the end of the warm-up, the middle, the last and one
    past it. Within 1e-6 of the peak: optax evaluates in float32, and
    1 + cos cancels in the cosine's tail."""
    base, end = 4e-3, 1e-6
    ref = jax_optim.warmup_cosine(base, total, warmup, end)
    out = optim.warmup_cosine(base, total, warmup, end)
    steps = sorted({0, 1, warmup, max(warmup - 1, 0), total // 2,
                    max(total - 1, 0), total, total + 3})
    for step in steps:
        assert out(step) == pytest.approx(float(ref(step)), rel=1e-6,
                                          abs=1e-6 * base), (step, total,
                                                             warmup)


@pytest.mark.parametrize("dt_global", [False, True])
@pytest.mark.parametrize("opt_config", optim.OPT_CONFIGS)
def test_group_labels_match_jax(opt_config, dt_global):
    """Every parameter of a flagship-shaped model (with the "full" GLU so
    that out1 exists too) lands in the group that the JAX package's label
    function gives its flax name."""
    assert optim.OPT_CONFIGS == jax_optim.OPT_CONFIGS
    model = build_model(flagship_shaped(glu_variant="full"), 9, 9,
                        device="cpu")
    code = {label: float(i) for i, label in enumerate(optim.LABELS)}
    for name, p in model.named_parameters():
        p.grad = torch.full_like(
            p, code[optim.param_label(name, opt_config, dt_global)])
    ours = grads_to_flax(model)        # label codes under the flax names
    params, _ = to_flax(model)
    theirs = jax.tree_util.tree_map_with_path(
        jax_optim._label_fn(opt_config, dt_global), params)
    flat_ours = dict(jax.tree_util.tree_leaves_with_path(ours))
    flat_theirs = dict(jax.tree_util.tree_leaves_with_path(theirs))
    assert set(flat_ours) == set(flat_theirs)
    for path, label in flat_theirs.items():
        assert float(np.ravel(flat_ours[path])[0]) == code[label], (
            jax.tree_util.keystr(path), label)
    seen = {optim.param_label(n, opt_config, dt_global)
            for n, _ in model.named_parameters()}
    assert {"ssm", "regular"} <= seen
    assert ("none" in seen) == (opt_config == "BandCdecay")


def test_quantization_scales_are_never_optimized():
    for cfg in optim.OPT_CONFIGS:
        assert optim.param_label("encoder.quant_in.scale", cfg) == "none"
        assert optim.param_label("encoder.layers.0.norm.scale", cfg) == "ssm"


def _grad_trees(params, n, seed):
    rng = np.random.RandomState(seed)
    return [jax.tree_util.tree_map(
        lambda a: (rng.randn(*a.shape) * 10.0 ** rng.uniform(-3, 1)
                   ).astype(np.float32), params) for _ in range(n)]


@pytest.mark.parametrize("clip", [None, 0.5])
@pytest.mark.parametrize("opt_config", ["standard", "noBCdecay", "qaft"])
def test_five_steps_match_optax(opt_config, clip):
    """Five updates from the same numpy gradients (scales from 1e-3 to 10,
    so clipping triggers in some groups and not in others). Weight decay
    reaches the biases too; clipping is per group and before the update.
    rtol 1e-5: float32 Adam arithmetic in another order, five times; atol
    1e-7, the float32 resolution of the O(1) parameters, for the few
    elements that lie near zero."""
    kw = dict(lr=4e-3, ssm_lr=1e-3, weight_decay=0.04, total_steps=20,
              warmup_steps=2, grad_clip_threshold=clip, lr_min=1e-6)
    model = build_model(flagship_shaped(n_layers=2), 9, 9, device="cpu",
                        seed=3)
    with torch.no_grad():               # non-zero biases, so decay shows
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.add_(0.1)
    params, _ = to_flax(model)
    tx = jax_optim.create_optimizer(opt_config, **kw)
    opt_state = tx.init(params)
    opt = optim.create_optimizer(model.named_parameters(), opt_config, **kw)
    named = dict(model.named_parameters())
    ref = params
    for step, grads in enumerate(_grad_trees(params, 5, seed=4)):
        updates, opt_state = tx.update(grads, opt_state, ref)
        ref = optax.apply_updates(ref, updates)
        for name, g in from_flax(grads, {}).items():
            named[name].grad = g
        optim.optimizer_step(opt, step)
    ours, _ = to_flax(model)
    leaves_ref = dict(jax.tree_util.tree_leaves_with_path(ref))
    leaves_ours = dict(jax.tree_util.tree_leaves_with_path(ours))
    leaves_start = dict(jax.tree_util.tree_leaves_with_path(params))
    assert set(leaves_ref) == set(leaves_ours)
    for path, r in leaves_ref.items():
        key = jax.tree_util.keystr(path)
        np.testing.assert_allclose(leaves_ours[path], np.asarray(r),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
        assert not np.array_equal(leaves_ours[path], leaves_start[path]), key
    # the live learning rates are those optax injected
    lrs = optim.extract_learning_rates(opt)
    theirs = jax_optim.extract_learning_rates(opt_state)
    assert set(lrs) == set(theirs) == {"none/lr", "ssm/lr", "regular/lr"}
    for key, val in theirs.items():
        assert lrs[key] == pytest.approx(val, rel=1e-5, abs=1e-12), key


def test_frozen_group_does_not_move():
    """BandCdecay freezes B: its group has learning rate 0."""
    model = build_model(flagship_shaped(n_layers=1), 9, 9, device="cpu")
    opt = optim.create_optimizer(model.named_parameters(), "BandCdecay",
                                 lr=1e-2, ssm_lr=1e-2, weight_decay=0.1,
                                 total_steps=10)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    for step in range(3):
        optim.optimizer_step(opt, step)
    for name, p in model.named_parameters():
        frozen = optim.param_label(name, "BandCdecay") == "none"
        assert torch.equal(p, before[name]) == frozen, name
    assert any(n.endswith(".B") and optim.param_label(n, "BandCdecay")
               == "none" for n in before)


def test_constant_schedule_and_plateau_hooks():
    model = build_model(flagship_shaped(n_layers=1), 9, 9, device="cpu")
    opt = optim.create_optimizer(model.named_parameters(), "noBCdecay",
                                 lr=4e-3, ssm_lr=1e-3, total_steps=100,
                                 warmup_steps=10, schedule="constant")
    for p in model.parameters():
        p.grad = torch.zeros_like(p)
    optim.optimizer_step(opt, 0)
    assert optim.extract_learning_rates(opt) == {
        "none/lr": 0.0, "ssm/lr": 1e-3, "regular/lr": 4e-3}
    optim.set_learning_rates(opt, 8e-4, 2e-4)
    optim.optimizer_step(opt, 50)       # a flat schedule keeps the override
    assert optim.extract_learning_rates(opt) == {
        "none/lr": 0.0, "ssm/lr": 2e-4, "regular/lr": 8e-4}
    with pytest.raises(ValueError):
        optim.create_optimizer(model.named_parameters(), "adamish")
    # the plateau rule is the JAX package's, step for step
    ours = theirs = (4e-3, 1e-3, 0, -np.inf)
    for metric in (1.0, 0.5, 0.4, 0.3, 2.0, 1.0, 1.0, 1.0):
        ours = optim.reduce_lr_on_plateau(*ours[:3], metric, ours[3],
                                          factor=0.2, patience=2)
        theirs = jax_optim.reduce_lr_on_plateau(*theirs[:3], metric,
                                                theirs[3], factor=0.2,
                                                patience=2)
        assert ours == theirs
    assert ours[0] < 4e-3


def test_zero_scale_gradients():
    class Quantized(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.dense = torch.nn.Linear(2, 2)
            self.scale = torch.nn.Parameter(torch.ones(()))

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.quant = Quantized()
            self.norm = torch.nn.Module()
            self.norm.scale = torch.nn.Parameter(torch.ones(3))

    net = Net()
    for p in net.parameters():
        p.grad = torch.ones_like(p)
    assert float(optim.scale_gradient_leak_norm(net)) == 1.0
    optim.zero_scale_gradients(net)
    assert float(optim.scale_gradient_leak_norm(net)) == 0.0
    assert float(net.quant.scale.grad) == 0.0
    assert torch.equal(net.norm.scale.grad, torch.ones(3))   # BN scale kept
    assert torch.equal(net.quant.dense.weight.grad, torch.ones(2, 2))
