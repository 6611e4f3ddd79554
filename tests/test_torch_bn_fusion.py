"""BatchNorm folding (``fuse_batchnorm_linear``) and the BatchNorm without
its scale or bias (``use_batchnorm_scale`` / ``use_batchnorm_bias``): the
port against the JAX package on the CPU, in eval and training mode, and
the route each takes.

The same flax weights (running statistics drawn at random, so the fold is
not the identity) and numpy inputs go through both; the JAX models run
their Pallas kernels in interpret mode with an explicit ``block_t``.
Forwards at 1e-4·max(1,|ref|), running statistics at 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsernns_tpu.models.seq_model import RegressionModel as JaxRegression
from sparsernns_tpu.models.ssm import make_ssm_init_fn
from sparsernns_tpu.models.ssm_init import \
    blocked_dplr_init as jax_blocked_dplr_init
from sparsernns_tpu_torch.train import loop
from sparsernns_tpu_torch.weights import from_flax, to_flax
from tests.test_torch_classification import close, random_stats
from tests.test_torch_train import (D_IO, assert_trees_close, leaves,
                                    small_config)


def config(**kw):
    return small_config(block_t=16, **kw)


def jax_model(cfg, training):
    init = jax_blocked_dplr_init(cfg.ssm_size_base, cfg.blocks, cfg.conj_sym)
    mixer = make_ssm_init_fn(
        h=cfg.d_model, p=init["P"], lambda_init=init["Lambda"],
        v=init["V"], vinv=init["Vinv"], clip_eigs=cfg.clip_eigs,
        relufication=cfg.relufication, scan_mode=cfg.scan_mode,
        block_t=cfg.block_t)
    return JaxRegression(
        mixer_cls=mixer, n_layers=cfg.n_layers, d_model=cfg.d_model,
        d_output=D_IO, dropout=0.0, prenorm=cfg.prenorm,
        batchnorm=cfg.batchnorm, bn_momentum=cfg.bn_momentum,
        glu_variant=cfg.glu_variant, training=training,
        relufication=cfg.relufication,
        fuse_batchnorm_linear=cfg.fuse_batchnorm_linear,
        use_batchnorm_scale=cfg.batchnorm_use_scale,
        use_batchnorm_bias=cfg.batchnorm_use_bias)


def paired(cfg, training, seed=0):
    """(JAX model, its variables with random running statistics and, where
    the norm has them, a random scale and bias, the port's model)."""
    jm = jax_model(cfg, training)
    # flax creates the norm's variables on the unfolded route: initialize
    # through a model that does not fold
    init_model = jax_model(dataclasses.replace(
        cfg, fuse_batchnorm_linear=False), training)
    variables = jax.device_get(init_model.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 16, D_IO), jnp.float32)))
    rng = np.random.RandomState(seed + 50)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
                         if path[-1].key == "scale" and "norm" in str(path)
                         else a), variables["params"])
    variables = {"params": params,
                 "batch_stats": random_stats(variables, seed + 60)}
    tm = loop.build_model(cfg, D_IO, D_IO, training=training, device="cpu")
    tm.load_state_dict(from_flax(variables["params"],
                                 variables["batch_stats"]))
    return jm, variables, tm


def _x(seed=1):
    return np.random.RandomState(seed).randn(2, 37, D_IO).astype(np.float32)


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("scan_mode", ["fused", "associative", "blocked"])
def test_fused_batchnorm_matches_jax(scan_mode, training):
    """The folded layer's forward, in eval and training mode (the fold
    uses the running statistics in both; the norm does not run, so they
    stay as they are in both packages)."""
    cfg = config(fuse_batchnorm_linear=True, scan_mode=scan_mode)
    jm, variables, tm = paired(cfg, training, seed=2)
    x = _x()
    if training:
        ref, mod = jm.apply(variables, jnp.asarray(x),
                            mutable=["batch_stats"])
        assert_trees_close(mod["batch_stats"], variables["batch_stats"],
                           rtol=0, atol=0)
    else:
        ref = jm.apply(variables, jnp.asarray(x))
    out = tm(torch.from_numpy(x))
    close(out.detach().numpy(), ref)
    assert_trees_close(to_flax(tm)[1], variables["batch_stats"], rtol=0,
                       atol=0)
    if training:
        out.sum().backward()
        norm = tm.encoder.layers[0].norm
        assert norm.weight.grad is not None and norm.bias.grad is not None


def test_fused_batchnorm_equals_the_unfused_eval_forward():
    """Folding is exact algebra: the folded eval forward equals the
    unfolded one (1e-4), and the folded layer runs off the whole-layer
    kernel and the mixer kernel, on the stand-alone scan."""
    cfg = config(fuse_batchnorm_linear=True, scan_mode="fused")
    _, variables, folded = paired(cfg, False, seed=3)
    plain = loop.build_model(dataclasses.replace(
        cfg, fuse_batchnorm_linear=False), D_IO, D_IO, device="cpu")
    plain.load_state_dict(folded.state_dict())
    x = torch.from_numpy(_x(4))
    with torch.no_grad():
        close(folded(x).numpy(), plain(x).numpy())
    layer = folded.encoder.layers[0]
    assert not layer.takes_tail() and plain.encoder.layers[0].takes_tail()
    fusion = layer.bn_fusion()
    assert set(fusion) == {"mean", "var", "eps", "scale", "bias"}
    u = torch.randn(1, 8, cfg.d_model)
    with torch.no_grad():
        _, states = layer.mixer(u, bn_fusion=fusion)
        _, none = layer.mixer(u)
    assert states is not None and none is None   # scan route / mixer kernel


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("use_scale,use_bias", [(False, True), (True, False),
                                                (False, False)])
def test_batchnorm_without_scale_or_bias_matches_jax(use_scale, use_bias,
                                                     training):
    """The whole-layer route (prenorm, ``"fused"``) still applies without
    the scale or the bias, in both packages; the parameter trees carry
    over leaf for leaf."""
    cfg = config(batchnorm_use_scale=use_scale, batchnorm_use_bias=use_bias,
                 scan_mode="fused")
    jm, variables, tm = paired(cfg, training, seed=5)
    norm_params = set(variables["params"]["encoder"]["layers_0"].get(
        "norm", {}))
    assert norm_params == ({"scale"} if use_scale else set()) | (
        {"bias"} if use_bias else set())
    assert tm.encoder.layers[0].takes_tail()
    assert set(leaves(to_flax(tm)[0])) == set(leaves(variables["params"]))
    x = _x(6)
    if training:
        ref, mod = jm.apply(variables, jnp.asarray(x),
                            mutable=["batch_stats"])
    else:
        ref = jm.apply(variables, jnp.asarray(x))
    out = tm(torch.from_numpy(x))
    close(out.detach().numpy(), ref)
    if training:
        assert_trees_close(to_flax(tm)[1], mod["batch_stats"], rtol=0,
                           atol=1e-6)
    # and on the unfused route (postnorm)
    cfg = config(batchnorm_use_scale=use_scale, batchnorm_use_bias=use_bias,
                 prenorm=False, scan_mode="associative")
    jm, variables, tm = paired(cfg, training, seed=7)
    ref = jm.apply(variables, jnp.asarray(x), mutable=["batch_stats"])[0] \
        if training else jm.apply(variables, jnp.asarray(x))
    close(tm(torch.from_numpy(x)).detach().numpy(), ref)


@pytest.mark.parametrize("use_scale,use_bias", [(False, True), (True, False),
                                                (False, False)])
def test_folding_without_scale_or_bias_routes_as_jax(use_scale, use_bias):
    """Without both norm parameters the JAX layer finds no norm parameters
    and normalizes unfolded; the port does the same. With one of them its
    lookup of the other raises ``KeyError``; the port's too."""
    cfg = config(fuse_batchnorm_linear=True, batchnorm_use_scale=use_scale,
                 batchnorm_use_bias=use_bias, scan_mode="associative")
    jm, variables, tm = paired(cfg, False, seed=8)
    x = _x(9)
    if use_scale or use_bias:
        with pytest.raises(KeyError):
            jm.apply(variables, jnp.asarray(x))
        with pytest.raises(KeyError):
            tm(torch.from_numpy(x))
        return
    ref = jm.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        close(tm(torch.from_numpy(x)).numpy(), ref)
    assert tm.encoder.layers[0].bn_fusion() is None


def test_fuse_batchnorm_linear_needs_prenorm_batchnorm():
    for kw in (dict(prenorm=False), dict(batchnorm=False)):
        with pytest.raises(ValueError, match="prenorm"):
            loop.build_model(config(fuse_batchnorm_linear=True, **kw), D_IO,
                             D_IO, device="cpu")
