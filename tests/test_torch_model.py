"""The port's eval-mode RegressionModel against the JAX package's: the same
flax weights (carried over by ``weights.from_flax``) and the same numpy
inputs go through both. Also the eval step, the streaming forward with
carries, the initializers and the recipe config."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsernns_tpu.models.seq_model import RegressionModel as JaxRegression
from sparsernns_tpu.models.ssm import make_ssm_init_fn
from sparsernns_tpu.models.ssm_init import \
    blocked_dplr_init as jax_blocked_dplr_init
from sparsernns_tpu_torch.models import ssm_init
from sparsernns_tpu_torch.train.loop import build_model
from sparsernns_tpu_torch.utils.config import RunConfig
from sparsernns_tpu_torch.utils.trace import launch_counts
from sparsernns_tpu_torch.weights import from_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(n_layers=2, d_model=16, ssm_size_base=16, blocks=2)


def small_config(**kw) -> RunConfig:
    return dataclasses.replace(
        RunConfig().with_recipe(os.path.join(ROOT, "recipes", "ndns.json")),
        **{**SMALL, **kw})


def jax_model(cfg: RunConfig, d_io: int, block_t: int = 8):
    """The JAX package's eval model for ``cfg`` with an explicit block_t."""
    init = jax_blocked_dplr_init(cfg.ssm_size_base, cfg.blocks, cfg.conj_sym)
    mixer = make_ssm_init_fn(
        h=cfg.d_model, p=init["P"], lambda_init=init["Lambda"],
        v=init["V"], vinv=init["Vinv"], c_init=cfg.C_init,
        discretization=cfg.discretization, clip_eigs=cfg.clip_eigs,
        relufication=cfg.relufication, scan_mode=cfg.scan_mode,
        block_t=block_t)
    return JaxRegression(
        mixer_cls=mixer, n_layers=cfg.n_layers, d_model=cfg.d_model,
        d_output=d_io, dropout=0.0, prenorm=cfg.prenorm,
        batchnorm=cfg.batchnorm, glu_variant=cfg.glu_variant,
        training=False, relufication=cfg.relufication)


def paired_models(cfg: RunConfig, d_io: int, seed: int = 0, length=16,
                  block_t: int = 8):
    """(jax model, flax variables with random BatchNorm statistics, port
    model on the CPU holding the same weights)."""
    jm = jax_model(cfg, d_io, block_t)
    variables = jm.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, length, d_io), jnp.float32))
    variables = jax.device_get(variables)
    rng = np.random.RandomState(seed + 100)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (0.2 * rng.randn(*a.shape) if path[-1].key == "mean"
                         else rng.uniform(0.5, 1.5, a.shape)
                         ).astype(np.float32),
        variables.get("batch_stats", {}))
    variables = {"params": variables["params"], "batch_stats": stats}
    tm = build_model(cfg, d_io, d_io, device="cpu", seed=seed)
    tm.load_state_dict(from_flax(variables["params"], stats))
    return jm, variables, tm


@pytest.mark.parametrize("glu,relu", [("half1", False), ("full", False),
                                      ("half2", True), ("none", False)])
def test_regression_forward_matches_jax(glu, relu):
    cfg = small_config(glu_variant=glu, relufication=relu)
    jm, variables, tm = paired_models(cfg, d_io=17)
    x = np.random.RandomState(1).randn(2, 37, 17).astype(np.float32)
    ref = np.asarray(jm.apply(variables, jnp.asarray(x)))
    before = launch_counts()["layer_tail_train"]
    with torch.no_grad():
        out = tm(torch.from_numpy(x)).numpy()
    # plain version on the CPU
    assert launch_counts()["layer_tail_train"] == before
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("glu", ["half1", "none"])
def test_layernorm_forward_matches_jax(glu):
    """``batchnorm=False``: prenorm LayerNorm. Offline, both packages run
    the tail kernel's non-affine mode (LayerNorm outside, the normed stream
    and the raw input into the kernel); chunked, the port runs the unfused
    route (LayerNorm, mixer with a carry, GLU, residual). Offline and
    chunked forwards both."""
    cfg = small_config(glu_variant=glu, batchnorm=False)
    jm, variables, tm = paired_models(cfg, d_io=17, seed=8)
    assert isinstance(tm.encoder.layers[0].norm, torch.nn.LayerNorm)
    rng = np.random.RandomState(9)
    for layer in tm.encoder.layers:     # a non-trivial affine
        with torch.no_grad():
            layer.norm.weight.copy_(torch.from_numpy(
                rng.uniform(0.5, 1.5, 16).astype(np.float32)))
            layer.norm.bias.copy_(torch.from_numpy(
                (0.1 * rng.randn(16)).astype(np.float32)))
    from sparsernns_tpu_torch.weights import to_flax
    params, _ = to_flax(tm)
    x = rng.randn(2, 37, 17).astype(np.float32)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        out = tm(torch.from_numpy(x)).numpy()
        t1, cache = tm.forward_stream(torch.from_numpy(x[:, :19]))
        t2, _ = tm.forward_stream(torch.from_numpy(x[:, 19:]), cache)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)
    np.testing.assert_allclose(torch.cat([t1, t2], dim=1).numpy(), ref,
                               atol=1e-4, rtol=0)


def test_stream_forward_matches_jax_cache():
    """Chunked forward with carries == JAX apply with a mutable cache, and
    == the port's own offline (fused-tail) forward."""
    cfg = small_config()
    jm, variables, tm = paired_models(cfg, d_io=17, seed=2)
    x = np.random.RandomState(3).randn(2, 40, 17).astype(np.float32)
    y1, state = jm.apply(variables, jnp.asarray(x[:, :19]),
                         mutable=["cache"])
    y2, _ = jm.apply({**variables, **state}, jnp.asarray(x[:, 19:]),
                     mutable=["cache"])
    ref = np.concatenate([np.asarray(y1), np.asarray(y2)], axis=1)
    with torch.no_grad():
        t1, cache = tm.forward_stream(torch.from_numpy(x[:, :19]))
        t2, _ = tm.forward_stream(torch.from_numpy(x[:, 19:]), cache)
        offline = tm(torch.from_numpy(x)).numpy()
    out = torch.cat([t1, t2], dim=1).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)
    np.testing.assert_allclose(out, offline, atol=1e-4, rtol=0)
    assert len(cache) == cfg.n_layers
    assert all(c.shape == (2, 8) for pair in cache for c in pair)


def test_eval_step_matches_jax():
    from sparsernns_tpu.ops.stft import stft_splitter as jax_stft
    from sparsernns_tpu.train.steps import make_ndns_eval_step as jax_step
    from sparsernns_tpu_torch.ops.stft import stft_splitter
    from sparsernns_tpu_torch.train.steps import make_ndns_eval_step
    from tests.test_train import make_state

    cfg = small_config()
    jm, variables, tm = paired_models(cfg, d_io=257, seed=4)
    rng = np.random.RandomState(5)
    clean = (0.3 * rng.randn(2, 4096)).astype(np.float32)
    noisy = (clean + 0.2 * rng.randn(2, 4096)).astype(np.float32)
    nm, nph = jax_stft(jnp.asarray(noisy))
    cm, _ = jax_stft(jnp.asarray(clean))
    state = make_state(jm, jnp.zeros((1, 16, 257), jnp.float32))
    state = state.replace(params=variables["params"],
                          batch_stats=variables["batch_stats"])
    ref = jax_step(jm)(state, nm, nph, cm, jnp.asarray(clean))

    tnm, tnph = stft_splitter(torch.from_numpy(noisy))
    tcm, _ = stft_splitter(torch.from_numpy(clean))
    out = make_ndns_eval_step(tm)(tnm, tnph, tcm, torch.from_numpy(clean))
    for key in ("loss", "si_snr"):
        np.testing.assert_allclose(out[key].item(), float(ref[key]),
                                   atol=1e-3, rtol=0)


def test_blocked_dplr_init_equals_jax():
    ref = jax_blocked_dplr_init(32, 4, conj_sym=True)
    out = ssm_init.blocked_dplr_init(32, 4, conj_sym=True)
    assert out["P"] == ref["P"] == 16
    for key in ("Lambda", "V", "Vinv"):
        np.testing.assert_array_equal(out[key], np.asarray(ref[key]))


def test_initializers_follow_flax_distributions():
    gen = torch.Generator().manual_seed(0)
    w = ssm_init.lecun_normal((400, 300), gen)
    std = (1.0 / 400) ** 0.5
    assert abs(w.std().item() / std - 1.0) < 0.02
    assert w.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-6
    ls = ssm_init.init_log_steps(64, 0.001, 0.1, gen)
    assert ls.shape == (64, 1)
    assert (ls >= np.log(0.001)).all() and (ls <= np.log(0.1)).all()


def test_build_model_shapes_and_state_dict_keys():
    cfg = small_config(glu_variant="full")
    jm, variables, tm = paired_models(cfg, d_io=9)
    sd = from_flax(variables["params"], variables["batch_stats"])
    assert set(sd) == set(tm.state_dict())
    for key, val in tm.state_dict().items():
        assert tuple(val.shape) == tuple(sd[key].shape), key
    assert not tm.training
    trainer = build_model(cfg, 9, 9, training=True, device="cpu")
    assert trainer.training and set(trainer.state_dict()) == set(sd)
    # a LayerNorm model trains too, on the tail kernel's non-affine mode
    ln = build_model(dataclasses.replace(cfg, batchnorm=False,
                                         p_dropout=0.0), 9, 9,
                     training=True, device="cpu")
    assert ln(torch.zeros(1, 4, 9)).requires_grad
    with pytest.raises(ValueError, match="mesh"):   # "sp" needs a seq mesh
        build_model(dataclasses.replace(cfg, scan_mode="sp"), 9, 9,
                    device="cpu")


def test_recipe_config_is_the_flagship():
    cfg = RunConfig().with_recipe(os.path.join(ROOT, "recipes", "ndns.json"))
    assert (cfg.d_model, cfg.ssm_size_base, cfg.blocks, cfg.n_layers) == (
        192, 256, 16, 3)
    assert cfg.glu_variant == "half1" and cfg.scan_mode == "fused"
    with pytest.raises(ValueError):
        RunConfig().with_recipe(os.path.join(ROOT, "pyproject.toml"))


def test_streaming_kernel_counter_untouched_on_cpu():
    cfg = small_config()
    tm = build_model(cfg, 5, 5, device="cpu")
    before = launch_counts()["diag_scan"]
    with torch.no_grad():
        tm.forward_stream(torch.zeros(1, 4, 5))
    assert launch_counts()["diag_scan"] == before
