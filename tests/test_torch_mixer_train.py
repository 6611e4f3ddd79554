"""Training and offline forward on the port's mixer route against the JAX
package's, at a small size: the models that the whole-layer tail kernel does
not run (postnorm BatchNorm, LayerNorm postnorm, bidirectional,
``scan_mode="pallas"``), and the prenorm LayerNorm model, which both
packages run through the tail kernel's non-affine mode. The same flax weights (carried over by
``weights.from_flax``) and the same numpy inputs go through both; the JAX
model runs its Pallas kernels in interpret mode with an explicit
``block_t``, the port its kernels' plain versions. Dropout is 0 where
numbers are compared: the two frameworks draw different masks from the same
seed by construction."""

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
from sparsernns_tpu.ops.stft import stft_splitter as jax_stft
from sparsernns_tpu.train import optim as jax_optim
from sparsernns_tpu.train.losses import \
    STFT_MAG_MEAN, ndns_loss_from_mask_tm as jax_ndns_loss
from sparsernns_tpu.train.state import TrainState as JaxTrainState
from sparsernns_tpu.train.steps import make_ndns_train_step as jax_train_step
from sparsernns_tpu_torch.ops.stft import stft_splitter
from sparsernns_tpu_torch.train import loop
from sparsernns_tpu_torch.train.optim import param_label
from sparsernns_tpu_torch.train.steps import (_loss, make_ndns_eval_step,
                                              make_ndns_train_step)
from sparsernns_tpu_torch.utils.config import RunConfig
from sparsernns_tpu_torch.utils.trace import launch_counts
from sparsernns_tpu_torch.weights import from_flax, grads_to_flax, to_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D_IO = 257
AUDIO = 36 * 128            # 37 STFT frames

#: the model switches off the whole-layer route, one changed at a time (and
#: relufication with the full GLU once); "layernorm" keeps it, in the
#: kernel's non-affine mode
CONFIGS = {
    "postnorm": dict(prenorm=False),
    "postnorm_relu": dict(prenorm=False, relufication=True,
                          glu_variant="full"),
    "layernorm": dict(batchnorm=False),
    "layernorm_postnorm": dict(batchnorm=False, prenorm=False),
    "bidirectional": dict(bidirectional=True),
    "scan_pallas": dict(scan_mode="pallas"),
}


def small_config(**kw) -> RunConfig:
    base = dict(n_layers=2, d_model=16, ssm_size_base=16, blocks=2,
                p_dropout=0.0, bsz=2, epochs=4, synthetic_data=True,
                synthetic_size=4, synthetic_seconds=AUDIO / 16000)
    return dataclasses.replace(
        RunConfig().with_recipe(os.path.join(ROOT, "recipes", "ndns.json")),
        **{**base, **kw})


def jax_model(cfg: RunConfig, training: bool, block_t: int = 16):
    init = jax_blocked_dplr_init(cfg.ssm_size_base, cfg.blocks, cfg.conj_sym)
    mixer = make_ssm_init_fn(
        h=cfg.d_model, p=init["P"], lambda_init=init["Lambda"],
        v=init["V"], vinv=init["Vinv"], c_init=cfg.C_init,
        discretization=cfg.discretization, clip_eigs=cfg.clip_eigs,
        bidirectional=cfg.bidirectional, relufication=cfg.relufication,
        scan_mode=cfg.scan_mode, block_t=block_t)
    return JaxRegression(
        mixer_cls=mixer, n_layers=cfg.n_layers, d_model=cfg.d_model,
        d_output=D_IO, dropout=cfg.p_dropout, prenorm=cfg.prenorm,
        batchnorm=cfg.batchnorm, bn_momentum=cfg.bn_momentum,
        glu_variant=cfg.glu_variant, training=training,
        relufication=cfg.relufication)


def paired(cfg: RunConfig, seed: int = 0, training: bool = True):
    """(jax model, its variables with random norm statistics and a
    non-trivial norm affine as numpy, the port's model on the CPU with the
    same weights)."""
    jm = jax_model(cfg, training)
    variables = jax.device_get(jm.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 16, D_IO), jnp.float32)))
    rng = np.random.RandomState(seed + 100)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (0.2 * rng.randn(*a.shape) if path[-1].key == "mean"
                         else rng.uniform(0.5, 1.5, a.shape)
                         ).astype(np.float32),
        variables.get("batch_stats", {}))
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (a + 0.2 * rng.randn(*a.shape).astype(np.float32)
                         if path[-2].key == "norm" else a),
        variables["params"])
    tm = loop.build_model(cfg, D_IO, D_IO, training=training, device="cpu",
                          seed=seed)
    tm.load_state_dict(from_flax(params, stats))
    variables = {"params": params}
    if stats:
        variables["batch_stats"] = stats
    return jm, variables, tm


def audio_batch(batch: int, seed: int):
    rng = np.random.RandomState(seed)
    t = np.arange(AUDIO) / 16000.0
    clean = np.stack([0.3 * np.sin(2 * np.pi * rng.uniform(100, 900) * t
                                   + rng.uniform(0, 6))
                      for _ in range(batch)]).astype(np.float32)
    noisy = (clean + 0.1 * rng.randn(batch, AUDIO)).astype(np.float32)
    return noisy, clean


def jax_features(noisy, clean):
    nm, nph = jax_stft(jnp.asarray(noisy))
    cm, _ = jax_stft(jnp.asarray(clean))
    return nm, nph, cm, jnp.asarray(clean)


def torch_features(noisy, clean):
    nm, nph = stft_splitter(torch.from_numpy(noisy))
    cm, _ = stft_splitter(torch.from_numpy(clean))
    return nm, nph, cm, torch.from_numpy(clean)


def leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_leaves_with_path(tree)}


def assert_trees_close(ours, theirs, rtol, atol_of=None, atol=0.0):
    a, b = leaves(ours), leaves(theirs)
    assert set(a) == set(b)
    for key, ref in b.items():
        tol = atol if atol_of is None else atol_of * np.abs(ref).max()
        np.testing.assert_allclose(a[key], ref, rtol=rtol, atol=tol,
                                   err_msg=key)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_training_forward_and_running_stats_match_flax(name):
    """Output 1e-4, updated running statistics 1e-6: on the unfused route
    BatchNorm is flax's own (biased variance max(0, E[x²] − E[x]²), for a
    postnorm layer over the post-residual stream)."""
    cfg = small_config(**CONFIGS[name])
    jm, variables, tm = paired(cfg, seed=1)
    x = np.random.RandomState(2).randn(2, 37, D_IO).astype(np.float32)
    mutable = ["batch_stats"] if cfg.batchnorm else []
    ref, mod = jm.apply(variables, jnp.asarray(x), mutable=mutable)
    assert tm.training
    before = launch_counts()["layer_tail_train"]
    out = tm(torch.from_numpy(x))
    assert launch_counts()["layer_tail_train"] == before
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-4, rtol=0)
    _, stats = to_flax(tm)
    if cfg.batchnorm:
        assert_trees_close(stats, mod["batch_stats"], rtol=0, atol=1e-6)
        moved = leaves(stats)
        for key, val in leaves(variables["batch_stats"]).items():
            assert not np.array_equal(val, moved[key]), key
    else:
        assert stats == {}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_eval_forward_matches_flax(name):
    cfg = small_config(**CONFIGS[name])
    jm, variables, tm = paired(cfg, seed=3, training=False)
    x = np.random.RandomState(4).randn(2, 37, D_IO).astype(np.float32)
    ref = np.asarray(jm.apply(variables, jnp.asarray(x)))
    assert not tm.training
    with torch.no_grad():
        out = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)
    noisy, clean = audio_batch(2, seed=5)
    metrics = make_ndns_eval_step(tm)(*torch_features(noisy, clean))
    assert np.isfinite(metrics["loss"].item())


@pytest.mark.parametrize("name", list(CONFIGS))
def test_ndns_loss_gradients_match_flax(name):
    """Gradients of the NDNS loss for every parameter, through the mixer's
    (or the scans') backward and the norm. rtol 2e-3 and 1e-5 of each
    leaf's largest gradient, the bar of the fused route's test."""
    cfg = small_config(**CONFIGS[name])
    jm, variables, tm = paired(cfg, seed=6)
    noisy, clean = audio_batch(2, seed=7)
    nm, nph, cm, cl = jax_features(noisy, clean)
    mutable = ["batch_stats"] if cfg.batchnorm else []

    def loss_fn(params):
        nm_tm = jnp.transpose(nm, (0, 2, 1))
        out, _ = jm.apply({**variables, "params": params},
                          nm_tm - STFT_MAG_MEAN, mutable=mutable)
        return jax_ndns_loss(out, nm_tm, jnp.transpose(nph, (0, 2, 1)),
                             jnp.transpose(cm, (0, 2, 1)), cl)[0]

    ref_loss, ref = jax.value_and_grad(loss_fn)(variables["params"])
    loss, _ = _loss(tm, None, *torch_features(noisy, clean))
    loss.backward()
    assert loss.item() == pytest.approx(float(ref_loss), rel=1e-5)
    assert all(p.grad is not None for p in tm.parameters())
    assert_trees_close(grads_to_flax(tm), ref, rtol=2e-3, atol_of=1e-5)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_three_train_steps_match_jax(name):
    """Three optimizer steps (noBCdecay, weight decay 0.04, warm-up cosine)
    on three batches: loss and gradient norm 1e-3 relative per step,
    parameters after step 3 rtol 1e-3 + 1e-5, running statistics 1e-5."""
    cfg = small_config(**CONFIGS[name])
    jm, variables, tm = paired(cfg, seed=8)
    tx = jax_optim.create_optimizer(
        cfg.opt_config, lr=cfg.lr, ssm_lr=cfg.ssm_lr_base,
        weight_decay=cfg.weight_decay, total_steps=cfg.epochs,
        warmup_steps=cfg.warmup_end)
    jstate = JaxTrainState.create(
        apply_fn=jm.apply, params=variables["params"], tx=tx,
        batch_stats=variables.get("batch_stats", {}))
    state = loop.create_run_state(cfg, tm, 1)
    jstep = jax_train_step(jm, batchnorm=cfg.batchnorm)
    step = make_ndns_train_step(tm)
    for i in range(3):
        noisy, clean = audio_batch(2, seed=20 + i)
        jstate, jm_metrics = jstep(jstate, jax.random.PRNGKey(0),
                                   *jax_features(noisy, clean))
        state, metrics = step(state, *torch_features(noisy, clean))
        for key in ("loss", "si_snr", "grad_norm"):
            assert metrics[key].item() == pytest.approx(
                float(jm_metrics[key]), rel=1e-3, abs=1e-3), (i, key)
    assert state.step == 3 == int(jstate.step)
    params, stats = to_flax(tm)
    assert_trees_close(params, jax.device_get(jstate.params), rtol=1e-3,
                       atol=1e-5)
    if cfg.batchnorm:
        assert_trees_close(stats, jax.device_get(jstate.batch_stats),
                           rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["postnorm", "bidirectional"])
def test_dropout_structure_on_the_unfused_route(name):
    """Two (B, 1, H) draws a layer, constant along time: the output of one
    layer with dropout equals the layer recomputed by hand with the masks
    that the same generator state gives."""
    cfg = small_config(p_dropout=0.25, n_layers=1, **CONFIGS[name])
    tm = loop.build_model(cfg, D_IO, D_IO, training=True, device="cpu")
    layer = tm.encoder.layers[0]
    gen = torch.Generator().manual_seed(5)
    start = gen.get_state()
    x = torch.randn(3, 20, cfg.d_model,
                    generator=torch.Generator().manual_seed(6))
    out = layer(x, gen)
    after = gen.get_state()
    gen.set_state(start)
    m1, m2 = layer.dropout_masks(3, "cpu", gen)
    assert torch.equal(gen.get_state(), after)      # exactly two draws
    assert m1.shape == m2.shape == (3, 1, cfg.d_model)
    u = layer._norm(x) if cfg.prenorm else x
    y, _ = layer.mixer(u)
    x1 = layer._act(y) * m1
    ref = x1 * torch.sigmoid(layer.out2(x1)) * m2 + x
    if not cfg.prenorm:
        ref = layer._norm(ref)      # training mode: the batch statistics
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="Generator"):
        layer(x)                            # dropout needs the generator
    tm.eval()
    with torch.no_grad():
        assert torch.equal(layer(x), layer(x, gen))     # eval: no dropout


def test_bidirectional_weights_round_trip_and_groups():
    """``C1``/``C2`` (C projected from the eigenbasis) and the one
    (H, 2P, 2) ``C`` of ``complex_normal`` carry over by name; LayerNorm's
    scale/bias too; the optimizer sees C1/C2 as SSM parameters where the
    JAX package does."""
    cfg = small_config(bidirectional=True, batchnorm=False)
    jm, variables, tm = paired(cfg, seed=9)
    mixer = variables["params"]["encoder"]["layers_0"]["mixer"]
    assert {"C1", "C2"} <= set(mixer) and "C" not in mixer
    assert mixer["C1"].shape == (cfg.d_model, 8, 2)
    params, stats = to_flax(tm)
    assert stats == {}
    assert_trees_close(params, variables["params"], rtol=0, atol=0)
    norm = params["encoder"]["layers_1"]["norm"]
    assert set(norm) == {"scale", "bias"}
    assert set(from_flax(params, {})) == set(tm.state_dict())
    for key in ("C1", "C2"):
        name = f"encoder.layers.0.mixer.{key}"
        assert param_label(name, "noBCdecay") == "ssm"
        assert param_label(name, "standard") == "regular"
    wide = loop.build_model(
        small_config(bidirectional=True, C_init="complex_normal"), D_IO,
        D_IO, device="cpu")
    assert wide.encoder.layers[0].mixer.C.shape == (cfg.d_model, 16, 2)
    jw = jax_model(small_config(bidirectional=True,
                                C_init="complex_normal"), False)
    jv = jax.device_get(jw.init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 16, D_IO), jnp.float32)))
    assert set(from_flax(jv["params"], jv["batch_stats"])) == set(
        wide.state_dict())
    wide.load_state_dict(from_flax(jv["params"], jv["batch_stats"]))
    x = np.random.RandomState(10).randn(2, 21, D_IO).astype(np.float32)
    with torch.no_grad():
        out = wide(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(jw.apply(jv, jnp.asarray(x))),
                               atol=1e-4, rtol=0)


def test_routes_and_what_still_raises():
    """Which kernel's wrapper each configuration's mixer goes through (on
    the CPU: its plain version, no launch), and the refusals that stay."""
    x = torch.zeros(1, 8, 16)
    keys = ("diag_scan", "diag_scan_rev", "fused_s5", "layer_tail_train",
            "layer_tail_bwd")
    counters = lambda: [launch_counts()[k] for k in keys]  # noqa: E731
    before = counters()
    routes = {}
    for name, kw in {**CONFIGS, "flagship": {}}.items():
        tm = loop.build_model(small_config(**kw), D_IO, D_IO, device="cpu")
        layer = tm.encoder.layers[0]
        routes[name] = (layer.takes_tail(), layer.mixer(x)[1] is None)
        assert layer.takes_tail() == (
            layer.mixer.layer_tail_operands() is not None
            and layer.prenorm)
        assert layer.mixer(x)[0].shape == x.shape
    # (whole-layer kernel, mixer returns no state); a prenorm LayerNorm
    # layer takes the kernel's non-affine mode; the stand-alone scans
    # return their states, as the JAX package's mixer does
    assert routes["flagship"] == routes["layernorm"] == (True, True)
    for name in ("postnorm", "layernorm_postnorm"):
        assert routes[name] == (False, True), name
    assert routes["bidirectional"] == routes["scan_pallas"] == (False, False)
    assert counters() == before     # CPU tensors launch nothing

    tm = loop.build_model(small_config(prenorm=False), D_IO, D_IO,
                          device="cpu")
    mixer = tm.encoder.layers[0].mixer
    with torch.no_grad():
        y, final = mixer.forward_stream(x, None)
        assert final[0].shape == (1, 8)
        y2, final2 = mixer.forward_stream(x, final)
        assert final2[0].shape == (1, 8)
    with pytest.raises(NotImplementedError, match="no gradient"):
        mixer.forward_stream(x, None)       # grad mode on, parameters
    bi = loop.build_model(small_config(bidirectional=True), D_IO, D_IO,
                          device="cpu")
    with pytest.raises(NotImplementedError, match="bidirectional"):
        bi.forward_stream(torch.zeros(1, 8, D_IO))
    with pytest.raises(ValueError, match="scan_mode='sp'"):
        loop.build_model(small_config(scan_mode="sp"), D_IO, D_IO,
                         device="cpu")
    # the associative and the sequential scan (plain PyTorch) build and
    # run the unfused route
    for mode in ("associative", "sequential"):
        assoc = loop.build_model(small_config(scan_mode=mode), D_IO, D_IO,
                                 device="cpu")
        assert assoc.encoder.layers[0].mixer.layer_tail_operands() is None
        assert assoc.encoder.layers[0].mixer(x)[0].shape == x.shape


def test_unfused_batchnorm_is_flax_batchnorm_with_the_variance_clamp():
    """A feature that is constant up to rounding: E[x²] − E[x]² cancels to
    a value around 0 of either sign; flax clamps it at 0 and so does the
    unfused route (the whole-layer route's ``batch_affine`` does not, as
    the JAX package's fused route does not)."""
    import flax.linen as nn
    rng = np.random.RandomState(0)
    x = rng.randn(4, 50, 16).astype(np.float32)
    x[..., :8] = 300.0 + 1e-5 * rng.randn(4, 50, 8)
    bn = nn.BatchNorm(use_running_average=False, momentum=0.95)
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref, mod = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    tm = loop.build_model(small_config(prenorm=False), D_IO, D_IO,
                          training=True, device="cpu")
    layer = tm.encoder.layers[0]
    out = layer._norm(torch.from_numpy(x))
    assert (layer.norm.running_var >= 0.95 - 1e-6).all()
    np.testing.assert_allclose(
        layer.norm.running_var.numpy(),
        np.asarray(mod["batch_stats"]["var"]), atol=1e-6)
    np.testing.assert_allclose(
        layer.norm.running_mean.numpy(),
        np.asarray(mod["batch_stats"]["mean"]), rtol=1e-6)
    # the near-constant features are noise amplified by rsqrt(eps) in both;
    # the others agree to rounding
    np.testing.assert_allclose(out.detach().numpy()[..., 8:],
                               np.asarray(ref)[..., 8:], atol=1e-5)
    assert torch.isfinite(out).all()
