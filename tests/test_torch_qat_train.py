"""Quantization-aware training on the CPU against the JAX package, on the
same flax weights and numpy inputs: the QAT forward (w8a16 and w8a8;
``scan_mode`` fused, pallas, associative and sequential; per-block and global state
scales; bidirectional; relufication), the NDNS-loss gradients, three train
steps, a three-chunk QAT stream, the routes the QAT and top-k models take,
and the JAX package's own QAT comparison on its own small model (top-k
training: ``tests/test_torch_topk_train.py``).

Size as the other training tests: 2 layers, d_model 16, P 8, prenorm
BatchNorm, GLU half1, B 2, 37 frames, dropout 0, an explicit time block of
16 on both sides. The JAX Pallas kernels run in interpret mode, the port
its kernels' plain versions. Bars: the forward 1e-4·max(1, max|ref|) but
for 0.5 % of the elements, each within 2e-2·max(1, max|ref|) (a state
code that the two sides round apart: the reference's FMAs and reciprocal
divisions put a few states on the other side of a rounding tie, and the
flipped code is carried onward). The bar is relative to the tensor's
largest value, as a grid step is: under w8a16 the activations are on
16-bit grids of their tensor's absmax, where a last-place difference in a
dense layer's sum moves an input by one step of 2^-15·absmax now and
then. Gradients rtol 2e-3 + 1e-5·max|g|; three steps: loss 1e-3 relative,
parameters rtol 1e-3 + atol 1e-5.
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
from sparsernns_tpu.quantize.config import \
    quantization_recipes as jax_recipes
from sparsernns_tpu.train import optim as jax_optim
from sparsernns_tpu.train.losses import \
    STFT_MAG_MEAN, ndns_loss_from_mask_tm as jax_ndns_loss
from sparsernns_tpu.train.state import TrainState as JaxTrainState
from sparsernns_tpu.train.steps import make_ndns_train_step as jax_train_step
from sparsernns_tpu_torch.ops.cuda import (diag_scan, fused_s5, layer_tail,
                                           layer_tail_bwd)
from sparsernns_tpu_torch.quantize.config import quantization_recipes
from sparsernns_tpu_torch.train import loop
from sparsernns_tpu_torch.train.steps import _loss, make_ndns_train_step
from sparsernns_tpu_torch.utils.config import RunConfig
from sparsernns_tpu_torch.utils.trace import launch_counts
from sparsernns_tpu_torch.weights import from_flax, grads_to_flax, to_flax
from tests.test_torch_mixer_train import (D_IO, assert_trees_close,
                                          audio_batch, jax_features,
                                          small_config, torch_features)

BLOCK = 16

CONFIGS = {
    "w8a16_fused": dict(quantization="w8a16"),
    "w8a8_fused": dict(quantization="w8a8"),
    "w8a16_global": dict(quantization="w8a16", qat_global_scales=True),
    "w8a8_global": dict(quantization="w8a8", qat_global_scales=True),
    "w8a16_pallas": dict(quantization="w8a16", scan_mode="pallas"),
    "w8a8_pallas": dict(quantization="w8a8", scan_mode="pallas"),
    "w8a16_associative": dict(quantization="w8a16",
                              scan_mode="associative"),
    "w8a8_associative": dict(quantization="w8a8", scan_mode="associative"),
    "w8a16_sequential": dict(quantization="w8a16", scan_mode="sequential"),
    "w8a16_bidirectional": dict(quantization="w8a16", bidirectional=True),
    "w8a16_relu": dict(quantization="w8a16", relufication=True),
}
#: the configurations whose gradients are compared, and whose train steps
#: but for the associative one's
TRAINED = ("w8a16_fused", "w8a16_global", "w8a8_pallas",
           "w8a16_associative", "w8a16_sequential", "w8a16_bidirectional",
           "w8a16_relu")
#: the configurations whose eval forward is compared too
EVALUATED = ("w8a16_fused", "w8a8_pallas", "w8a16_associative",
             "w8a16_sequential")
TOPK = {"topk": dict(topk=0.5, approx_topk=True),
        "topk_relu": dict(topk=0.5, approx_topk=True, relufication=True)}


def qat_config(**kw) -> RunConfig:
    return small_config(block_t=BLOCK, **kw)


def jax_model(cfg: RunConfig, training: bool):
    q = jax_recipes[cfg.quantization]()
    init = jax_blocked_dplr_init(cfg.ssm_size_base, cfg.blocks, cfg.conj_sym)
    mixer = make_ssm_init_fn(
        h=cfg.d_model, p=init["P"], lambda_init=init["Lambda"],
        v=init["V"], vinv=init["Vinv"], c_init=cfg.C_init,
        discretization=cfg.discretization, clip_eigs=cfg.clip_eigs,
        bidirectional=cfg.bidirectional, relufication=cfg.relufication,
        q_config=q, scan_mode=cfg.scan_mode, block_t=cfg.block_t,
        qat_global_scales=cfg.qat_global_scales)
    return JaxRegression(
        mixer_cls=mixer, n_layers=cfg.n_layers, d_model=cfg.d_model,
        d_output=D_IO, dropout=cfg.p_dropout, prenorm=cfg.prenorm,
        batchnorm=cfg.batchnorm, bn_momentum=cfg.bn_momentum,
        glu_variant=cfg.glu_variant, training=training,
        relufication=cfg.relufication, q_config=q, topk=cfg.topk,
        approx_topk=cfg.approx_topk)


def paired(cfg: RunConfig, seed: int, training: bool = True):
    """(jax model, variables with random BatchNorm statistics and a
    perturbed norm affine, the port's model with the same weights)."""
    jm = jax_model(cfg, training)
    variables = jax.device_get(jm.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 16, D_IO), jnp.float32)))
    rng = np.random.RandomState(seed + 100)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (0.2 * rng.randn(*a.shape) if path[-1].key == "mean"
                         else rng.uniform(0.5, 1.5, a.shape)
                         ).astype(np.float32), variables["batch_stats"])
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (a + 0.2 * rng.randn(*a.shape).astype(np.float32)
                         if path[-2].key == "norm" else a),
        variables["params"])
    tm = loop.build_model(cfg, D_IO, D_IO, training=training, device="cpu",
                          seed=seed)
    tm.load_state_dict(from_flax(params, stats))
    return jm, {"params": params, "batch_stats": stats}, tm


def assert_forward_close(out, ref, act_bits=16):
    """The forward bar. At 8-bit activations only its bound of two state
    steps holds in general: a state step is 1/127 of its block's absmax,
    and a code that the two sides round apart (at an exact tie of the
    carry's re-quantization, which the reference divides through a
    reciprocal, or after a last-place difference of λ from exp, cos and
    sin) moves the rest of its row and channel, and every later layer.
    Over seeds 1 to 4 of the forward test, 6 of the 8 runs at 8 bits had
    no element above 1e-4, one 3.9 % (pallas) and one 95.6 %
    (associative, up to 1.6e-2 of the largest output)."""
    out, ref = np.asarray(out), np.asarray(ref)
    diff = np.abs(out - ref)
    scale = max(1.0, np.abs(ref).max())
    assert diff.max() <= 2e-2 * scale, diff.max()
    if act_bits > 8:
        share = (diff > 1e-4 * scale).mean()
        assert share <= 0.005, (share, diff.max())


@pytest.mark.parametrize("name", list(CONFIGS))
def test_qat_forward_matches_jax(name):
    """The training forward (batch statistics; running statistics 1e-5)
    and, for three of the configurations, the eval forward."""
    cfg = qat_config(**CONFIGS[name])
    jm, variables, tm = paired(cfg, seed=1)
    x = np.random.RandomState(2).randn(2, 37, D_IO).astype(np.float32)
    ref, mod = jm.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    assert tm.training and tm.q_config.any_quantized
    bits = tm.q_config.ssm_act_precision
    assert_forward_close(tm(torch.from_numpy(x)).detach().numpy(), ref, bits)
    _, stats = to_flax(tm)
    assert_trees_close(stats, mod["batch_stats"], rtol=0,
                       atol=1e-5 if bits > 8 else 2e-2)
    if name not in EVALUATED:
        return
    jm_eval = jax_model(cfg, training=False)
    tm.eval()
    tm.load_state_dict(from_flax(variables["params"],
                                 variables["batch_stats"]))
    ref = jm_eval.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        assert_forward_close(tm(torch.from_numpy(x)).numpy(), ref, bits)


def _grads_match(cfg, seed, atol_of):
    jm, variables, tm = paired(cfg, seed=seed)
    noisy, clean = audio_batch(2, seed=seed + 1)
    nm, nph, cm, cl = jax_features(noisy, clean)

    def loss_fn(params):
        nm_tm = jnp.transpose(nm, (0, 2, 1))
        out, _ = jm.apply({**variables, "params": params},
                          nm_tm - STFT_MAG_MEAN, mutable=["batch_stats"])
        return jax_ndns_loss(out, nm_tm, jnp.transpose(nph, (0, 2, 1)),
                             jnp.transpose(cm, (0, 2, 1)), cl)[0]

    ref_loss, ref = jax.value_and_grad(loss_fn)(variables["params"])
    loss, _ = _loss(tm, None, *torch_features(noisy, clean))
    loss.backward()
    assert loss.item() == pytest.approx(float(ref_loss), rel=1e-4)
    assert all(p.grad is not None for p in tm.parameters())
    assert_trees_close(grads_to_flax(tm), ref, rtol=2e-3, atol_of=atol_of)


def _steps_match(cfg, seed):
    jm, variables, tm = paired(cfg, seed=seed)
    tx = jax_optim.create_optimizer(
        cfg.opt_config, lr=cfg.lr, ssm_lr=cfg.ssm_lr_base,
        weight_decay=cfg.weight_decay, total_steps=cfg.epochs,
        warmup_steps=cfg.warmup_end)
    jstate = JaxTrainState.create(
        apply_fn=jm.apply, params=variables["params"], tx=tx,
        batch_stats=variables["batch_stats"])
    state = loop.create_run_state(cfg, tm, 1)
    jstep = jax_train_step(jm, batchnorm=True)
    step = make_ndns_train_step(tm)
    for i in range(3):
        noisy, clean = audio_batch(2, seed=20 + i)
        jstate, jm_metrics = jstep(jstate, jax.random.PRNGKey(0),
                                   *jax_features(noisy, clean))
        state, metrics = step(state, *torch_features(noisy, clean))
        assert metrics["loss"].item() == pytest.approx(
            float(jm_metrics["loss"]), rel=1e-3), i
    assert state.step == 3 == int(jstate.step)
    params, _ = to_flax(tm)
    assert_trees_close(params, jax.device_get(jstate.params), rtol=1e-3,
                       atol=1e-5)


@pytest.mark.parametrize("name", TRAINED)
def test_qat_ndns_loss_gradients_match_jax(name):
    """Through the straight-through estimator of every fake-quant, the
    mixer kernel's QAT backward (the float adjoint, states recomputed), the
    scans' backward against the saved quantized states, and the norm:
    rtol 2e-3 and 1e-4 of each leaf's largest gradient. The backward
    multiplies by the forward's quantized activations, so an activation
    code rounded apart (see :func:`assert_forward_close`) moves a gradient
    by a step's share: up to 4e-5 of the leaf's largest gradient here,
    where the float models' tests hold 1e-5."""
    _grads_match(qat_config(**CONFIGS[name]), seed=6, atol_of=1e-4)


@pytest.mark.parametrize("name", [n for n in TRAINED
                                  if n != "w8a16_associative"])
def test_qat_three_train_steps_match_jax(name):
    _steps_match(qat_config(**CONFIGS[name]), seed=8)


def test_qat_stream_matches_jax_cache():
    """Three chunks with carries (the scan kernel's QAT mode from a carry,
    the carry added to the first row of bu, not fake-quantized) against
    the JAX model in ``pallas`` mode with a mutable cache."""
    cfg = qat_config(quantization="w8a16", scan_mode="pallas")
    jm, variables, tm = paired(cfg, seed=3, training=False)
    x = np.random.RandomState(4).randn(2, 57, D_IO).astype(np.float32)
    bounds = (0, 19, 40, 57)
    refs, state, outs, cache = [], {}, [], None
    before = launch_counts()["qat_scan"]
    for s, e in zip(bounds[:-1], bounds[1:]):
        y, state = jm.apply({**variables, **state}, jnp.asarray(x[:, s:e]),
                            mutable=["cache"])
        refs.append(np.asarray(y))
        with torch.no_grad():
            y, cache = tm.forward_stream(torch.from_numpy(x[:, s:e]), cache)
        outs.append(y.numpy())
    assert launch_counts()["qat_scan"] == before     # plain version on the CPU
    assert_forward_close(np.concatenate(outs, 1), np.concatenate(refs, 1))
    for i, pair in enumerate(cache):
        jc = state["cache"]["encoder"][f"layers_{i}"]["mixer"]
        for ours, key in zip(pair, ("carry_re", "carry_im")):
            np.testing.assert_allclose(ours.numpy(), np.asarray(jc[key]),
                                       rtol=0, atol=2e-2)


def test_routes_of_the_qat_and_topk_models(monkeypatch):
    """Which plain versions a train step calls (on the CPU every wrapper
    takes its plain version and launches nothing): the QAT model never the
    whole-layer kernel's (K2, K3); its fused mixer the mixer kernel's QAT
    mode (K4a), whose backward the float scan both ways (K1); a pallas QAT
    mixer the scan's QAT mode; top-k training the float scan."""
    from sparsernns_tpu_torch.ops.cuda import qat_scan as qs
    calls = {}

    def counting(module, name):
        orig = getattr(module, name)

        def wrapper(*a, **kw):
            key = name + ("_rev" if kw.get("reverse") or (
                name == "diag_scan_plain" and len(a) > 3 and a[3]) else "")
            calls[key] = calls.get(key, 0) + 1
            return orig(*a, **kw)
        monkeypatch.setattr(module, name, wrapper)

    for mod, name in ((layer_tail, "layer_tail_plain"),
                      (layer_tail_bwd, "layer_tail_hist_plain"),
                      (layer_tail_bwd, "layer_tail_bwd_plain"),
                      (fused_s5, "fused_s5_plain"),
                      (fused_s5, "fused_s5_qat_plain"),
                      (qs, "qat_scan_plain"),
                      (diag_scan, "diag_scan_plain")):
        counting(mod, name)
    launches = launch_counts()
    noisy, clean = audio_batch(2, seed=1)
    expect = {
        "w8a16_fused": {"fused_s5_qat_plain": 2, "diag_scan_plain": 2,
                        "diag_scan_plain_rev": 2},
        "w8a16_global": {"fused_s5_qat_plain": 2, "diag_scan_plain": 4,
                         "diag_scan_plain_rev": 2},
        "w8a16_pallas": {"qat_scan_plain": 2, "diag_scan_plain_rev": 2},
        "w8a16_associative": {},
        "topk": {"diag_scan_plain": 2, "diag_scan_plain_rev": 2},
        "float": {"layer_tail_plain": 2, "layer_tail_bwd_plain": 2},
    }
    for name, want in expect.items():
        kw = {**CONFIGS, **TOPK, "float": {}}[name]
        cfg = qat_config(**kw)
        tm = loop.build_model(cfg, D_IO, D_IO, training=True, device="cpu")
        state = loop.create_run_state(cfg, tm, 1)
        calls.clear()
        make_ndns_train_step(tm)(state, *torch_features(noisy, clean))
        assert calls == want, (name, calls)
    assert launch_counts() == launches


def _jax_small_qat(scan_mode, qat_global_scales=False):
    """The JAX package's own QAT comparison model
    (``tests/test_qat_training.py`` ``_qat_fwd``): 1 layer, d_model 12, P 8,
    17 inputs, eval mode."""
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 16, 17) * 0.5).astype(np.float32)
    q = jax_recipes["w8a16"]()
    init = jax_blocked_dplr_init(16, 2)
    mixer = make_ssm_init_fn(
        h=12, p=init["P"], lambda_init=init["Lambda"], v=init["V"],
        vinv=init["Vinv"], clip_eigs=True, q_config=q, scan_mode=scan_mode,
        qat_global_scales=qat_global_scales)
    model = JaxRegression(
        mixer_cls=mixer, n_layers=1, d_model=12, d_output=17, dropout=0.0,
        prenorm=True, batchnorm=True, glu_variant="half1", training=False,
        q_config=q)
    variables = jax.device_get(model.init(jax.random.PRNGKey(0),
                                          jnp.asarray(x)))
    return np.asarray(model.apply(variables, jnp.asarray(x))), variables, x


def test_global_scales_tighten_parity_as_in_the_jax_package():
    """The JAX package's own test on its own small model, here on the
    port's forwards with its weights: the global-scale fused forward within
    0.02 of the associative QAT forward (relative to its max) and no worse
    than the per-block fused forward, which is within 0.05; and each of
    the port's three forwards against the JAX package's (1e-4)."""
    refs = {"associative": _jax_small_qat("associative"),
            "fused": _jax_small_qat("fused"),
            "global": _jax_small_qat("fused", True)}
    base = RunConfig(n_layers=1, d_model=12, ssm_size_base=16, blocks=2,
                     glu_variant="half1", quantization="w8a16",
                     p_dropout=0.0, clip_eigs=True)
    ys = {}
    for name, (ref, variables, x) in refs.items():
        cfg = dataclasses.replace(
            base, scan_mode="associative" if name == "associative"
            else "fused", qat_global_scales=name == "global")
        tm = loop.build_model(cfg, 17, 17, device="cpu")
        tm.load_state_dict(from_flax(variables["params"],
                                     variables["batch_stats"]))
        with torch.no_grad():
            ys[name] = tm(torch.from_numpy(x)).numpy()
        assert_forward_close(ys[name], ref)
    denom = max(np.abs(ys["associative"]).max(), 1e-3)
    rel_block = np.abs(ys["fused"] - ys["associative"]).max() / denom
    rel_glob = np.abs(ys["global"] - ys["associative"]).max() / denom
    assert rel_glob <= rel_block + 1e-6, (rel_glob, rel_block)
    assert rel_glob < 0.02 and rel_block < 0.05, (rel_glob, rel_block)


def test_what_the_qat_and_topk_models_still_refuse():
    cfg = qat_config()
    sq = quantization_recipes["w8a16"](static_quant=True, calibrating=False)
    # the static-quant model finetunes (its scales frozen), on the
    # sequential scan only
    sq_train = loop.build_model(cfg, D_IO, D_IO, training=True, device="cpu",
                                q_config=sq, scan_mode="sequential")
    assert sq_train.training
    with pytest.raises(NotImplementedError, match="sequential"):
        loop.build_model(cfg, D_IO, D_IO, training=True, device="cpu",
                         q_config=sq, scan_mode="associative")
    with pytest.raises(NotImplementedError, match="exact top-k"):
        loop.build_model(qat_config(topk=0.5), D_IO, D_IO, training=True,
                         device="cpu")
    with pytest.raises(ValueError, match="scan_mode='sp'"):
        loop.build_model(qat_config(quantization="w8a16", scan_mode="sp"),
                         D_IO, D_IO, device="cpu")
    # the blocked scan has no site for the QAT hadamards: it builds and
    # its forward raises, as in the JAX package
    blocked = loop.build_model(qat_config(quantization="w8a16",
                                          scan_mode="blocked"), D_IO, D_IO,
                               device="cpu")
    with pytest.raises(NotImplementedError, match="hadamards"):
        blocked(torch.zeros(1, 8, D_IO))
    # QAT models: the default block when the config has none
    tm = loop.build_model(small_config(quantization="w8a16"), D_IO, D_IO,
                          device="cpu")
    assert tm.encoder.layers[0].mixer.block_t == loop.QAT_BLOCK_T == 256
