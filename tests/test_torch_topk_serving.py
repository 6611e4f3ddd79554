"""Activation top-k serving on the CPU against the JAX package, on the same
flax weights, frozen trees and numpy inputs:

- the float top-k model (``topk=0.5, approx_topk=True``), offline and
  streamed in chunks, with and without relufication (state top-k);
- static-quant calibration of the top-k model: the JAX frozen scales;
- the serving engine's per-op route: top-k without relufication (the
  mixer kernel, K4a's engine modes), top-k relufied (the scan kernel with
  its block requant and top-k on the states) and ``w32a32`` without
  top-k (its 32-bit residual requant), offline, chunked (K4b) and through
  ``StreamingDenoiser.from_engine``; the per-op route forced on an engine
  that also has the whole-layer route.

Size as the JAX package's engine tests: H 12, P 8 (16 conj-sym), 2 layers,
L 24, B 2. Bars: the float model 1e-4 * max(1, |ref|); engines max
2e-3 * max(1, |ref|) and mean 1e-4 * max(1, |ref|).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsernns_tpu.fxp.derive import FxpModelConfig as JaxModelConfig
from sparsernns_tpu.models.seq_model import RegressionModel as JaxRegression
from sparsernns_tpu.models.ssm import make_ssm_init_fn
from sparsernns_tpu.models.ssm_init import blocked_dplr_init
from sparsernns_tpu.quantize.calibrate import calibrate as jax_calibrate
from sparsernns_tpu.quantize.config import quantization_recipes as jax_recipes
from sparsernns_tpu.quantize.engine import W8A16Engine as JaxEngine
from sparsernns_tpu.serve.streaming import \
    StreamingDenoiser as JaxStreamingDenoiser
from sparsernns_tpu_torch.fxp.derive import FxpModelConfig
from sparsernns_tpu_torch.quantize.calibrate import calibrate
from sparsernns_tpu_torch.quantize.config import quantization_recipes
from sparsernns_tpu_torch.quantize.convert import engine_from_frozen
from sparsernns_tpu_torch.quantize.engine import W8A16Engine
from sparsernns_tpu_torch.serve.streaming import StreamingDenoiser
from sparsernns_tpu_torch.train.loop import build_model
from sparsernns_tpu_torch.utils.config import RunConfig
from sparsernns_tpu_torch.utils.trace import launch_counts
from sparsernns_tpu_torch.weights import flat_leaves, from_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, P_SIZE, LAYERS, L, B = 12, 16, 2, 24, 2
BLOCK = 8


def topk_config(relu: bool) -> RunConfig:
    """recipes/ndns.json cut to H 12, P 8, 2 layers, with top-k 0.5."""
    return dataclasses.replace(
        RunConfig().with_recipe(os.path.join(ROOT, "recipes", "ndns.json")),
        n_layers=LAYERS, d_model=H, ssm_size_base=P_SIZE, blocks=2,
        relufication=relu, topk=0.5, approx_topk=True, block_t=BLOCK)


def jax_model(cfg: RunConfig, d_io: int, q_config=None, scan_mode=None):
    init = blocked_dplr_init(cfg.ssm_size_base, cfg.blocks, cfg.conj_sym)
    q_kw = {} if q_config is None else dict(q_config=q_config)
    mixer = make_ssm_init_fn(
        h=cfg.d_model, p=init["P"], lambda_init=init["Lambda"], v=init["V"],
        vinv=init["Vinv"], c_init=cfg.C_init,
        discretization=cfg.discretization, clip_eigs=cfg.clip_eigs,
        relufication=cfg.relufication, scan_mode=scan_mode or cfg.scan_mode,
        block_t=8, **q_kw)
    return JaxRegression(
        mixer_cls=mixer, n_layers=cfg.n_layers, d_model=cfg.d_model,
        d_output=d_io, dropout=0.0, prenorm=cfg.prenorm,
        batchnorm=cfg.batchnorm, glu_variant=cfg.glu_variant,
        training=False, relufication=cfg.relufication, topk=cfg.topk,
        approx_topk=cfg.approx_topk, **q_kw)


def _variables(cfg: RunConfig, d_io: int, seed: int):
    """Flax weights of the float model with random BatchNorm statistics."""
    variables = jax.device_get(jax_model(cfg, d_io, scan_mode="associative")
                               .init(jax.random.PRNGKey(seed),
                                     jnp.zeros((1, L, d_io), jnp.float32)))
    rng = np.random.RandomState(seed + 100)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (0.2 * rng.randn(*a.shape) if path[-1].key == "mean"
                         else rng.uniform(0.5, 1.5, a.shape)
                         ).astype(np.float32), variables["batch_stats"])
    return variables["params"], stats


# ------------------------------------------------------- float top-k model

@pytest.mark.parametrize("relu", [False, True])
def test_float_topk_model_matches_jax(relu):
    """Offline and streamed in two chunks with carries, vs the JAX model
    offline. Without relufication top-k acts on the encoder output and the
    layer outputs; relufied also on the GLU input and on each state half.
    The offline forward runs the stand-alone scan (K1), never the
    whole-layer or the mixer kernel."""
    cfg = topk_config(relu)
    params, stats = _variables(cfg, 17, seed=1 + relu)
    x = np.random.RandomState(2).randn(B, 37, 17).astype(np.float32)
    ref = np.asarray(jax_model(cfg, 17).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x)))
    tm = build_model(cfg, 17, 17, device="cpu", seed=0)
    tm.load_state_dict(from_flax(params, stats))
    assert tm.encoder.layers[0].mixer.layer_tail_operands() is None
    before = launch_counts()["fused_s5"]
    with torch.no_grad():
        out = tm(torch.from_numpy(x)).numpy()
        t1, cache = tm.forward_stream(torch.from_numpy(x[:, :19]))
        t2, _ = tm.forward_stream(torch.from_numpy(x[:, 19:]), cache)
    assert launch_counts()["fused_s5"] == before
    bar = 1e-4 * max(1.0, np.abs(ref).max())
    assert np.abs(out - ref).max() <= bar
    assert np.abs(torch.cat([t1, t2], dim=1).numpy() - ref).max() <= bar
    # top-k did act: a quarter of the layer outputs' entries are kept
    with torch.no_grad():
        h = tm.encoder(torch.from_numpy(x))
    assert ((h != 0).sum(-1) <= H // 2).all()


# -------------------------------------------- calibration and frozen trees

@pytest.fixture(scope="module")
def topk_frozen():
    """The JAX package's w8a16 calibration of the relufied top-k model
    (glu half1, prenorm BatchNorm), its float weights and two batches. The
    JAX calibration creates its variables (and observes them once) with
    the float weights' key, so its observers start where the port's do."""
    cfg = topk_config(True)
    params, stats = _variables(cfg, 9, seed=5)
    rng = np.random.RandomState(6)
    batches = [(0.5 * rng.randn(B, L, 9)).astype(np.float32)
               for _ in range(2)]
    cal = jax_model(cfg, 9, jax_recipes["w8a16"](static_quant=True,
                                                 calibrating=True),
                    scan_mode="sequential")
    f_params, f_stats = jax.device_get(jax_calibrate(
        cal, jax.random.PRNGKey(5), jnp.zeros((B, L, 9), jnp.float32),
        params, stats, [jnp.asarray(b) for b in batches]))
    return dict(params=params, stats=stats, batches=batches,
                frozen_params=f_params, frozen_stats=f_stats)


def test_topk_calibration_scales_equal_jax(topk_frozen):
    """The static-quant top-k model (top-k at the encoder, the GLU input
    and the layer output; the states relu'd, not top-k'd, as in the JAX
    package) observes the JAX package's ranges: every frozen leaf equal."""
    cfg = topk_config(True)
    cal_model = build_model(
        cfg, 9, 9, device="cpu", seed=0, scan_mode="sequential",
        q_config=quantization_recipes["w8a16"](static_quant=True,
                                               calibrating=True))
    params, stats = calibrate(
        cal_model, from_flax(topk_frozen["params"], topk_frozen["stats"]),
        [torch.from_numpy(b) for b in topk_frozen["batches"]])
    ours = dict(flat_leaves(params))
    ref = dict(flat_leaves(topk_frozen["frozen_params"]))
    assert set(ours) == set(ref)
    for key in ref:
        np.testing.assert_array_equal(np.asarray(ours[key]),
                                      np.asarray(ref[key]),
                                      err_msg="/".join(key))
    ours_s = dict(flat_leaves(stats))
    for key, val in flat_leaves(topk_frozen["frozen_stats"]):
        np.testing.assert_array_equal(ours_s[key], np.asarray(val))


# ------------------------------------------------------ per-op engines

def _engines(frozen, relu, recipe="w8a16", topk=0.5, act=torch.float32,
             block_t=BLOCK):
    """(JAX engine, port engine on the CPU) over one frozen tree."""
    kw = dict(glu_variant="half1", relufication=relu, prenorm=True,
              clip_eigs=True, topk=topk, approx_topk=True)
    je = JaxEngine(
        frozen["frozen_params"], frozen["frozen_stats"],
        jax_recipes[recipe](static_quant=True, calibrating=False),
        JaxModelConfig.infer(frozen["frozen_params"], **kw),
        act_dtype={torch.float32: jnp.float32,
                   torch.bfloat16: jnp.bfloat16}[act], block_t=block_t)
    te = W8A16Engine(
        frozen["frozen_params"], frozen["frozen_stats"],
        quantization_recipes[recipe](static_quant=True, calibrating=False),
        FxpModelConfig.infer(frozen["frozen_params"], **kw),
        act_dtype=act, block_t=block_t, device="cpu")
    return je, te


def _engine_close(out, ref):
    scale = max(1.0, np.abs(ref).max())
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= 2e-3 * scale, np.abs(out - ref).max()
    assert np.abs(out - ref).mean() <= 1e-4 * scale


ENGINES = {"topk": (False, "w8a16", 0.5), "topk_relu": (True, "w8a16", 0.5),
           "w32a32": (True, "w32a32", 1.0)}


@pytest.mark.parametrize("act", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(ENGINES))
@pytest.mark.parametrize("block_t,length", [(8, 24), (16, 23)])
def test_per_op_engine_matches_jax(topk_frozen, name, act, block_t, length):
    """The three per-op engines offline vs the JAX engine's per-op route:
    aligned blocks, and a short last block of 7."""
    relu, recipe, topk = ENGINES[name]
    je, te = _engines(topk_frozen, relu, recipe, topk, act, block_t)
    assert not je._stack_ok and not te._stack_ok and not te._network_ok
    x = topk_frozen["batches"][0][:, :length]
    counts = launch_counts()
    out = te(x)
    assert launch_counts() == counts
    assert out.dtype == torch.float32
    _engine_close(out.numpy(), np.asarray(je(jnp.asarray(x))))


@pytest.mark.parametrize("name", ["topk", "w32a32"])
def test_per_op_process_chunk_matches_jax(topk_frozen, name):
    """Two chunks of one block with carries (K4b's plain version) vs the
    JAX engine's chunks; the carries are requantized states."""
    relu, recipe, topk = ENGINES[name]
    je, te = _engines(topk_frozen, relu, recipe, topk)
    x = topk_frozen["batches"][1]
    jc = tc = None
    for start in (0, BLOCK):
        ref, jc = je.process_chunk(jnp.asarray(x[:, start:start + BLOCK]), jc)
        out, tc = te.process_chunk(x[:, start:start + BLOCK], tc)
        _engine_close(out.numpy(), np.asarray(ref))
    for (a_re, a_im), (b_re, b_im) in zip(tc, jc):
        np.testing.assert_allclose(a_re.numpy(), np.asarray(b_re), atol=1e-5)
        np.testing.assert_allclose(a_im.numpy(), np.asarray(b_im), atol=1e-5)


@pytest.mark.parametrize("act", [torch.float32, torch.bfloat16])
def test_per_op_chunked_equals_whole(topk_frozen, act):
    """Chunks of one block == one whole call, to the engine bar: the
    dense products see other row counts (the JAX package holds this to
    2e-3 too)."""
    _, te = _engines(topk_frozen, False, act=act)
    x = torch.from_numpy(topk_frozen["batches"][0])
    carries, parts = None, []
    for start in range(0, L, BLOCK):
        part, carries = te.process_chunk(x[:, start:start + BLOCK], carries)
        parts.append(part)
    _engine_close(torch.cat(parts, dim=1).numpy(), te(x).numpy())
    with pytest.raises(ValueError, match="divisible"):
        te.process_chunk(x[:, :BLOCK + 3])


def test_state_topk_chunked_streaming_raises(topk_frozen):
    """As in the JAX package: a relufied top-k engine serves whole
    sequences only."""
    je, te = _engines(topk_frozen, True)
    x = topk_frozen["batches"][0][:, :BLOCK]
    for eng, arr in ((je, jnp.asarray(x)), (te, x)):
        with pytest.raises(NotImplementedError, match="state top-k"):
            eng.process_chunk(arr)


def test_streaming_from_per_op_engine_matches_jax(topk_frozen):
    """``StreamingDenoiser.from_engine`` over the top-k engine at 257
    bins: the per-op chunk route (K4b) on every forward, vs JAX."""
    cfg = topk_config(False)
    params, stats = _variables(cfg, 257, seed=9)
    rng = np.random.RandomState(10)
    cal_model = build_model(
        cfg, 257, 257, device="cpu", seed=0, scan_mode="sequential",
        q_config=quantization_recipes["w8a16"](static_quant=True,
                                               calibrating=True))
    batches = [torch.from_numpy((rng.rand(2, 24, 257) * 4 - 1).astype(
        np.float32)) for _ in range(2)]
    f_params, f_stats = calibrate(cal_model, from_flax(params, stats),
                                  batches)
    te = engine_from_frozen(cfg, f_params, f_stats, device="cpu",
                            act_dtype=torch.float32)
    assert te.cfg.topk == 0.5 and not te._stack_ok
    je = JaxEngine(
        f_params, f_stats,
        jax_recipes["w8a16"](static_quant=True, calibrating=False),
        JaxModelConfig.infer(f_params, glu_variant="half1",
                             relufication=False, prenorm=True, clip_eigs=True,
                             topk=0.5, approx_topk=True),
        act_dtype=jnp.float32, block_t=BLOCK)
    audio = (0.3 * rng.randn(2, 4096)).astype(np.float32)
    ref = JaxStreamingDenoiser.from_engine(je, batch_size=2).process_offline(
        audio, chunk_samples=1024)
    out = StreamingDenoiser.from_engine(te, batch_size=2).process_offline(
        audio, chunk_samples=1024)
    assert out.shape == ref.shape and out.shape[1] > 3500
    np.testing.assert_allclose(out, ref, atol=2e-3, rtol=0)


@pytest.mark.parametrize("act", [torch.float32, torch.bfloat16])
def test_forced_per_op_matches_stack_and_jax(topk_frozen, act):
    """An engine without top-k, its per-op route forced the JAX tests'
    way (clearing ``_stack_ok``): vs its own stack route (float32
    activations: the stack route does not round the mixer input to bf16)
    and vs the JAX engine's forced per-op route."""
    je, te = _engines(topk_frozen, True, topk=1.0, act=act)
    assert te._stack_ok and te._network_ok
    x = topk_frozen["batches"][1]
    stack = te(x).numpy()
    je._stack_ok = te._stack_ok = False
    per_op = te(x).numpy()
    _engine_close(per_op, np.asarray(je(jnp.asarray(x))))
    if act == torch.float32:
        _engine_close(per_op, stack)
