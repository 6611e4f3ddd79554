"""The port's static quantization against the JAX package's, on the CPU:
qparams and quant-dequant arithmetic, calibration (every frozen scale
equal), the frozen static-quant inference model, and weight packing rules.
The same numpy inputs and the same flax weights go through both.

Size as ``tests/test_static_quant.py``: H = 12, d_io = 9, P = 8 (16 in 2
blocks, conj-sym), 2 layers, L = 24, B = 2. ``frozen`` runs the JAX
calibration once per module; the engine tests import it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsernns_tpu.models.seq_model import RegressionModel as JaxRegression
from sparsernns_tpu.models.ssm import make_ssm_init_fn
from sparsernns_tpu.models.ssm_init import blocked_dplr_init
from sparsernns_tpu.quantize import engine as jax_engine
from sparsernns_tpu.quantize import static as jax_static
from sparsernns_tpu.quantize.calibrate import calibrate as jax_calibrate
from sparsernns_tpu.quantize.config import QuantScheme as JaxScheme
from sparsernns_tpu.quantize.config import quantization_recipes as jax_recipes
from sparsernns_tpu_torch.quantize import engine as t_engine
from sparsernns_tpu_torch.quantize import static as t_static
from sparsernns_tpu_torch.quantize.calibrate import calibrate
from sparsernns_tpu_torch.quantize.config import (QuantizationConfig,
                                                  QuantScheme,
                                                  quantization_recipes)
from sparsernns_tpu_torch.train.loop import build_model
from sparsernns_tpu_torch.utils.config import RunConfig
from sparsernns_tpu_torch.weights import flat_leaves, from_flax, to_flax

H, D_IO, P_SIZE, LAYERS, L, B = 12, 9, 16, 2, 24, 2


def jax_model(q_config, glu="full", relu=True, prenorm=True,
              scan_mode="sequential"):
    init = blocked_dplr_init(P_SIZE, 2, conj_sym=True)
    mixer = make_ssm_init_fn(
        h=H, p=init["P"], lambda_init=init["Lambda"], v=init["V"],
        vinv=init["Vinv"], clip_eigs=True, relufication=relu,
        q_config=q_config, scan_mode=scan_mode, block_t=8)
    return JaxRegression(
        mixer_cls=mixer, n_layers=LAYERS, d_model=H, d_output=D_IO,
        dropout=0.0, prenorm=prenorm, batchnorm=True, glu_variant=glu,
        training=False, relufication=relu, q_config=q_config)


def port_config(glu="full", relu=True, prenorm=True, **kw) -> RunConfig:
    return dataclasses.replace(
        RunConfig(), n_layers=LAYERS, d_model=H, ssm_size_base=P_SIZE,
        blocks=2, glu_variant=glu, relufication=relu, prenorm=prenorm,
        **{"scan_mode": "fused", **kw})


def port_model(q_config=None, **kw):
    return build_model(
        port_config(**kw), D_IO, D_IO, device="cpu", seed=0,
        q_config=q_config,
        scan_mode="sequential" if q_config is not None else None)


@pytest.fixture(scope="module")
def frozen():
    """Float flax weights (full GLU, relufication, prenorm BatchNorm with
    random statistics), two calibration batches, and the JAX package's
    frozen w8a16 tree. The JAX calibration creates its variables on a zeros
    example with the float model's key, so its observers start where the
    port's do."""
    rng = np.random.RandomState(0)
    batches = [(0.5 * rng.randn(B, L, D_IO)).astype(np.float32)
               for _ in range(2)]
    zeros = jnp.zeros((B, L, D_IO), jnp.float32)
    fp_model = jax_model(jax_recipes["none"](), scan_mode="associative")
    variables = jax.device_get(fp_model.init(jax.random.PRNGKey(0), zeros))
    srng = np.random.RandomState(7)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (0.2 * srng.randn(*a.shape) if path[-1].key == "mean"
                         else srng.uniform(0.5, 1.5, a.shape)
                         ).astype(np.float32), variables["batch_stats"])
    cal_model = jax_model(jax_recipes["w8a16"](static_quant=True,
                                               calibrating=True))
    frozen_params, frozen_stats = jax.device_get(jax_calibrate(
        cal_model, jax.random.PRNGKey(0), zeros, variables["params"], stats,
        [jnp.asarray(b) for b in batches]))
    y_fp = np.asarray(fp_model.apply(
        {"params": variables["params"], "batch_stats": stats},
        jnp.asarray(batches[0])))
    return dict(params=variables["params"], stats=stats, batches=batches,
                frozen_params=frozen_params, frozen_stats=frozen_stats,
                y_fp=y_fp)


def _tie_inputs(seed: int, scale: float, bits: int) -> np.ndarray:
    """Seeded values with exact ties at .5 and values beyond the clip."""
    rng = np.random.RandomState(seed)
    qmax = 2 ** (bits - 1)
    ties = (np.arange(-8, 8) + 0.5) * scale
    beyond = np.array([-3.0, -1.5, 1.5, 3.0]) * qmax * scale
    body = rng.randn(200) * scale * qmax / 3
    return np.concatenate([ties, beyond, body]).astype(np.float32)


@pytest.mark.parametrize("bits,scale,zp", [(8, 2.0 ** -5, 0.0),
                                           (16, 2.0 ** -12, 0.0),
                                           (4, 0.25, 3.0)])
def test_quant_dequant_equals_jax(bits, scale, zp):
    x = _tie_inputs(bits, scale, bits)
    ref = np.asarray(jax_static.quant_dequant(
        jnp.asarray(x), jnp.float32(scale), zp, bits))
    out = t_static.quant_dequant(torch.from_numpy(x), torch.tensor(scale),
                                 zp, bits).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("scheme,pow2", [
    ("per_tensor_symmetric", True), ("per_tensor_symmetric", False),
    ("per_tensor_affine", True), ("per_channel_symmetric", True)])
def test_calculate_qparams_equals_jax(scheme, pow2):
    rng = np.random.RandomState(3)
    shape = (6,) if scheme.startswith("per_channel") else ()
    lo = -np.abs(rng.randn(*shape) * 3).astype(np.float32)
    hi = np.abs(rng.randn(*shape) * 5).astype(np.float32)
    for bits in (8, 16):
        ref = jax_static.calculate_qparams(
            jnp.asarray(lo), jnp.asarray(hi), bits, JaxScheme[scheme], pow2)
        out = t_static.calculate_qparams(
            torch.from_numpy(np.asarray(lo)), torch.from_numpy(np.asarray(hi)),
            bits, QuantScheme[scheme], pow2)
        for o, r in zip(out, ref):
            np.testing.assert_array_equal(o.numpy(), np.asarray(r))


@pytest.mark.parametrize("bits", [8, 16, 32, None])
def test_pow2_quantize_equals_jax(bits):
    rng = np.random.RandomState(bits or 0)
    w = (rng.randn(7, 5) * 0.3).astype(np.float32)
    w[0, :4] = np.array([0.5, 1.5, -0.5, 2.5]) * 2.0 ** -8   # ties
    q_ref, s_ref = jax_engine.pow2_quantize(w, bits)
    q, s = t_engine.pow2_quantize(w, bits)
    assert s == s_ref and q.dtype == q_ref.dtype
    np.testing.assert_array_equal(q, q_ref)
    np.testing.assert_array_equal(t_engine._pow2_quant_values(w, bits),
                                  jax_engine._pow2_quant_values(w, bits))


def test_recipes_equal_jax():
    assert set(quantization_recipes) == set(jax_recipes)
    for name in jax_recipes:
        for kw in ({}, dict(static_quant=True, calibrating=True)):
            ours = quantization_recipes[name](**kw)
            ref = jax_recipes[name](**kw)
            assert ours.to_dict() == ref.to_dict()
            assert QuantizationConfig.from_dict(ours.to_dict()) == ours


def test_observer_per_channel_and_affine():
    """The branches no recipe uses: per-channel observers keep one range
    per last-axis channel, and an affine FakeQuant stays on its grid."""
    obs = t_static.MinMaxObserver(QuantScheme.per_channel_symmetric)
    x = torch.tensor([[[1.0, -2.0, 0.5]], [[-3.0, 4.0, 0.25]]])
    obs(x)
    np.testing.assert_array_equal(obs.observer_min.numpy(), [-3.0, -2.0, 0.0])
    np.testing.assert_array_equal(obs.observer_max.numpy(), [1.0, 4.0, 0.5])
    fq = t_static.FakeQuant(bits=8, calibrating=True)
    assert fq(x) is x                      # passes through while calibrating
    assert float(fq.scale) == 2.0 ** -5    # 4 / 127 -> 2^-5


def test_calibration_scales_equal_jax(frozen):
    cal_model = port_model(quantization_recipes["w8a16"](
        static_quant=True, calibrating=True))
    params, stats = calibrate(
        cal_model, from_flax(frozen["params"], frozen["stats"]),
        [torch.from_numpy(b) for b in frozen["batches"]])
    ours = dict(flat_leaves(params))
    ref = dict(flat_leaves(frozen["frozen_params"]))
    assert set(ours) == set(ref)
    assert not any("observer" in "/".join(k) for k in ours)
    scales = [k for k in ref if k[-1] == "scale" and "norm" not in k]
    assert len(scales) == 2 * 2 + LAYERS * (13 + 4 + 2 + 1)
    for key in ref:
        a, b = np.asarray(ours[key]), np.asarray(ref[key])
        assert a.shape == b.shape and a.dtype == b.dtype, key
        np.testing.assert_array_equal(a, b, err_msg="/".join(key))
    ours_s = dict(flat_leaves(stats))
    ref_s = dict(flat_leaves(frozen["frozen_stats"]))
    assert set(ours_s) == set(ref_s)
    for key in ref_s:
        np.testing.assert_array_equal(ours_s[key], np.asarray(ref_s[key]))


def test_frozen_tree_round_trips(frozen):
    """from_flax -> inference model -> to_flax gives the tree back."""
    model = port_model(quantization_recipes["w8a16"](
        static_quant=True, calibrating=False))
    model.load_state_dict(from_flax(frozen["frozen_params"],
                                    frozen["frozen_stats"]))
    params, stats = to_flax(model)
    ref = dict(flat_leaves(frozen["frozen_params"]))
    assert set(dict(flat_leaves(params))) == set(ref)
    for key, val in flat_leaves(params):
        np.testing.assert_array_equal(val, np.asarray(ref[key]))
    for key, val in flat_leaves(stats):
        np.testing.assert_array_equal(
            val, np.asarray(dict(flat_leaves(frozen["frozen_stats"]))[key]))


def test_static_quant_model_matches_jax(frozen):
    """Frozen static-quant inference (sequential scan, per-step state
    requant) vs JAX on the JAX frozen tree: atol 1e-4 * max(1, |ref|), at
    most 0.5 % of outputs beyond it (a per-step requant can flip one code
    on a float32 tie). Measured: max difference 0."""
    q_ref = jax_recipes["w8a16"](static_quant=True, calibrating=False)
    x = frozen["batches"][0]
    ref = np.asarray(jax_model(q_ref).apply(
        {"params": frozen["frozen_params"],
         "batch_stats": frozen["frozen_stats"]}, jnp.asarray(x)))
    model = port_model(quantization_recipes["w8a16"](
        static_quant=True, calibrating=False))
    model.load_state_dict(from_flax(frozen["frozen_params"],
                                    frozen["frozen_stats"]))
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    off = np.abs(out - ref) > 1e-4 * np.maximum(1.0, np.abs(ref))
    assert off.mean() <= 0.005, off.mean()
    assert np.abs(out - ref).max() <= 0.05 * max(1.0, np.abs(ref).max())


def test_quantized_dense_and_encode_match_jax(frozen):
    from sparsernns_tpu.fxp.derive import FxpModelConfig as JaxCfg
    from sparsernns_tpu_torch.fxp.derive import FxpModelConfig
    k = np.array(frozen["frozen_params"]["encoder"]["encoder"]["kernel"])
    bias = np.array(frozen["frozen_params"]["encoder"]["encoder"]["bias"])
    x = frozen["batches"][1]
    q, s = t_engine.pow2_quantize(k, 8)
    ref = jax_engine.engine_encode(
        JaxCfg.infer(frozen["frozen_params"], relufication=True),
        jax_engine.QWeight(jnp.asarray(q), s), jnp.asarray(bias),
        jnp.asarray(x), out_spec=(2.0 ** -6, 8))
    out = t_engine.engine_encode(
        FxpModelConfig.infer(frozen["frozen_params"], relufication=True),
        t_engine.QWeight(torch.from_numpy(q), s), torch.from_numpy(bias),
        torch.from_numpy(x), out_spec=(2.0 ** -6, 8))
    # one code of the 2^-6 grid where the two matmuls round a tie apart
    assert np.abs(out.numpy() - np.asarray(ref)).max() <= 2.0 ** -6
    assert (out.numpy() != np.asarray(ref)).mean() <= 0.005
    # the integer dots on the codes of a frozen input grid (one plane at 8
    # bits, two at 16) equal JAX's bit for bit: the dots are exact
    w_t = torch.from_numpy(q)
    for spec in ((2.0 ** -5, 8), (2.0 ** -12, 16)):
        ref = jax_engine.quantized_dense(
            jnp.asarray(x), jax_engine.QWeight(jnp.asarray(q), s),
            jnp.asarray(bias), spec)
        out = t_engine.quantized_dense(
            torch.from_numpy(x),
            t_engine.QWeight(w_t, s, t_engine.weight_colsum(w_t)),
            torch.from_numpy(bias), spec)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_build_model_quant_refusals():
    cfg = port_config()
    sq = quantization_recipes["w8a16"](static_quant=True, calibrating=False)
    with pytest.raises(NotImplementedError, match="sequential"):
        build_model(cfg, D_IO, D_IO, device="cpu", q_config=sq)
    # a dynamic recipe builds the quantization-aware (QAT) model
    qat = build_model(cfg, D_IO, D_IO, device="cpu",
                      q_config=quantization_recipes["w8a16"]())
    assert qat.q_config.any_quantized and not qat.q_config.static_quant
    assert qat.decoder.w_bits == 8 and qat.decoder.a_bits == 16
    model = build_model(cfg, D_IO, D_IO, device="cpu", q_config=sq,
                        scan_mode="sequential")
    carry = (torch.zeros(1, 8), torch.zeros(1, 8))
    with pytest.raises(NotImplementedError, match="process_chunk"):
        model.encoder.layers[0].mixer.forward_stream(
            torch.zeros(1, 4, H), carry)
