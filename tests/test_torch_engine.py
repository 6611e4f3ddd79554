"""The port's W8A16 engine against the JAX package's, on the CPU: packing
(exactly equal), one layer's plain version against the Pallas whole-layer
kernels in interpret mode, the whole engine against the JAX engine, the
port's own route invariants (exact) and its refusals. Both engines are
built from the SAME frozen tree (the JAX calibration of
``tests/test_torch_quantize.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsernns_tpu.fxp.derive import FxpModelConfig as JaxModelConfig
from sparsernns_tpu.ops.pallas.fused_layer import (fused_layer_apply,
                                                   fused_layer_apply_carry)
from sparsernns_tpu.quantize.config import quantization_recipes as jax_recipes
from sparsernns_tpu.quantize.engine import W8A16Engine as JaxEngine
from sparsernns_tpu_torch.fxp.derive import FxpModelConfig
from sparsernns_tpu_torch.ops.cuda import engine_network
from sparsernns_tpu_torch.ops.cuda.engine_layer import (LayerMode,
                                                        engine_layer_plain)
from sparsernns_tpu_torch.quantize.config import quantization_recipes
from sparsernns_tpu_torch.quantize.engine import QWeight, W8A16Engine
from sparsernns_tpu_torch.utils.trace import launch_counts
from sparsernns_tpu_torch.weights import from_flax
from tests.test_torch_quantize import (D_IO, H, LAYERS, frozen,  # noqa: F401
                                       jax_model, port_model)

JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _cfg_kw(glu="half1", relu=True, prenorm=True):
    return dict(glu_variant=glu, relufication=relu, prenorm=prenorm,
                clip_eigs=True)


def jax_eng(frozen, recipe="w8a16", act=torch.float32, block_t=32, **kw):  # noqa: F811
    q = jax_recipes[recipe](static_quant=True, calibrating=False)
    return JaxEngine(
        frozen["frozen_params"], frozen["frozen_stats"], q,
        JaxModelConfig.infer(frozen["frozen_params"], **_cfg_kw(**kw)),
        act_dtype=JAX_DTYPE[act], block_t=block_t)


def port_eng(frozen, recipe="w8a16", act=torch.float32, block_t=32,  # noqa: F811
             engine_kw=None, **kw):
    q = quantization_recipes[recipe](static_quant=True, calibrating=False)
    return W8A16Engine(
        frozen["frozen_params"], frozen["frozen_stats"], q,
        FxpModelConfig.infer(frozen["frozen_params"], **_cfg_kw(**kw)),
        act_dtype=act, block_t=block_t, device="cpu", **(engine_kw or {}))


def test_engine_packing_equals_jax(frozen):  # noqa: F811
    """Every packed int8 array and every static scale / requant tuple is
    the JAX engine's; weights are int8 storage."""
    je, te = jax_eng(frozen, glu="full"), port_eng(frozen, glu="full")
    for name in ("encoder_kernel", "decoder_kernel"):
        a, b = getattr(je, name), getattr(te, name)
        assert isinstance(b, QWeight) and b.data.dtype == torch.int8
        assert a.scale == b.scale
        np.testing.assert_array_equal(np.asarray(a.data), b.data.numpy())
    np.testing.assert_array_equal(np.asarray(je.encoder_bias),
                                  te.encoder_bias.numpy())
    assert len(te.layers) == LAYERS and te.state_channels == je.state_channels
    for a, b in zip(je.layers, te.layers):
        assert b.w_b.dtype == torch.int8 and b.w_c.dtype == torch.int8
        for name in ("w_b", "w_c", "d", "norm_w", "norm_b", "out2_bias",
                     "out1_bias"):
            np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                          getattr(b, name).numpy(), name)
        for name in ("out2_kernel", "out1_kernel"):
            assert getattr(b, name).data.dtype == torch.int8
            assert getattr(a, name).scale == getattr(b, name).scale
            np.testing.assert_array_equal(np.asarray(getattr(a, name).data),
                                          getattr(b, name).data.numpy())
        for i in range(2):
            np.testing.assert_array_equal(np.asarray(a.lam[i]),
                                          b.lam[i].numpy())
        for name in ("wb_scales", "wc_scales", "state_requant",
                     "residual_requant"):
            assert getattr(a, name) == getattr(b, name), name
        assert b.state_requant[2] == 16 and b.residual_requant[1] == 16


def test_engine_packing_wide_recipes(frozen):  # noqa: F811
    """w16a16 packs int16 weights; a recipe without bits keeps float
    weights and no requant; both run."""
    x = torch.from_numpy(frozen["batches"][0])
    e16 = port_eng(frozen, recipe="w16a16")
    assert e16.layers[0].w_b.dtype == torch.int16
    ref = np.asarray(jax_eng(frozen, recipe="w16a16")(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(e16(x).numpy(), ref, atol=2e-3, rtol=0)
    e_none = port_eng(frozen, recipe="none")
    assert e_none.layers[0].w_b.dtype == torch.float32
    assert e_none.layers[0].residual_requant is None
    assert e_none.layers[0].wb_scales is None
    ref = np.asarray(jax_eng(frozen, recipe="none")(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(e_none(x).numpy(), ref, atol=2e-3, rtol=0)


def _jax_layer_args(layer, glu):
    """Positional operands and static scales of fused_layer_apply for one
    layer of the JAX engine."""
    args, scales = JaxEngine._layer_kernel_args(layer, glu)
    return (layer.lam, layer.w_b, layer.w_c, layer.d, layer.norm_w,
            layer.norm_b), args, scales


@pytest.mark.parametrize("prenorm", [True, False])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("glu", ["full", "half1", "half2", "none"])
def test_layer_plain_matches_pallas_layer(frozen, glu, relu, prenorm):  # noqa: F811
    """engine_layer_plain vs fused_layer_apply_carry (non-zero carry in,
    carry out, two time blocks) and vs fused_layer_apply (zero carry) for
    layer 1 over an int16-code stream in and out: codes differ by at most
    1 in at most 0.5 % of elements; carries atol 1e-5 * max|x|, but for at
    most one of the 16 carry elements one step of the state grid. Measured
    over the 16 cases: stream codes equal in 15, and one code of 384 one
    step apart in one (half2, gelu, postnorm, no-carry kernel: 0.26 %); in
    the postnorm cases one carry element differs by one state code
    (3.8e-6), in the prenorm cases none."""
    kw = dict(glu=glu, relu=relu, prenorm=prenorm)
    je, te = jax_eng(frozen, block_t=8, **kw), port_eng(frozen, block_t=8,
                                                        **kw)
    jl, tl = je.layers[1], te.layers[1]
    in_rq = te.layers[0].residual_requant
    rng = np.random.RandomState(11)
    codes = rng.randint(-3000, 3000, size=(2, 16, H)).astype(np.int16)
    p = tl.p
    carry = tuple((rng.randn(2, p) * 20 * tl.state_requant[0])
                  .astype(np.float32) for _ in range(2))
    mode = LayerMode(prenorm=prenorm, relufication=relu, glu=glu,
                     relu_state=relu, act_dtype=torch.float32)
    out, new_c = engine_layer_plain(
        torch.from_numpy(codes), tl, mode, block_t=8, in_requant=in_rq,
        carry=tuple(torch.from_numpy(c) for c in carry))
    assert out.dtype == torch.int16

    ops, args, scales = _jax_layer_args(jl, glu)
    r_pad = jnp.pad(jnp.asarray(codes), ((0, 0), (0, 0), (0, 128 - H)))
    common = dict(block_t=8, prenorm=prenorm, relufication=relu, glu=glu,
                  relu_state=relu, in_requant=in_rq,
                  out_requant=jl.residual_requant,
                  block_requant=jl.state_requant, wb_scales=jl.wb_scales,
                  wc_scales=jl.wc_scales, act_dtype=jnp.float32, **scales)
    ref, ref_c = fused_layer_apply_carry(
        r_pad, tuple(jnp.asarray(c) for c in carry), *ops, **args, **common)
    diff = np.abs(out.numpy().astype(int)
                  - np.asarray(ref)[:, :, :H].astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.005, diff.max()
    # the carry is a requantized state: on a float32 tie between the two
    # summation orders its code moves by one step of the state grid
    scale = max(np.abs(np.asarray(c)).max() for c in ref_c)
    for a, b, step in zip(new_c, ref_c, tl.state_requant[:2]):
        diff = np.abs(a.numpy() - np.asarray(b))
        assert diff.max() <= max(1e-5 * scale, 1.001 * step), diff.max()
        assert (diff > 1e-5 * scale).sum() <= 1, diff
    # the no-carry kernel
    ref0 = fused_layer_apply(r_pad, *ops, **args, **common)
    out0 = engine_layer_plain(torch.from_numpy(codes), tl, mode, block_t=8,
                              in_requant=in_rq)
    diff = np.abs(out0.numpy().astype(int)
                  - np.asarray(ref0)[:, :, :H].astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.005, diff.max()


@pytest.mark.parametrize("act", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block_t,length", [(8, 24), (16, 23), (32, 24)])
def test_engine_matches_jax_engine(frozen, act, block_t, length):  # noqa: F811
    """Whole engine vs the JAX engine (its network route): time blocks of
    8, of 16 with a short last block of 7, and one block t = L. Limits:
    max abs error 2e-3 * max(1, |ref|), mean 1e-4 * max(1, |ref|).
    Measured: 0 in all six cases."""
    x = frozen["batches"][0][:, :length]
    ref = np.asarray(jax_eng(frozen, act=act, block_t=block_t)(
        jnp.asarray(x)))
    out = port_eng(frozen, act=act, block_t=block_t)(x).numpy()
    assert out.shape == ref.shape == (2, length, D_IO)
    scale = max(1.0, np.abs(ref).max())
    assert np.abs(out - ref).max() <= 2e-3 * scale
    assert np.abs(out - ref).mean() <= 1e-4 * scale


@pytest.mark.parametrize("act,block_t,length", [
    (torch.float32, 32, 24),     # one block, t == L
    (torch.float32, 8, 24),      # aligned blocks
    (torch.float32, 16, 23),     # 16 + a short block of 7
    (torch.bfloat16, 16, 23)])   # bf16 stream, short last block
def test_network_route_equals_stack_route(frozen, act, block_t, length):  # noqa: F811
    x = torch.from_numpy(frozen["batches"][0][:, :length])
    e_net = port_eng(frozen, act=act, block_t=block_t)
    assert e_net._network_ok
    e_stk = port_eng(frozen, act=act, block_t=block_t)
    e_stk._network_ok = False
    assert torch.equal(e_net(x), e_stk(x))


def test_engine_bf16_io(frozen):  # noqa: F811
    """bf16 magnitudes in -> bf16 mask out on both routes, the routes
    still bit-identical, within 0.02 * max(1, |ref|) of the f32-io mask."""
    x = torch.from_numpy(frozen["batches"][0])
    e_net = port_eng(frozen, act=torch.bfloat16)
    y16 = e_net(x.to(torch.bfloat16))
    assert y16.dtype == torch.bfloat16
    y32 = e_net(x)
    assert y32.dtype == torch.float32
    dev = (y16.float() - y32).abs().max().item()
    assert dev <= 0.02 * max(1.0, y32.abs().max().item())
    e_stk = port_eng(frozen, act=torch.bfloat16)
    e_stk._network_ok = False
    y16s = e_stk(x.to(torch.bfloat16))
    assert y16s.dtype == torch.bfloat16 and torch.equal(y16, y16s)


def test_engine_tracks_static_quant_model(frozen):  # noqa: F811
    """The engine (blockwise state requant, float dots) tracks the frozen
    static-quant model (per-step requant) within the JAX package's budget
    (tests/test_engine.py): max rel < 0.10, mean rel < 0.005, correlation
    with the float output > 0.95."""
    x = frozen["batches"][0]
    model = port_model(quantization_recipes["w8a16"](
        static_quant=True, calibrating=False))
    model.load_state_dict(from_flax(frozen["frozen_params"],
                                    frozen["frozen_stats"]))
    with torch.no_grad():
        y_q = model(torch.from_numpy(x)).numpy()
    y_e = port_eng(frozen, glu="full", act=torch.bfloat16)(x).numpy()
    denom = max(np.abs(y_q).max(), 1.0)
    assert np.abs(y_e - y_q).max() / denom < 0.10
    assert np.abs(y_e - y_q).mean() / denom < 0.005
    assert np.corrcoef(y_e.ravel(), frozen["y_fp"].ravel())[0, 1] > 0.95


def test_state_channel_compaction(frozen):  # noqa: F811
    """A state channel whose B row and C column are zero is dropped, and
    the output does not change."""
    import copy
    pruned = copy.deepcopy(frozen)
    mixer = pruned["frozen_params"]["encoder"]["layers_0"]["mixer"]
    mixer["B"] = np.array(mixer["B"])
    mixer["C"] = np.array(mixer["C"])
    mixer["B"][[1, 5]] = 0.0
    mixer["C"][:, [1, 5]] = 0.0
    x = frozen["batches"][0]
    e_c = port_eng(pruned)
    e_d = port_eng(pruned, engine_kw=dict(compact_state=False))
    assert e_c.state_channels[0] == (8, 6) and e_c.layers[0].p == 6
    assert e_d.state_channels[0] == (8, 8)
    np.testing.assert_allclose(e_c(x).numpy(), e_d(x).numpy(), atol=1e-5)
    assert e_c.init_stream_state(3)[0][0].shape == (3, 6)


def test_engine_refusals(frozen):  # noqa: F811
    """Every mode the port leaves out raises and names what is missing;
    model-dim top-k and a residual requant wider than 16 bits are served
    by the per-op route instead. The integer-dot modes (``mxu16=True``,
    activations of 8 bits) build engines on the kernel routes."""
    e16 = port_eng(frozen, engine_kw=dict(mxu16=True))
    assert e16.mxu16["requested"] and e16._network_ok
    e8 = port_eng(frozen, recipe="w8a8")
    assert e8.encoder_in_scale[1] == 8 and e8._network_ok
    # the kernel-free route builds when asked for, and only then
    xla = port_eng(frozen, engine_kw=dict(route="xla", mxu16=True))
    assert xla.route == "xla" and not xla._stack_ok and not xla._network_ok
    assert not any(xla.mxu16[k] for k in ("mixer", "state", "dense",
                                          "requants"))
    with pytest.raises(ValueError, match="route"):
        port_eng(frozen, engine_kw=dict(route="fast"))
    wide = port_eng(frozen, recipe="w32a32")
    assert wide.layers[0].residual_requant[1] == 32
    assert not wide._stack_ok and not wide._network_ok
    q = quantization_recipes["w8a16"](static_quant=True, calibrating=False)
    cfg = FxpModelConfig.infer(frozen["frozen_params"], topk=0.5,
                               approx_topk=True, **_cfg_kw())
    topk = W8A16Engine(frozen["frozen_params"], frozen["frozen_stats"], q,
                       cfg, device="cpu")
    assert not topk._stack_ok and not topk._network_ok
    with pytest.raises(NotImplementedError, match="state top-k"):
        topk.process_chunk(frozen["batches"][0])
    import copy
    sparse = copy.deepcopy(frozen)
    k = np.array(sparse["frozen_params"]["decoder"]["kernel"])
    k[:8] = 0.0
    sparse["frozen_params"]["decoder"]["kernel"] = k
    # enough zero tiles: a block-sparse pack (K7), off the network route
    bs = port_eng(sparse, engine_kw=dict(block_sparse_dense=(8, 16)))
    assert bs.dense_blocks == {"decoder": (1, 2)}
    assert bs._stack_ok and not bs._network_ok
    dense = port_eng(sparse, engine_kw=dict(block_sparse_dense=None))
    assert dense.dense_blocks == {} and dense._network_ok
    # from_artifacts reads the conversion pipeline's store; a directory
    # without one is refused
    with pytest.raises(FileNotFoundError, match="frozen_params"):
        W8A16Engine.from_artifacts("runs", None, device="cpu")
    # row_pair is a TPU schedule with the same bits: accepted, no effect
    x = torch.from_numpy(frozen["batches"][0])
    assert torch.equal(port_eng(frozen, engine_kw=dict(row_pair=True))(x),
                       port_eng(frozen)(x))


def test_network_kernel_layer_limit(frozen):  # noqa: F811
    """One network launch takes at most MAX_LAYERS layers; the engine keeps
    the per-layer stack for deeper models (same bits)."""
    eng = port_eng(frozen)
    x = torch.from_numpy(frozen["batches"][0])
    deep = eng.layers * 5
    assert len(deep) > engine_network.MAX_LAYERS
    with pytest.raises(ValueError, match="layers"):
        engine_network.engine_network(x, eng._enc, deep, eng._dec, eng.mode,
                                      block_t=8)
    ref = eng(x)
    eng.layers = eng.layers * 4          # 8 layers: still one launch
    assert eng._fused_network_eligible()
    y8 = eng(x)
    eng._network_ok = False
    assert torch.equal(eng(x), y8) and not torch.equal(y8, ref)
    eng.layers = deep
    assert not eng._fused_network_eligible()


def test_engine_defaults_and_cpu_counters(frozen):  # noqa: F811
    """block_t=None is 512 (no autotune file is read); on the CPU no kernel
    launch is counted."""
    before = launch_counts()
    eng = port_eng(frozen, block_t=None)
    assert eng.block_t == 512
    eng(frozen["batches"][0])
    eng.process_chunk(frozen["batches"][0])
    assert launch_counts() == before
