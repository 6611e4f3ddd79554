"""The port's W8A16 engine in its integer-dot modes against the JAX
package's, on the CPU: w8a8 and w8a8A8 (the denses' int8 dots on the codes
of their frozen input grids) and w8a16 with ``mxu16=True`` (every dot site
on the two int8 planes of the 16-bit codes, and the static-quant model's
quant_but / quant_yt / quant_output requants). Frozen trees: the JAX
calibration at each recipe (w8a16: ``tests/test_torch_quantize.py``'s).

Tolerances:

- packing, grids, colsums, the ``mxu16`` dict, the route flags and every
  demotion: equal to the JAX engine's;
- the plain layer in an integer mode against the Pallas layer kernel
  (interpret mode): stream codes at most 1 apart in at most 0.5 % of the
  elements (the float-dot mode's bar, ``tests/test_torch_engine.py``);
  carries atol 1e-5 * max|x|, but for at most one element one step of
  the state grid (a requant tie between two summation orders);
- the engine against the JAX engine on the network, stack and per-op
  routes: max 2e-3 * max(1, |ref|), mean 1e-4 * max(1, |ref|);
- the port's network route = its stack route, and mxu16 chunked = whole
  at ``block_t``: bit for bit;
- the engine against the frozen static-quant model at the JAX package's
  own bars: w8a8 max 0.15 / mean 0.02, mxu16 max 0.12 / mean 0.005, of
  max(1, |ref|) (``tests/test_engine.py``);
- the port's calibration at w8a8 and w8a8A8: every frozen scale equal to
  JAX's.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsernns_tpu.fxp.derive import FxpModelConfig as JaxModelConfig
from sparsernns_tpu.ops import intdot as jax_intdot
from sparsernns_tpu.ops.pallas.fused_layer import (fused_layer_apply,
                                                   fused_layer_apply_carry)
from sparsernns_tpu.quantize.calibrate import calibrate as jax_calibrate
from sparsernns_tpu.quantize.config import quantization_recipes as jax_recipes
from sparsernns_tpu.quantize.engine import W8A16Engine as JaxEngine
from sparsernns_tpu_torch.fxp.derive import FxpModelConfig
from sparsernns_tpu_torch.ops.cuda.engine_layer import (LayerMode,
                                                        engine_layer_plain)
from sparsernns_tpu_torch.quantize.calibrate import calibrate
from sparsernns_tpu_torch.quantize.config import quantization_recipes
from sparsernns_tpu_torch.quantize.engine import W8A16Engine
from sparsernns_tpu_torch.serve.streaming import StreamingDenoiser
from sparsernns_tpu_torch.weights import flat_leaves, from_flax
from tests.test_torch_quantize import (B, D_IO, H, L, frozen,  # noqa: F401
                                       jax_model, port_model)

#: (recipe, mxu16) of the modes under test; the tree is the recipe's own
MODES = [("w8a8", False), ("w8a8A8", False), ("w8a16", True)]
MODE_IDS = ["w8a8", "w8a8A8", "w8a16-mxu16"]


@pytest.fixture(scope="module")
def trees(frozen):  # noqa: F811
    """recipe -> the JAX package's frozen (params, stats) at that recipe,
    from the float weights and calibration batches of ``frozen``."""
    zeros = jnp.zeros((B, L, D_IO), jnp.float32)
    out = {"w8a16": (frozen["frozen_params"], frozen["frozen_stats"])}
    for recipe in ("w8a8", "w8a8A8"):
        cal = jax_model(jax_recipes[recipe](static_quant=True,
                                            calibrating=True))
        out[recipe] = jax.device_get(jax_calibrate(
            cal, jax.random.PRNGKey(0), zeros, frozen["params"],
            frozen["stats"], [jnp.asarray(b) for b in frozen["batches"]]))
    return out


def _cfg_kw(glu="full", topk=1.0):
    return dict(glu_variant=glu, relufication=True, prenorm=True,
                clip_eigs=True, topk=topk, approx_topk=topk < 1.0)


def jax_eng(tree, recipe, mxu16=False, block_t=8, **kw):
    q = jax_recipes[recipe](static_quant=True, calibrating=False)
    return JaxEngine(tree[0], tree[1], q,
                     JaxModelConfig.infer(tree[0], **_cfg_kw(**kw)),
                     act_dtype=jnp.float32, block_t=block_t, mxu16=mxu16)


def port_eng(tree, recipe, mxu16=False, block_t=8, **kw):
    q = quantization_recipes[recipe](static_quant=True, calibrating=False)
    return W8A16Engine(tree[0], tree[1], q,
                       FxpModelConfig.infer(tree[0], **_cfg_kw(**kw)),
                       act_dtype=torch.float32, block_t=block_t,
                       mxu16=mxu16, device="cpu")


LAYER_GRIDS = ("out2_in_scale", "out1_in_scale", "mixer_in16", "state16",
               "but_requant", "yt_requant", "out2_out_requant",
               "out1_out_requant", "residual_requant", "state_requant")
ENGINE_GRIDS = ("encoder_in_scale", "decoder_in_scale",
                "encoder_out_requant", "decoder_out_requant")


def _same_sites(je, te):
    """Every integer-dot site, grid and route decision of the two engines
    is the same."""
    for name in ENGINE_GRIDS:
        assert getattr(je, name) == getattr(te, name), name
    for a, b in zip(je.layers, te.layers):
        for name in LAYER_GRIDS:
            assert getattr(a, name) == getattr(b, name), name
    assert je.mxu16 == te.mxu16
    assert (je._stack_ok, je._network_ok) == (te._stack_ok, te._network_ok)


@pytest.mark.parametrize("recipe,mxu16", MODES, ids=MODE_IDS)
def test_int_sites_and_colsums_equal_jax(trees, recipe, mxu16):
    """Grids of every integer site, mxu16's requants, the ``mxu16`` dict
    and the route flags equal JAX's; the colsum rows equal JAX's
    ``weight_colsum`` of the packed int8 weights."""
    je = jax_eng(trees[recipe], recipe, mxu16)
    te = port_eng(trees[recipe], recipe, mxu16)
    _same_sites(je, te)
    bits = 16 if mxu16 else 8
    assert te.encoder_in_scale[1] == te.decoder_in_scale[1] == bits
    assert all(lp.out2_in_scale[1] == bits and lp.out1_in_scale[1] == bits
               for lp in te.layers)
    if mxu16:
        assert te.mxu16 == {"requested": True, "mixer": True, "state": True,
                            "dense": True, "requants": True}
    else:
        assert te.mxu16["dense"] and not te.mxu16["mixer"]
    assert te._network_ok and te._stack_ok
    for w in (te.encoder_kernel, te.decoder_kernel):
        np.testing.assert_array_equal(
            w.colsum.numpy(), np.asarray(jax_intdot.weight_colsum(
                w.data.numpy())))
    for lp in te.layers:
        p = lp.p
        for cs, w in ((lp.cs_wb, lp.w_b), (lp.cs_wc_re, lp.w_c[:p]),
                      (lp.cs_wc_im, lp.w_c[p:]),
                      (lp.out2_kernel.colsum, lp.out2_kernel.data)):
            np.testing.assert_array_equal(
                cs.numpy(), np.asarray(jax_intdot.weight_colsum(w.numpy())))


def test_demotions_equal_jax(trees):
    """The JAX engine's demotions, applied alike: int16 weight packs keep
    the mixer and state sites off (w16a16); a top-k engine (per-op route)
    drops mxu16 entirely but keeps 8-bit grids; one layer without its
    quant_ut or its GLU quant_input scale turns that site off in every
    layer (all or none)."""
    tree16 = trees["w8a16"]
    for recipe, kw in (("w16a16", {}), ("w8a16", dict(topk=0.5)),
                       ("w8a8", dict(topk=0.5))):
        je = jax_eng(tree16 if recipe != "w8a8" else trees["w8a8"], recipe,
                     True, **kw)
        te = port_eng(tree16 if recipe != "w8a8" else trees["w8a8"], recipe,
                      True, **kw)
        _same_sites(je, te)
        if recipe == "w16a16":
            assert not te.mxu16["mixer"] and not te.mxu16["state"]
        elif recipe == "w8a16":
            assert not te._stack_ok and te.mxu16 == {
                "requested": True, "mixer": False, "state": False,
                "dense": False, "requants": False}
        else:
            assert te.encoder_in_scale == (te.encoder_in_scale[0], 8)
    cut = copy.deepcopy(tree16[0])
    del cut["encoder"]["layers_1"]["mixer"]["quant_ut"]
    del cut["encoder"]["layers_0"]["out2"]["quant_input"]
    je = jax_eng((cut, tree16[1]), "w8a16", True)
    te = port_eng((cut, tree16[1]), "w8a16", True)
    _same_sites(je, te)
    assert te.layers[0].mixer_in16 is None and te.layers[0].state16
    assert all(lp.out2_in_scale is None for lp in te.layers)
    assert all(lp.out1_in_scale is not None for lp in te.layers)


def _layer_case(trees, recipe, mxu16, glu):
    je = jax_eng(trees[recipe], recipe, mxu16, glu=glu)
    te = port_eng(trees[recipe], recipe, mxu16, glu=glu)
    return je.layers[1], te.layers[1], te.layers[0].residual_requant


@pytest.mark.parametrize("glu", ["full", "half1"])
@pytest.mark.parametrize("recipe,mxu16", MODES, ids=MODE_IDS)
def test_layer_plain_matches_pallas_layer(trees, recipe, mxu16, glu):
    """engine_layer_plain in an integer mode against fused_layer_apply
    (zero carry) and fused_layer_apply_carry (a carry on the state grid,
    two time blocks) in interpret mode, layer 1 over a stream of codes of
    layer 0's requant grid: the module's bars."""
    jl, tl, in_rq = _layer_case(trees, recipe, mxu16, glu)
    bits = in_rq[1]
    rng = np.random.RandomState(5)
    qmax = 2 ** (bits - 1)
    dt = np.int8 if bits <= 8 else np.int16
    codes = rng.randint(-qmax // 8, qmax // 8, size=(2, 16, H)).astype(dt)
    p = tl.p
    s_re, s_im, _ = tl.state_requant
    carry = tuple((np.round(rng.randn(2, p) * 20) * s).astype(np.float32)
                  for s in (s_re, s_im))
    mode = LayerMode(prenorm=True, relufication=True, glu=glu,
                     relu_state=True, act_dtype=torch.float32)
    args, scales = JaxEngine._layer_kernel_args(jl, glu)
    r_pad = jnp.pad(jnp.asarray(codes), ((0, 0), (0, 0), (0, 128 - H)))
    common = dict(block_t=8, prenorm=True, relufication=True, glu=glu,
                  relu_state=True, in_requant=in_rq,
                  out_requant=jl.residual_requant,
                  block_requant=jl.state_requant, wb_scales=jl.wb_scales,
                  wc_scales=jl.wc_scales, act_dtype=jnp.float32, **scales)
    ops = (jl.lam, jl.w_b, jl.w_c, jl.d, jl.norm_w, jl.norm_b)
    ref, ref_c = fused_layer_apply_carry(
        r_pad, tuple(jnp.asarray(c) for c in carry), *ops, **args, **common)
    out, new_c = engine_layer_plain(
        torch.from_numpy(codes), tl, mode, block_t=8, in_requant=in_rq,
        carry=tuple(torch.from_numpy(c) for c in carry))
    assert out.dtype == (torch.int8 if bits <= 8 else torch.int16)
    for o, r in ((out, ref),
                 (engine_layer_plain(torch.from_numpy(codes), tl, mode,
                                     block_t=8, in_requant=in_rq),
                  fused_layer_apply(r_pad, *ops, **args, **common))):
        diff = np.abs(o.numpy().astype(int)
                      - np.asarray(r)[:, :, :H].astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.005, diff.max()
    scale = max(np.abs(np.asarray(c)).max() for c in ref_c)
    for a, b, step in zip(new_c, ref_c, (s_re, s_im)):
        diff = np.abs(a.numpy() - np.asarray(b))
        assert diff.max() <= max(1e-5 * scale, 1.001 * step), diff.max()
        assert (diff > 1e-5 * scale).sum() <= 1, diff


def test_plane_wise_width_matches_pallas_layer():
    """H = 400, padded to 512 in the TPU kernel: every two-plane dot over
    H (B-projection, GLU) takes the plane-wise formula. Random int8
    weights and grids, mxu16 sites on, against fused_layer_apply: the
    layer bar above (measured: codes equal)."""
    from sparsernns_tpu_torch.ops.intdot import weight_colsum
    from sparsernns_tpu_torch.quantize.engine import QWeight, _LayerPack
    h, p, t = 400, 16, 8
    rng = np.random.RandomState(9)

    def i8(*shape):
        return rng.randint(-127, 128, size=shape).astype(np.int8)

    # every value a grid quantizes is exact in float32 here (lam = 0: the
    # states are their B-projections; the identity norm; d on a coarse
    # grid), so neither the scan's summation order nor a contracted
    # multiply-add of the reference moves a value across a tie
    lam = (np.zeros(p, np.float32), np.zeros(p, np.float32))
    w_b, w_c, o2k = i8(h, 2 * p), i8(2 * p, h), i8(h, h)
    d = (rng.randint(-8, 8, size=h) / 16.0).astype(np.float32)
    nw, nb = np.ones(h, np.float32), np.zeros(h, np.float32)
    o2b = (0.1 * rng.randn(h)).astype(np.float32)
    grids = dict(wb_scales=(2.0 ** -9, 2.0 ** -9),
                 wc_scales=(2.0 ** -10, 2.0 ** -10),
                 block_requant=(2.0 ** -9, 2.0 ** -9, 16),
                 mixer_in16=(2.0 ** -12, 16), out2_in=(2.0 ** -12, 16),
                 but=(2.0 ** -11, 2.0 ** -11, 16), yt=(2.0 ** -10, 16),
                 out2_out=(2.0 ** -11, 16), rq=(2.0 ** -11, 16))
    tl = _LayerPack(
        lam=tuple(map(torch.from_numpy, lam)), w_b=torch.from_numpy(w_b),
        w_c=torch.from_numpy(w_c), d=torch.from_numpy(d),
        norm_w=torch.from_numpy(nw), norm_b=torch.from_numpy(nb),
        out2_kernel=QWeight(torch.from_numpy(o2k), 2.0 ** -8,
                            weight_colsum(o2k)),
        out2_bias=torch.from_numpy(o2b), residual_requant=grids["rq"],
        state_requant=grids["block_requant"],
        wb_scales=grids["wb_scales"], wc_scales=grids["wc_scales"],
        out2_in_scale=grids["out2_in"], mixer_in16=grids["mixer_in16"],
        state16=True, but_requant=grids["but"], yt_requant=grids["yt"],
        out2_out_requant=grids["out2_out"], cs_wb=weight_colsum(w_b),
        cs_wc_re=weight_colsum(w_c[:p]), cs_wc_im=weight_colsum(w_c[p:]))
    codes = rng.randint(-16000, 16000, size=(1, 16, h)).astype(np.int16)
    mode = LayerMode(prenorm=True, relufication=True, glu="half1",
                     relu_state=True, act_dtype=torch.float32)
    out = engine_layer_plain(torch.from_numpy(codes), tl, mode, block_t=t,
                             in_requant=grids["rq"])
    ref = fused_layer_apply(
        jnp.pad(jnp.asarray(codes), ((0, 0), (0, 0), (0, 512 - h))),
        tuple(map(jnp.asarray, lam)), jnp.asarray(w_b), jnp.asarray(w_c),
        jnp.asarray(d), jnp.asarray(nw), jnp.asarray(nb), jnp.asarray(o2k),
        jnp.asarray(o2b), block_t=t, prenorm=True, relufication=True,
        glu="half1", relu_state=True, in_requant=grids["rq"],
        out_requant=grids["rq"], block_requant=grids["block_requant"],
        wb_scales=grids["wb_scales"], wc_scales=grids["wc_scales"],
        out2_scale=2.0 ** -8, out2_in_scale=grids["out2_in"],
        mixer_in16=grids["mixer_in16"], state16=True,
        but_requant=grids["but"], yt_requant=grids["yt"],
        out2_out_requant=grids["out2_out"], act_dtype=jnp.float32)
    diff = np.abs(out.numpy().astype(int)
                  - np.asarray(ref)[:, :, :h].astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.005, diff.max()


def _close(out, ref):
    scale = max(1.0, np.abs(ref).max())
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= 2e-3 * scale, np.abs(out - ref).max()
    assert np.abs(out - ref).mean() <= 1e-4 * scale


@pytest.mark.parametrize("route", ["network", "stack", "per_op"])
@pytest.mark.parametrize("recipe,mxu16", MODES, ids=MODE_IDS)
def test_engine_matches_jax_engine(trees, recipe, mxu16, route):
    """The engine on each route against the JAX engine on the same route
    (per-op: the top-k engine for w8a8, whose GLU and boundary denses run
    ``quantized_dense``'s int8 dots; else the route forced): the module's
    engine bar. Length 23 with time block 8: a short last block."""
    kw = dict(topk=0.5) if route == "per_op" and not mxu16 else {}
    je = jax_eng(trees[recipe], recipe, mxu16, **kw)
    te = port_eng(trees[recipe], recipe, mxu16, **kw)
    if route == "stack":
        je._network_ok = te._network_ok = False
    elif route == "per_op" and mxu16:
        for e in (je, te):
            e._network_ok = e._stack_ok = False
    assert te._network_ok == (route == "network")
    assert te._stack_ok == (route != "per_op")
    x = (0.5 * np.random.RandomState(2).randn(B, 23, D_IO)).astype(
        np.float32)
    _close(te(x).numpy(), np.asarray(je(jnp.asarray(x))))


@pytest.mark.parametrize("recipe,mxu16", MODES, ids=MODE_IDS)
def test_routes_and_chunks_bit_for_bit(trees, recipe, mxu16, frozen):  # noqa: F811
    """The network route = the stack route, and process_chunk at chunk =
    block_t = one whole call, exactly; the stream between launches is
    int8 at w8a8 and int16 with mxu16."""
    x = frozen["batches"][1]
    e_net = port_eng(trees[recipe], recipe, mxu16)
    e_stk = port_eng(trees[recipe], recipe, mxu16)
    e_stk._network_ok = False
    whole = e_net(x)
    assert torch.equal(whole, e_stk(x))
    r = e_stk._apply_chunk_stack(torch.from_numpy(x),
                                 e_stk.init_stream_state(B), 8,
                                 decode=False)[0]
    assert r.dtype == (torch.int16 if mxu16 else torch.int8)
    carries, parts = None, []
    for s in range(0, x.shape[1], 8):
        y, carries = e_net.process_chunk(x[:, s:s + 8], carries)
        parts.append(y)
    assert torch.equal(torch.cat(parts, dim=1), whole)


@pytest.mark.parametrize("recipe,mxu16", [("w8a8", False), ("w8a16", True)],
                         ids=["w8a8", "w8a16-mxu16"])
def test_streaming_from_engine_matches_jax(recipe, mxu16):
    """``StreamingDenoiser.from_engine`` over an integer-dot engine at 257
    bins (a tree of the port's calibration, handed to both packages)
    buffers to the block and streams JAX's mask within the engine bar
    (atol 2e-3; the mask stays below 1)."""
    from sparsernns_tpu.serve.streaming import \
        StreamingDenoiser as JaxStreamingDenoiser
    from sparsernns_tpu_torch.train.loop import build_model
    from tests.test_torch_engine_serving import BLOCK, CFG
    from tests.test_torch_model import jax_model as jax_float_model
    variables = jax.device_get(jax_float_model(CFG, 257).init(
        jax.random.PRNGKey(3), jnp.zeros((1, 16, 257), jnp.float32)))
    rng = np.random.RandomState(4)
    cal_model = build_model(
        CFG, 257, 257, device="cpu", seed=0, scan_mode="sequential",
        q_config=quantization_recipes[recipe](static_quant=True,
                                              calibrating=True))
    tree = calibrate(cal_model, from_flax(variables["params"],
                                          variables["batch_stats"]),
                     [torch.from_numpy((rng.rand(2, 24, 257) * 4 - 1)
                                       .astype(np.float32))
                      for _ in range(2)])
    kw = dict(glu="half1", block_t=BLOCK)
    te = port_eng(tree, recipe, mxu16, **kw)
    assert te._network_ok and te.mxu16["dense"]
    audio = (0.3 * np.random.RandomState(7).randn(2, 3000)).astype(
        np.float32)
    den = StreamingDenoiser.from_engine(te, batch_size=2)
    assert den.frame_multiple == BLOCK
    out = den.process_offline(audio, chunk_samples=1024)
    ref = JaxStreamingDenoiser.from_engine(
        jax_eng(tree, recipe, mxu16, **kw),
        batch_size=2).process_offline(audio, chunk_samples=1024)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=2e-3, rtol=0)


@pytest.mark.parametrize("recipe,mxu16,max_rel,mean_rel", [
    ("w8a8", False, 0.15, 0.02), ("w8a16", True, 0.12, 0.005)],
    ids=["w8a8", "w8a16-mxu16"])
def test_engine_tracks_static_quant_model(trees, frozen, recipe, mxu16,  # noqa: F811
                                          max_rel, mean_rel):
    """The integer-dot engine against the frozen static-quant model of its
    recipe (per-step state requant) at the JAX package's bars."""
    x = frozen["batches"][0]
    model = port_model(quantization_recipes[recipe](static_quant=True,
                                                    calibrating=False))
    model.load_state_dict(from_flax(*trees[recipe]))
    with torch.no_grad():
        y_q = model(torch.from_numpy(x)).numpy()
    y_e = port_eng(trees[recipe], recipe, mxu16, block_t=32)(x).numpy()
    denom = max(np.abs(y_q).max(), 1.0)
    assert np.abs(y_e - y_q).max() / denom < max_rel
    assert np.abs(y_e - y_q).mean() / denom < mean_rel


@pytest.mark.parametrize("recipe", ["w8a8", "w8a8A8"])
def test_calibration_at_8_bits_equals_jax(trees, frozen, recipe):  # noqa: F811
    """The port's calibration with an 8-bit recipe freezes JAX's tree."""
    cal_model = port_model(quantization_recipes[recipe](
        static_quant=True, calibrating=True))
    params, _ = calibrate(
        cal_model, from_flax(frozen["params"], frozen["stats"]),
        [torch.from_numpy(b) for b in frozen["batches"]])
    ours = dict(flat_leaves(params))
    ref = dict(flat_leaves(trees[recipe][0]))
    assert set(ours) == set(ref)
    for key in ref:
        np.testing.assert_array_equal(np.asarray(ours[key]),
                                      np.asarray(ref[key]),
                                      err_msg="/".join(key))


@pytest.mark.parametrize("recipe,mxu16", [("w8a8", False), ("w8a16", True)],
                         ids=["w8a8", "w8a16-mxu16"])
def test_convert_serves_int_dot_engines(recipe, mxu16):
    """``convert`` with a w8a8 recipe, and with ``engine_mxu16``, runs
    calibrate -> freeze -> validate_static_quant -> validate_engine on the
    synthetic loader: finite metrics, and the engine within 0.5 dB SI-SNR
    of the static-quant model (the float-dot engine's test bar)."""
    import dataclasses

    from sparsernns_tpu_torch.quantize.convert import convert
    from sparsernns_tpu_torch.train.loop import build_model
    from tests.test_torch_engine_serving import CFG
    cfg = dataclasses.replace(CFG, convert_quantization=recipe,
                              engine_mxu16=mxu16)
    res = convert(cfg, build_model(cfg, 257, 257, device="cpu", seed=0))
    assert res["calibrated"] is True
    for stage in ("static_quant", "engine"):
        assert np.isfinite(res[stage]["loss"])
        assert np.isfinite(res[stage]["si_snr"])
    assert abs(res["engine"]["si_snr"] - res["static_quant"]["si_snr"]) < 0.5


def test_site_accumulators_equal_jax(trees, frozen):  # noqa: F811
    """The mxu16 engine's integer accumulators at every dot site equal
    JAX's ``int16_dot`` on the operands as the Pallas kernels pad them
    (H and P to 128; zero rows of the weights): the B-projection on the
    mixer input's codes, each C-projection half on state codes at both
    ends of the grid, the GLU dense and the decoder on their input
    grids."""
    from sparsernns_tpu_torch.ops.cuda.engine_layer import pad128
    from sparsernns_tpu_torch.ops.intdot import int16_dot
    je = jax_eng(trees["w8a16"], "w8a16", True)
    te = port_eng(trees["w8a16"], "w8a16", True)
    rng = np.random.RandomState(12)
    jl, tl = je.layers[0], te.layers[0]
    h, p = tl.w_b.shape[0], tl.p

    def check(x, w, cs, spec, codes=None):
        k = x.shape[-1] if codes is None else codes.shape[-1]
        kp = pad128(k)
        acc = int16_dot(None if x is None else torch.from_numpy(x), w, cs,
                        *spec,
                        codes=None if codes is None
                        else torch.from_numpy(codes), reduction_dim=kp)
        wj = np.pad(w.numpy(), ((0, kp - k), (0, 0)))
        pad = ((0, 0), (0, kp - k))
        ref = jax_intdot.int16_dot(
            jnp.asarray(np.pad(x if x is not None else codes, pad)),
            jnp.asarray(wj), jax_intdot.weight_colsum(wj), *spec,
            codes=None if codes is None else jnp.asarray(np.pad(codes, pad)))
        np.testing.assert_array_equal(acc.numpy(), np.asarray(ref))

    z = (rng.randn(6, h) * 2).astype(np.float32)
    check(z, tl.w_b, tl.cs_wb, tl.mixer_in16)
    np.testing.assert_array_equal(tl.w_b.numpy(), np.asarray(jl.w_b))
    bits = tl.state_requant[2]
    codes = rng.randint(-2 ** (bits - 1), 2 ** (bits - 1),
                        size=(6, p)).astype(np.float32)
    codes[0, 0], codes[1, 0] = -2 ** (bits - 1), 2 ** (bits - 1) - 1
    for half, cs in ((slice(0, p), tl.cs_wc_re), (slice(p, 2 * p),
                                                  tl.cs_wc_im)):
        check(None, tl.w_c[half], cs, tl.state_requant[::2], codes)
    check(z, tl.out2_kernel.data, tl.out2_kernel.colsum, tl.out2_in_scale)
    check(z, te.decoder_kernel.data, te.decoder_kernel.colsum,
          te.decoder_in_scale)
