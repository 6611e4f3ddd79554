"""The serving kernels K5 and K6 as passes (``ops/cuda/engine_layer.py``
``pass_plan``, ``csrc/engine_passes.cuh``), on the CPU: the plan of a call
and a plain mirror of its passes.

- The plan: the row tiles cover every row of the flattened B * L stream
  exactly once (the ragged last one too), the scan grid every (batch row,
  channel) exactly once; the launches, the scratch shapes and dtypes, and
  at the flagship B = 32 at most 300 MB of scratch.
- The mirror, written here: row passes over the plan's tiles of the
  flattened stream (a tile straddles batch rows), each the tail of layer l
  and the head of layer l + 1, and between them one scan per layer over
  all of L with the block requant. Against ``engine_network_plain`` /
  ``engine_layer_plain`` (per time block): stream codes at most 1 apart in
  at most 0.5 % of the elements, carries 1e-5 * max|x|, the mask at the
  engine bar (max 2e-3, mean 1e-4 of max(1, |ref|)); the scan over all of
  L bit for bit against the per-block recurrence (its arithmetic is the
  same, only the products move); the mirror's network = its K5 stack bit
  for bit. Against the JAX package's ``fused_network_apply`` (the JAX
  engine's network route) and ``fused_layer_apply(_carry)`` in interpret
  mode: the engine bar, and the layer bar of ``tests/test_torch_engine.py``.
  Float-dot, w8a8 and ``mxu16`` modes; GLU full, half1 and none.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sparsernns_tpu.fxp.derive import FxpModelConfig as JaxModelConfig
from sparsernns_tpu.ops.pallas.fused_layer import (fused_layer_apply,
                                                   fused_layer_apply_carry)
from sparsernns_tpu.quantize.calibrate import calibrate as jax_calibrate
from sparsernns_tpu.quantize.config import quantization_recipes as jax_recipes
from sparsernns_tpu.quantize.engine import W8A16Engine as JaxEngine
from sparsernns_tpu_torch.fxp.derive import FxpModelConfig
from sparsernns_tpu_torch.ops.cuda.engine_layer import (
    ROW_PASS, ROW_TILE, SCAN_CHANNELS, SCAN_PASS, Dense, LayerMode,
    dense_plain, encode_plain, engine_layer_plain, glu_denses, pad128,
    pass_plan, qdq, stream_dtype, stream_value)
from sparsernns_tpu_torch.ops.cuda.engine_network import engine_network_plain
from sparsernns_tpu_torch.ops.intdot import (int16_dot, quantize_codes,
                                             weight_colsum)
from sparsernns_tpu_torch.ops.scan import quant_codes, sequential_diag_scan
from sparsernns_tpu_torch.quantize.config import quantization_recipes
from sparsernns_tpu_torch.quantize.engine import (QWeight, W8A16Engine,
                                                  _LayerPack)
from tests.test_torch_quantize import (B, D_IO, H, L, frozen,  # noqa: F401
                                       jax_model)

PLAN_SHAPES = [(1, 37), (3, 70), (2, 300), (8, 3751), (32, 3751)]
#: the flagship's widths: H, P, layers
FLAGSHIP = (192, 128, 3)


# ----------------------------------------------------------------- plan

@pytest.mark.parametrize("batch,length", PLAN_SHAPES)
def test_row_tiles_cover_every_row_once(batch, length):
    """The row tiles, in grid order, cover [0, B * L) exactly once; all
    but the last hold ROW_TILE rows; tiles straddle batch rows."""
    plan = pass_plan(batch, length, *FLAGSHIP)
    tiles = plan.tiles()
    assert len(tiles) == plan.row_ctas == -(-batch * length // ROW_TILE)
    covered = np.zeros(batch * length, int)
    for r0, r1 in tiles:
        covered[r0:r1] += 1
    assert (covered == 1).all()
    assert tiles[0][0] == 0 and tiles[-1][1] == batch * length
    assert all(r1 - r0 == ROW_TILE for r0, r1 in tiles[:-1])
    assert 1 <= tiles[-1][1] - tiles[-1][0] <= ROW_TILE
    straddle = [t for t in tiles if t[0] // length != (t[1] - 1) // length]
    assert bool(straddle) == (batch > 1 and length % ROW_TILE != 0)


@pytest.mark.parametrize("batch,length", PLAN_SHAPES)
def test_scan_grid_covers_every_channel_once(batch, length):
    """Every (batch row, state channel) is walked by exactly one scan
    thread; a CTA holds channels of one batch row; P = 128 and an odd
    P = 18 (a ragged CTA)."""
    for p in (FLAGSHIP[1], 18):
        plan = pass_plan(batch, length, FLAGSHIP[0], p, FLAGSHIP[2])
        chans = plan.channels()
        assert sorted(chans) == [(b, q) for b in range(batch)
                                 for q in range(p)]
        assert plan.scan_ctas == batch * -(-p // SCAN_CHANNELS)


@pytest.mark.parametrize("batch,length", PLAN_SHAPES)
def test_passes_and_scratch(batch, length):
    """K6: n + 1 row passes with a scan before each but the first; K5 one
    scan between two row passes. Scratch: bu (B*L, 2P) float32 and, after
    an encoder, the stream (B*L, H) float32."""
    h, p, n = FLAGSHIP
    plan = pass_plan(batch, length, h, p, n)
    kinds = [k for k, _ in plan.passes()]
    assert kinds == [ROW_PASS] + [SCAN_PASS, ROW_PASS] * n
    assert all(c == (plan.row_ctas if k == ROW_PASS else plan.scan_ctas)
               for k, c in plan.passes())
    rows = batch * length
    assert plan.scratch_shapes() == {"bu": (rows, 2 * p),
                                     "stream": (rows, h)}
    assert plan.scratch_bytes() == 4 * rows * (2 * p + h)
    k5 = pass_plan(batch, length, h, p, 1, encoder=False)
    assert [k for k, _ in k5.passes()] == [ROW_PASS, SCAN_PASS, ROW_PASS]
    assert k5.scratch_shapes() == {"bu": (rows, 2 * p)}


def test_plan_at_the_flagship():
    """At B = 8 every row pass has more CTAs than the card has SMs (132);
    at B = 32 the scratch is at most 300 MB; the plan is pure."""
    h, p, n = FLAGSHIP
    assert pass_plan(8, 3751, h, p, n).row_ctas == 938 > 132
    assert pass_plan(32, 3751, h, p, n).scratch_bytes() <= 300e6
    assert pass_plan(8, 3751, h, p, n) == pass_plan(8, 3751, h, p, n)
    with pytest.raises(ValueError):
        pass_plan(0, 10, h, p, n)


# --------------------------------------------------- the passes, mirrored

def head_rows(r, layer, mode):
    """A layer's head on rows r (n, H) of stream values: the norm, the
    B-projection with its per-half scales (on the codes of z with
    mixer_in16), quant_but -> bu (n, 2P)."""
    h = layer.w_b.shape[0]
    p = layer.w_b.shape[-1] // 2
    z = r * layer.norm_w + layer.norm_b if mode.prenorm else r
    if layer.mixer_in16 is not None:
        s_ut, bits = layer.mixer_in16
        acc = int16_dot(z, layer.w_b, layer.cs_wb, s_ut, bits,
                        codes=quantize_codes(z, s_ut, bits),
                        reduction_dim=pad128(h))
        bu_re = acc[..., :p] * (s_ut * layer.wb_scales[0])
        bu_im = acc[..., p:] * (s_ut * layer.wb_scales[1])
    else:
        bu = z @ layer.w_b.to(torch.float32)
        bu_re, bu_im = bu[..., :p], bu[..., p:]
        if layer.wb_scales is not None:
            bu_re = bu_re * layer.wb_scales[0]
            bu_im = bu_im * layer.wb_scales[1]
    if layer.but_requant is not None:
        s_br, s_bi, bits = layer.but_requant
        bu_re, bu_im = qdq(bu_re, (s_br, bits)), qdq(bu_im, (s_bi, bits))
    return torch.cat([bu_re, bu_im], dim=-1)


def scan_pass(bu, layer, relu_state, block_t, carry=None):
    """One layer's scan over bu (B, L, 2P), every (batch row, channel)
    through all of L in order with the running state put on the
    block-requant grid where a block ends, and what the next tail makes of
    the states as it loads them: their grid values, relu, the C-side scale
    or the state's code. Returns (what the C-projection reads, carry)."""
    p = bu.shape[-1] // 2
    (x_re, x_im), carry = sequential_diag_scan(
        layer.lam, (bu[..., :p], bu[..., p:]), carry,
        block_requant=layer.state_requant, block_t=block_t)
    if relu_state:
        x_re, x_im = torch.relu(x_re), torch.relu(x_im)
    if layer.state16:
        s_re, s_im, _ = layer.state_requant
        x_re, x_im = x_re * (1.0 / s_re), x_im * (1.0 / s_im)
    elif layer.wc_scales is not None:
        x_re, x_im = x_re * layer.wc_scales[0], x_im * layer.wc_scales[1]
    return torch.cat([x_re, x_im], dim=-1), carry


def tail_rows(r, s, layer, mode):
    """A layer's tail on rows r (n, H) of its input stream and s (n, 2P)
    of its scan: z again from r, the C-projection + d * z, quant_yt, the
    activation, the GLU, the residual, postnorm, relufication -> h."""
    h = layer.w_b.shape[0]
    p = s.shape[-1] // 2
    z = r * layer.norm_w + layer.norm_b if mode.prenorm else r
    if layer.mixer_in16 is not None:
        s_ut, bits = layer.mixer_in16
        z = quantize_codes(z, s_ut, bits) * s_ut
    if layer.state16:
        s_re, s_im, bits = layer.state_requant
        k = pad128(p)
        acc_re = int16_dot(None, layer.w_c[:p], layer.cs_wc_re, s_re, bits,
                           codes=s[..., :p], reduction_dim=k)
        acc_im = int16_dot(None, layer.w_c[p:], layer.cs_wc_im, s_im, bits,
                           codes=s[..., p:], reduction_dim=k)
        y = (acc_re * (s_re * layer.wc_scales[0])
             + acc_im * (s_im * layer.wc_scales[1]))
    else:
        y = s @ layer.w_c.to(torch.float32)
    y = qdq(y + layer.d * z, layer.yt_requant)
    x1 = torch.relu(y) if mode.relufication else F.gelu(
        y, approximate="tanh")
    if mode.glu == "none":
        out = x1
    else:
        out2, out1 = glu_denses(layer)
        gate = torch.sigmoid(dense_plain(x1, out2, pad128(h)))
        base = {"half1": x1, "half2": y}.get(mode.glu)
        if base is None:
            base = dense_plain(x1, out1, pad128(h))
        out = base * gate
    out = out + r
    if not mode.prenorm:
        out = out * layer.norm_w + layer.norm_b
    return torch.relu(out) if mode.relufication else out


def network_passes(x, enc, layers, dec, mode, block_t):
    """K6 as its passes: x (B, L, d_in) -> the (B, L, d_out) mask."""
    b, length, _ = x.shape
    h = enc.kernel.data.shape[1]
    plan = pass_plan(b, length, h, max(lay.p for lay in layers), len(layers))
    rows = x.reshape(b * length, -1)
    stream = torch.empty((b * length, h))
    out = torch.empty((b * length, dec.kernel.data.shape[1]))
    s = None
    for i in range(len(layers) + 1):
        bu = torch.empty((b * length, 2 * layers[min(i, len(layers) - 1)].p))
        for r0, r1 in plan.tiles():
            if i == 0:
                r = encode_plain(rows[r0:r1], enc, mode)
            else:
                r = stream_value(tail_rows(stream[r0:r1], s[r0:r1],
                                           layers[i - 1], mode),
                                 layers[i - 1], mode)
            if i < len(layers):
                stream[r0:r1] = r
                bu[r0:r1] = head_rows(r, layers[i], mode)
            else:
                out[r0:r1] = dense_plain(r, dec, pad128(h))
        if i < len(layers):
            s, _ = scan_pass(bu.view(b, length, -1), layers[i],
                             mode.relu_state, block_t)
            s = s.reshape(b * length, -1)
    return out.view(b, length, -1)


def layer_passes(r, layer, mode, block_t, in_requant=None, carry=None,
                 enc=None, dec=None):
    """K5 as its passes, the arguments and results of
    ``engine_layer_plain``."""
    b, length, _ = r.shape
    h = layer.w_b.shape[0]
    plan = pass_plan(b, length, h, layer.p, 1, encoder=enc is not None)
    rows = r.reshape(b * length, -1)
    stream = torch.empty((b * length, h))
    bu = torch.empty((b * length, 2 * layer.p))
    for r0, r1 in plan.tiles():
        if enc is not None:
            stream[r0:r1] = encode_plain(rows[r0:r1], enc, mode)
        else:
            stream[r0:r1] = rows[r0:r1].to(torch.float32) * (
                1.0 if in_requant is None else in_requant[0])
        bu[r0:r1] = head_rows(stream[r0:r1], layer, mode)
    s, new_c = scan_pass(bu.view(b, length, -1), layer, mode.relu_state,
                         block_t, carry)
    s = s.reshape(b * length, -1)
    outs = []
    for r0, r1 in plan.tiles():
        hv = tail_rows(stream[r0:r1], s[r0:r1], layer, mode)
        if dec is not None:
            outs.append(dense_plain(stream_value(hv, layer, mode), dec,
                                    pad128(h)))
        elif layer.residual_requant is not None:
            outs.append(quant_codes(hv, layer.residual_requant).to(
                stream_dtype(layer, mode)))
        else:
            outs.append(hv.to(mode.act_dtype))
    out = torch.cat(outs).view(b, length, -1)
    return out if carry is None else (out, new_c)


# ------------------------------------------------ random networks (no JAX)

def random_network(tag, seed, glu="half1", prenorm=True, relu=True,
                   act=torch.bfloat16, ps=(6, 5)):
    """Two layers of random int8 weights at H = 20 (P from ``ps``, d_in =
    13, d_out = 11) on frozen pow2 grids. ``tag``: "float" (float dots),
    "w8a8" (the denses' int8 dots on 8-bit grids), "mxu16" (every dot on
    16-bit codes, the static model's requants)."""
    gen = torch.Generator().manual_seed(seed)
    h, d_in, d_out = 20, 13, 11
    bits = 16 if tag == "mxu16" else 8
    intd = tag != "float"

    def grid(e):
        return (2.0 ** (e + 16 - bits), bits)

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=gen,
                             dtype=torch.int8)

    def qweight(k, n, scale):
        w = i8(k, n)
        return QWeight(w, scale, weight_colsum(w))

    def vec(n, sc=0.1, mean=0.0):
        return mean + sc * torch.randn(n, generator=gen)

    enc = Dense(qweight(d_in, h, 2.0 ** -7), vec(h),
                grid(-10) if intd else None,
                grid(-9) if tag == "mxu16" else None)
    dec = Dense(qweight(h, d_out, 2.0 ** -8), vec(d_out),
                grid(-9) if intd else None,
                grid(-9) if tag == "mxu16" else None)
    layers = []
    for p in ps:
        radius = torch.rand(p, generator=gen) * 0.3 + 0.6
        angle = torch.rand(p, generator=gen) * 6.0 - 3.0
        w_b, w_c = i8(h, 2 * p), i8(2 * p, h)
        s_state = grid(-7)[0]
        sites = {}
        if tag == "mxu16":
            sites = dict(mixer_in16=grid(-12), state16=True,
                         but_requant=(grid(-9)[0], grid(-9)[0], bits),
                         yt_requant=grid(-9), out2_out_requant=grid(-9),
                         out1_out_requant=grid(-9))
        layers.append(_LayerPack(
            lam=(radius * torch.cos(angle), radius * torch.sin(angle)),
            w_b=w_b, w_c=w_c, d=vec(h), norm_w=vec(h, mean=1.0),
            norm_b=vec(h), out2_kernel=qweight(h, h, 2.0 ** -7),
            out2_bias=vec(h), out1_kernel=qweight(h, h, 2.0 ** -7),
            out1_bias=vec(h), residual_requant=grid(-9),
            state_requant=(s_state, s_state, bits),
            wb_scales=(2.0 ** -7, 2.0 ** -8),
            wc_scales=(2.0 ** -8, 2.0 ** -9),
            out2_in_scale=grid(-9) if intd else None,
            out1_in_scale=grid(-9) if intd else None,
            cs_wb=weight_colsum(w_b), cs_wc_re=weight_colsum(w_c[:p]),
            cs_wc_im=weight_colsum(w_c[p:]), **sites))
    mode = LayerMode(prenorm=prenorm, relufication=relu, glu=glu,
                     relu_state=relu, act_dtype=act)
    return enc, layers, dec, mode, gen


def _codes_close(out, ref):
    """Stored streams: codes at most 1 apart in at most 0.5 %."""
    diff = (out.to(torch.int64) - ref.to(torch.int64)).abs()
    assert diff.max() <= 1 and (diff > 0).float().mean() <= 5e-3, diff.max()


def _engine_close(out, ref):
    """The engine bar: max 2e-3, mean 1e-4 of max(1, |ref|)."""
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    scale = max(1.0, float(np.abs(ref).max()))
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= 2e-3 * scale, np.abs(out - ref).max()
    assert np.abs(out - ref).mean() <= 1e-4 * scale


def _carries_close(out, ref):
    scale = max(c.abs().max().item() for c in ref)
    for a, b in zip(out, ref):
        assert (a - b).abs().max().item() <= 1e-5 * scale


TAGS = ["float", "w8a8", "mxu16"]
#: B = 3, L = 45: 135 rows, five row tiles (four straddle a batch row, the
#: last holds 7); blocks of 16, the last one 13 frames
SHAPE = (3, 45, 16)


@pytest.mark.parametrize("tag", TAGS)
def test_scan_pass_equals_the_blockwise_recurrence(tag):
    """The scan pass (all of L at once, the requant where each block ends)
    is the per-block recurrence of ``mixer_plain`` (a scan per block from
    the carry, every state then requantized), bit for bit, from a carry on
    the grid."""
    _, layers, _, mode, gen = random_network(tag, 1)
    lay = layers[0]
    b, length, bt = SHAPE
    bu = torch.randn((b, length, 2 * lay.p), generator=gen) * 0.05
    s_re, s_im, bits = lay.state_requant
    c0 = (torch.round(torch.randn((b, lay.p), generator=gen) * 50) * s_re,
          torch.round(torch.randn((b, lay.p), generator=gen) * 50) * s_im)
    s, carry = scan_pass(bu, lay, mode.relu_state, bt, c0)
    p, c, parts = lay.p, c0, []
    for t in range(0, length, bt):
        (x_re, x_im), _ = sequential_diag_scan(
            lay.lam, (bu[:, t:t + bt, :p], bu[:, t:t + bt, p:]), c)
        x_re, x_im = qdq(x_re, (s_re, bits)), qdq(x_im, (s_im, bits))
        c = (x_re[:, -1], x_im[:, -1])
        parts.append(_scaled(x_re, x_im, lay, mode))
    assert torch.equal(s, torch.cat(parts, dim=1))
    assert all(torch.equal(a, b) for a, b in zip(carry, c))


def _scaled(x_re, x_im, lay, mode):
    """What the C-projection reads of states on the grid."""
    if mode.relu_state:
        x_re, x_im = torch.relu(x_re), torch.relu(x_im)
    if lay.state16:
        return torch.cat([x_re * (1.0 / lay.state_requant[0]),
                          x_im * (1.0 / lay.state_requant[1])], -1)
    return torch.cat([x_re * lay.wc_scales[0], x_im * lay.wc_scales[1]], -1)


@pytest.mark.parametrize("glu", ["full", "half1", "none"])
@pytest.mark.parametrize("tag", TAGS)
def test_network_passes_match_plain(tag, glu):
    """The mirrored K6 passes against ``engine_network_plain`` (per time
    block): the engine bar; the mirrored K5 stack equals the mirrored
    network bit for bit, and each layer's stream codes are within a code
    of ``engine_layer_plain``'s."""
    enc, layers, dec, mode, gen = random_network(tag, 2, glu=glu)
    b, length, bt = SHAPE
    x = torch.randn((b, length, 13), generator=gen)
    mask = network_passes(x, enc, layers, dec, mode, bt)
    _engine_close(mask, engine_network_plain(x, enc, layers, dec, mode,
                                             block_t=bt))
    r = x
    for i, lay in enumerate(layers):
        kw = dict(enc=enc if i == 0 else None,
                  in_requant=None if i == 0 else
                  layers[i - 1].residual_requant,
                  dec=dec if i == len(layers) - 1 else None)
        nxt = layer_passes(r, lay, mode, bt, **kw)
        if kw["dec"] is None:
            _codes_close(nxt, engine_layer_plain(r, lay, mode, block_t=bt,
                                                 **kw))
        r = nxt
    assert torch.equal(r, mask)


@pytest.mark.parametrize("tag", TAGS)
def test_layer_passes_with_carry_match_plain(tag):
    """K5b mirrored from a carry on the state grid, in and out, over two
    and a short block: stream codes and carries at their bars against
    ``engine_layer_plain``; chunks of whole blocks equal one call."""
    enc, layers, _, mode, gen = random_network(tag, 3)
    b, length, bt = SHAPE
    x = torch.randn((b, length, 13), generator=gen)
    r0 = engine_layer_plain(x, layers[0], mode, block_t=bt, enc=enc)
    lay = layers[1]
    c0 = tuple(torch.round(torch.randn((b, lay.p), generator=gen) * 50) * s
               for s in lay.state_requant[:2])
    kw = dict(block_t=bt, in_requant=layers[0].residual_requant, carry=c0)
    out, carry = layer_passes(r0, lay, mode, **kw)
    ref, ref_c = engine_layer_plain(r0, lay, mode, **kw)
    _codes_close(out, ref)
    _carries_close(carry, ref_c)
    parts, c = [], c0
    for t in range(0, length, bt):
        o, c = layer_passes(r0[:, t:t + bt], lay, mode, block_t=bt,
                            in_requant=layers[0].residual_requant, carry=c)
        parts.append(o)
    assert torch.equal(torch.cat(parts, dim=1), out)
    assert all(torch.equal(a, b) for a, b in zip(c, carry))


# ------------------------------------------------ against the JAX package

MODES = {"float": ("w8a16", False), "w8a8": ("w8a8", False),
         "mxu16": ("w8a16", True)}


@pytest.fixture(scope="module")
def trees(frozen):  # noqa: F811
    """recipe -> the JAX package's frozen (params, stats): w8a16 from
    ``frozen``, w8a8 calibrated here from its float weights."""
    zeros = jnp.zeros((B, L, D_IO), jnp.float32)
    cal = jax_model(jax_recipes["w8a8"](static_quant=True, calibrating=True))
    w8a8 = jax.device_get(jax_calibrate(
        cal, jax.random.PRNGKey(0), zeros, frozen["params"],
        frozen["stats"], [jnp.asarray(b) for b in frozen["batches"]]))
    return {"w8a16": (frozen["frozen_params"], frozen["frozen_stats"]),
            "w8a8": w8a8}


def _engines(trees, tag, glu, block_t=8):
    recipe, mxu16 = MODES[tag]
    tree = trees[recipe]
    kw = dict(glu_variant=glu, relufication=True, prenorm=True,
              clip_eigs=True)
    je = JaxEngine(tree[0], tree[1],
                   jax_recipes[recipe](static_quant=True, calibrating=False),
                   JaxModelConfig.infer(tree[0], **kw),
                   act_dtype=jnp.float32, block_t=block_t, mxu16=mxu16)
    te = W8A16Engine(tree[0], tree[1],
                     quantization_recipes[recipe](static_quant=True,
                                                  calibrating=False),
                     FxpModelConfig.infer(tree[0], **kw),
                     act_dtype=torch.float32, block_t=block_t, mxu16=mxu16,
                     device="cpu")
    assert je._network_ok and te._network_ok
    return je, te


@pytest.mark.parametrize("glu", ["full", "half1"])
@pytest.mark.parametrize("tag", TAGS)
def test_network_passes_match_jax_network(trees, tag, glu):
    """The mirrored K6 passes on the port engine's operands against the
    JAX engine's network route (``fused_network_apply`` in interpret
    mode), length 23 in blocks of 8 (a short last block): the engine
    bar."""
    je, te = _engines(trees, tag, glu)
    x = (0.5 * np.random.RandomState(4).randn(B, 23, D_IO)).astype(
        np.float32)
    mask = network_passes(torch.from_numpy(x), te._enc, te.layers, te._dec,
                          te.mode, 8)
    _engine_close(mask.numpy(), je(jnp.asarray(x)))


@pytest.mark.parametrize("tag", TAGS)
def test_layer_passes_match_jax_layer(trees, tag):
    """The mirrored K5 passes for layer 1 over codes of layer 0's grid
    against ``fused_layer_apply_carry`` (a carry on the state grid in and
    out, two blocks) and ``fused_layer_apply`` in interpret mode: stream
    codes at most 1 apart in at most 0.5 %; carries 1e-5 * max|x|, but for
    at most one element one step of the state grid."""
    je, te = _engines(trees, tag, "half1")
    jl, tl = je.layers[1], te.layers[1]
    in_rq = te.layers[0].residual_requant
    rng = np.random.RandomState(6)
    qmax = 2 ** (in_rq[1] - 1)
    dt = np.int8 if in_rq[1] <= 8 else np.int16
    codes = rng.randint(-qmax // 8, qmax // 8, size=(B, 16, H)).astype(dt)
    s_re, s_im, _ = tl.state_requant
    carry = tuple((np.round(rng.randn(B, tl.p) * 20) * s).astype(np.float32)
                  for s in (s_re, s_im))
    args, scales = JaxEngine._layer_kernel_args(jl, "half1")
    common = dict(block_t=8, prenorm=True, relufication=True, glu="half1",
                  relu_state=True, in_requant=in_rq,
                  out_requant=jl.residual_requant,
                  block_requant=jl.state_requant, wb_scales=jl.wb_scales,
                  wc_scales=jl.wc_scales, act_dtype=jnp.float32, **scales)
    ops = (jl.lam, jl.w_b, jl.w_c, jl.d, jl.norm_w, jl.norm_b)
    r_pad = jnp.pad(jnp.asarray(codes), ((0, 0), (0, 0), (0, 128 - H)))
    ref, ref_c = fused_layer_apply_carry(
        r_pad, tuple(jnp.asarray(c) for c in carry), *ops, **args, **common)
    out, new_c = layer_passes(torch.from_numpy(codes), tl, te.mode,
                              block_t=8, in_requant=in_rq,
                              carry=tuple(map(torch.from_numpy, carry)))
    ref0 = fused_layer_apply(r_pad, *ops, **args, **common)
    out0 = layer_passes(torch.from_numpy(codes), tl, te.mode, block_t=8,
                        in_requant=in_rq)
    for o, r in ((out, ref), (out0, ref0)):
        diff = np.abs(o.numpy().astype(int)
                      - np.asarray(r)[:, :, :H].astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.005, diff.max()
    scale = max(np.abs(np.asarray(c)).max() for c in ref_c)
    for a, b, step in zip(new_c, ref_c, (s_re, s_im)):
        diff = np.abs(a.numpy() - np.asarray(b))
        assert diff.max() <= max(1e-5 * scale, 1.001 * step), diff.max()
        assert (diff > 1e-5 * scale).sum() <= 1, diff
