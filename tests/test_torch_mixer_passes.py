"""Kernels K4a and K4b (the S5 mixer alone, float and engine modes, with
and without a carry) as passes (``ops/cuda/fused_s5.py``,
``csrc/fused_s5.cu`` over ``csrc/engine_passes.cuh``), on the CPU: the
plan of a call and a plain mirror of its passes.

- The plan: ``engine_layer.pass_plan`` with one layer and no encoder; its
  row tiles cover every row of the flattened B * L stream once (tiles
  straddle batch rows), its scan every (batch row, channel) once; a head
  row pass, a scan, a tail row pass, each row pass at least
  ceil(B * L / 128) CTAs; the scratch bu (B * L, 2P) float32, at most
  130 MB at B = 32, L = 3751.
- The mirror, written here: the head (u @ W_b with the per-half scales)
  over the row tiles, the scan over all of L from the carry with the
  running state put on the state grid where a block ends, the tail over
  the row tiles (each raw state on the grid, relu, the C-side scale, the
  C-projection + d * u). Bit for bit against the unchanged
  ``fused_s5_plain`` and ``fused_s5_engine_plain`` (the same arithmetic,
  per time block in the plain version), in every mode: float (relu_state
  off / on); int8, int16 and f32 weights, bf16 and f32 u, blocks of 16 and
  512, relu_state off / on, f32 weights on a 32-bit grid; with a carry in
  and out (K4b), and chunked at chunk = block equal to one call. Against
  the JAX package's ``fused_s5_apply`` / ``fused_s5_apply_carry`` in
  interpret mode: the float mode at 1e-4 * max(1, |ref|), the engine
  modes' outputs at 1e-5 * max(1, |ref|) and the carry's codes at most 1
  apart in at most 0.5 % (the state-code bar of
  ``tests/test_torch_fused_s5_engine.py``; on a 32-bit grid the carry at
  1e-5 * max(1, |ref|)).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsernns_tpu.ops.pallas.fused_s5 import (fused_s5_apply,
                                                fused_s5_apply_carry)
from sparsernns_tpu_torch.ops.cuda import engine_layer, fused_s5
from sparsernns_tpu_torch.ops.scan import complex_mul
from sparsernns_tpu_torch.utils.trace import launch_counts

PLAN_SHAPES = [(1, 37), (3, 70), (2, 300), (8, 3751), (32, 3751)]
H_FLAG, P_FLAG = 192, 128
#: B = 3, L = 64: 192 rows, six row tiles of 32 (two straddle a batch row)
B, L = 3, 64

WDTYPES = {"int8": (np.int8, 127, 2.0 ** -9), "int16": (np.int16, 30000,
                                                      2.0 ** -17),
           "f32": (np.float32, None, None)}
IO = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}


# ----------------------------------------------------------------- plan

@pytest.mark.parametrize("batch,length", PLAN_SHAPES)
def test_mixer_plan(batch, length):
    """A head row pass, the scan, a tail row pass; the row tiles cover the
    flattened rows once, the scan every (batch row, channel) once; every
    row pass has at least ceil(B * L / 128) CTAs (938 at B = 8); the
    scratch is bu alone, at most 130 MB at B = 32."""
    plan = engine_layer.pass_plan(batch, length, H_FLAG, P_FLAG, 1,
                                  encoder=False)
    rows = batch * length
    assert [k for k, _ in plan.passes()] == [
        engine_layer.ROW_PASS, engine_layer.SCAN_PASS, engine_layer.ROW_PASS]
    assert plan.row_ctas >= -(-rows // 128)
    covered = np.zeros(rows, int)
    for r0, r1 in plan.tiles():
        covered[r0:r1] += 1
    assert (covered == 1).all()
    assert sorted(plan.channels()) == [(b, q) for b in range(batch)
                                       for q in range(P_FLAG)]
    assert plan.scratch_shapes() == {"bu": (rows, 2 * P_FLAG)}
    assert plan.scratch_bytes() <= 130e6
    if (batch, length) == (8, 3751):
        assert plan.row_ctas == 938


# --------------------------------------------------- the passes, mirrored

def mixer_passes(u, lam, w_b, w_c, d, *, block_t=None, wb_scales=None,
                 wc_scales=None, block_requant=None, relu_state=False,
                 carry=None):
    """K4a / K4b as their passes, the arguments and results of
    ``fused_s5_engine_plain`` (``block_t`` None: the float mode, one block
    of all of L). The row passes write their row tiles; the products they
    read are the plain version's, a time block of all batch rows at a time:
    the CPU's BLAS picks its order of summation by a product's shape, so a
    32-row tile of them would not be bit-equal to it."""
    b, length, h = u.shape
    p = w_b.shape[-1] // 2
    t = (length if block_t is None
         else fused_s5.engine_block(block_t, max(length, 1)))
    plan = engine_layer.pass_plan(b, length, h, p, 1, encoder=False)
    rows = u.reshape(b * length, h).to(torch.float32)

    def product(x, w):
        """(B * L, K) rows @ w as the plain version multiplies them."""
        x = x.view(b, length, -1)
        return torch.cat([x[:, s:s + t] @ w.to(torch.float32)
                          for s in range(0, length, t)],
                         dim=1).reshape(b * length, -1)

    # ---- head pass: bu per row tile ----
    head = product(rows, w_b)
    bu = torch.empty((b * length, 2 * p))
    for r0, r1 in plan.tiles():
        x = head[r0:r1]
        if wb_scales is not None:
            x = torch.cat([x[:, :p] * wb_scales[0], x[:, p:] * wb_scales[1]],
                          dim=-1)
        bu[r0:r1] = x
    # ---- scan pass: every raw state, the carry on the grid at block ends
    bu = bu.view(b, length, 2 * p)
    x_r, x_i = carry if carry is not None else (torch.zeros(b, p),) * 2
    raw = torch.empty_like(bu)
    for step in range(length):
        ax_r, ax_i = complex_mul(lam, (x_r, x_i))
        x_r, x_i = ax_r + bu[:, step, :p], ax_i + bu[:, step, p:]
        raw[:, step, :p], raw[:, step, p:] = x_r, x_i
        if block_requant is not None and ((step + 1) % t == 0
                                          or step + 1 == length):
            x_r = engine_layer.qdq(x_r, (block_requant[0], block_requant[2]))
            x_i = engine_layer.qdq(x_i, (block_requant[1], block_requant[2]))
    raw = raw.reshape(b * length, 2 * p)
    # ---- tail pass: the states as the C-projection reads them, y ----
    states = torch.empty((b * length, 2 * p))
    for r0, r1 in plan.tiles():
        s_r, s_i = raw[r0:r1, :p], raw[r0:r1, p:]
        if block_requant is not None:
            s_r = engine_layer.qdq(s_r, (block_requant[0], block_requant[2]))
            s_i = engine_layer.qdq(s_i, (block_requant[1], block_requant[2]))
        if relu_state:
            s_r, s_i = torch.relu(s_r), torch.relu(s_i)
        if wc_scales is not None:
            s_r, s_i = s_r * wc_scales[0], s_i * wc_scales[1]
        states[r0:r1] = torch.cat([s_r, s_i], dim=-1)
    y = (product(states, w_c) + d * rows).view(b, length, h)
    return y if carry is None else (y, (x_r, x_i))


def _lam(rng, p):
    r = rng.uniform(0.5, 0.97, p)
    th = rng.uniform(-np.pi, np.pi, p)
    return ((r * np.cos(th)).astype(np.float32),
            (r * np.sin(th)).astype(np.float32))


def _inputs(seed, b, length, h, p, wdtype, bits=16):
    rng = np.random.RandomState(seed)
    dt, qmax, step = WDTYPES[wdtype]
    if qmax is None:
        w_b = (rng.randn(h, 2 * p) * 0.3).astype(np.float32)
        w_c = (rng.randn(2 * p, h) * 0.3).astype(np.float32)
        wb_s = wc_s = None
    else:
        w_b = rng.randint(-qmax, qmax + 1, (h, 2 * p)).astype(dt)
        w_c = rng.randint(-qmax, qmax + 1, (2 * p, h)).astype(dt)
        wb_s = (step * 64, step * 32)
        wc_s = (2 * step * 32, 2 * step * 64)
    s = {16: (2.0 ** -10, 2.0 ** -11), 32: (2.0 ** -26, 2.0 ** -27)}[bits]
    return dict(u=rng.randn(b, length, h).astype(np.float32), lam=_lam(rng, p),
                w_b=w_b, w_c=w_c, d=rng.randn(h).astype(np.float32),
                wb_scales=wb_s, wc_scales=wc_s,
                block_requant=(s[0], s[1], bits),
                carry=tuple((np.round(rng.randn(b, p) * 200) * sc)
                            .astype(np.float32) for sc in s))


def _port(inp, io):
    return (torch.from_numpy(inp["u"]).to(io),
            tuple(torch.from_numpy(a) for a in inp["lam"]),
            torch.from_numpy(inp["w_b"]), torch.from_numpy(inp["w_c"]),
            torch.from_numpy(inp["d"]))


def _jax(inp, io):
    return (jnp.asarray(inp["u"]).astype(io),
            tuple(jnp.asarray(a) for a in inp["lam"]),
            jnp.asarray(inp["w_b"]), jnp.asarray(inp["w_c"]),
            jnp.asarray(inp["d"]))


def _statics(inp, requant=True):
    return dict(wb_scales=inp["wb_scales"], wc_scales=inp["wc_scales"],
                block_requant=inp["block_requant"] if requant else None)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("b,l,h,p", [(3, 64, 16, 8), (2, 37, 20, 12)])
def test_mirror_equals_float_plain(b, l, h, p, relu):
    """The float mode: the mirrored passes equal ``fused_s5_plain`` bit
    for bit."""
    inp = _inputs(b + l + h, b, l, h, p, "f32")
    ops = _port(inp, torch.float32)
    before = launch_counts()["fused_s5"]
    ref = fused_s5.fused_s5(*ops, relu_state=relu)
    # CPU tensors launch nothing
    assert launch_counts()["fused_s5"] == before
    assert torch.equal(mixer_passes(*ops, relu_state=relu), ref)


def test_wide_mixer_fits_and_matches_plain():
    """The tail row pass keeps no residual tile: u, y and the states of 32
    rows fit in a block's shared memory up to H = 780 at P = 128 (the
    one-CTA kernel before the passes took H up to 776); wider layers are
    refused. At H = 640, P = 128 the mirrored passes hold
    ``fused_s5_plain`` to 1e-6 * max(1, |ref|) (at this depth the CPU's
    matmul sums a short row tile in another order) and ``fused_s5_apply``
    to 1e-4 * max(1, |ref|)."""
    for h in (640, 776, 780):
        fused_s5.check_width(h, P_FLAG)
    with pytest.raises(ValueError):
        fused_s5.check_width(781, P_FLAG)
    inp = _inputs(7, 2, 37, 640, P_FLAG, "f32")
    inp["w_b"] = inp["w_b"] * np.float32((16 / 640) ** 0.5)
    inp["w_c"] = inp["w_c"] * np.float32((16 / 256) ** 0.5)
    ops = _port(inp, torch.float32)
    out = mixer_passes(*ops, relu_state=True)
    ref = fused_s5.fused_s5(*ops, relu_state=True)
    assert (out - ref).abs().max() <= 1e-6 * max(1.0, ref.abs().max())
    ref = np.asarray(fused_s5_apply(*_jax(inp, jnp.float32), block_t=32,
                                    relu_state=True))
    assert np.abs(out.numpy() - ref).max() <= 1e-4 * max(1.0,
                                                         np.abs(ref).max())


#: (weights, u, relu_state, block, state bits) of the engine modes
ENGINE_MODES = [("int8", "bf16", False, 512, 16),
                ("int8", "f32", True, 16, 16),
                ("int16", "bf16", True, 512, 16),
                ("int16", "f32", False, 16, 16),
                ("f32", "f32", True, 16, 32), ("f32", "bf16", False, 512, 16)]


@pytest.mark.parametrize("carry", [False, True], ids=["K4a", "K4b"])
@pytest.mark.parametrize("wdtype,io,relu,block,bits", ENGINE_MODES)
def test_mirror_equals_engine_plain(wdtype, io, relu, block, bits, carry):
    """The engine modes, without a carry (K4a; L = 64 in blocks of 16, or
    one block) and from a carry on the grid (K4b; the carry out too):
    the mirrored passes equal ``fused_s5_engine_plain`` (a block at a
    time) bit for bit."""
    inp = _inputs(len(wdtype) + block + bits, B, L, 16, 8, wdtype, bits)
    ops = _port(inp, IO[io][1])
    kw = dict(block_t=block, relu_state=relu, **_statics(inp))
    if carry:
        kw["carry"] = tuple(torch.from_numpy(c) for c in inp["carry"])
    ref = fused_s5.fused_s5_engine(*ops, **kw)
    out = mixer_passes(*ops, **kw)
    if not carry:
        ref, out = (ref,), (out,)
    else:
        ref, out = (ref[0], *ref[1]), (out[0], *out[1])
    assert all(torch.equal(o, r) for o, r in zip(out, ref))


def test_mirror_chunked_equals_whole():
    """K4b over chunks of one block, the carry flowing, equals one K4a
    call over the whole length, exactly."""
    inp = _inputs(5, B, L, 16, 8, "int8")
    ops = _port(inp, torch.bfloat16)
    kw = dict(block_t=16, relu_state=True, **_statics(inp))
    whole = mixer_passes(*ops, **kw)
    c = (torch.zeros(B, 8), torch.zeros(B, 8))
    parts = []
    for t0 in range(0, L, 16):
        y, c = mixer_passes(ops[0][:, t0:t0 + 16], *ops[1:], carry=c, **kw)
        parts.append(y)
    assert torch.equal(torch.cat(parts, dim=1), whole)


@pytest.mark.parametrize("relu", [False, True])
def test_mirror_matches_jax_float(relu):
    """The float mode against ``fused_s5_apply``: 1e-4 * max(1, |ref|)."""
    inp = _inputs(9, B, L, 20, 12, "f32")
    j = _jax(inp, jnp.float32)
    ref = np.asarray(fused_s5_apply(*j, block_t=32, relu_state=relu))
    out = mixer_passes(*_port(inp, torch.float32), relu_state=relu).numpy()
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= 1e-4 * max(1.0, np.abs(ref).max())


def _codes_close(out, ref, scale):
    diff = np.abs(np.rint(out / scale) - np.rint(ref / scale))
    assert diff.max() <= 1 and (diff > 0).mean() <= 5e-3, diff.max()


@pytest.mark.parametrize("carry", [False, True], ids=["K4a", "K4b"])
@pytest.mark.parametrize("wdtype,io,relu,block,bits", ENGINE_MODES[:4]
                         + [ENGINE_MODES[4]])
def test_mirror_matches_jax_engine(wdtype, io, relu, block, bits, carry):
    """The engine modes against ``fused_s5_apply`` (K4a) and
    ``fused_s5_apply_carry`` (K4b, from a carry on the grid): outputs
    1e-5 * max(1, |ref|), the carry out as codes at most 1 apart in at most
    0.5 % (on the 32-bit grid, finer than f32's spacing, 1e-5 * max(1,
    |ref|)). A block of 512 is the whole sequence here."""
    inp = _inputs(len(wdtype) + block + bits + 1, B, L, 16, 8, wdtype, bits)
    jio, tio = IO[io]
    blk = min(block, L)
    if carry:
        ref, ref_c = fused_s5_apply_carry(
            *_jax(inp, jio), tuple(jnp.asarray(c) for c in inp["carry"]),
            block_t=blk, relu_state=relu, **_statics(inp))
        out, out_c = mixer_passes(
            *_port(inp, tio), block_t=blk, relu_state=relu,
            carry=tuple(torch.from_numpy(c) for c in inp["carry"]),
            **_statics(inp))
        for o, r, sc in zip(out_c, ref_c, inp["block_requant"][:2]):
            if bits == 32:   # a grid finer than f32's spacing: values
                r = np.asarray(r)
                assert np.abs(o.numpy() - r).max() <= 1e-5 * max(
                    1.0, np.abs(r).max())
            else:
                _codes_close(o.numpy(), np.asarray(r), sc)
    else:
        ref = fused_s5_apply(*_jax(inp, jio), block_t=blk, relu_state=relu,
                             **_statics(inp))
        out = mixer_passes(*_port(inp, tio), block_t=blk, relu_state=relu,
                           **_statics(inp))
    ref = np.asarray(ref)
    assert out.shape == ref.shape == (B, L, 16)
    assert np.abs(out.numpy() - ref).max() <= 1e-5 * max(1.0,
                                                         np.abs(ref).max())
