"""The serving engine's mixer kernels, plain versions on the CPU, against
the JAX package's Pallas kernels in interpret mode on the same numpy
inputs:

- K1 with ``block_requant`` (``diag_scan_plain``) vs ``pallas_diag_scan``,
  with and without a carry;
- K4a in its engine modes (``fused_s5_engine_plain``: int8 / int16 / f32
  weights with per-half scales, bf16 / f32 input, block requant,
  ``relu_state``) vs ``fused_s5_apply``;
- K4b (the same with a carry in and out) vs ``fused_s5_apply_carry``;
- chunked at chunk = block vs one whole call, exactly.

Bars: states compared as codes of their grid, at most 1 apart in at most
0.5 % of the elements (the JAX kernels scan by doubling, so a requant can
flip at a tie); outputs within 1e-5 * max(1, |ref|) everywhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsernns_tpu.ops.pallas.fused_s5 import (fused_s5_apply,
                                                fused_s5_apply_carry)
from sparsernns_tpu.ops.pallas.scan_kernel import pallas_diag_scan
from sparsernns_tpu_torch.ops import scan as tscan
from sparsernns_tpu_torch.ops.cuda import diag_scan, fused_s5
from sparsernns_tpu_torch.utils.trace import launch_counts

WDTYPES = {"int8": (np.int8, 127, 2.0 ** -9), "int16": (np.int16, 30000,
                                                      2.0 ** -17),
           "f32": (np.float32, None, None)}


def _lam(rng, p):
    r = rng.uniform(0.5, 0.97, p)
    th = rng.uniform(-np.pi, np.pi, p)
    return ((r * np.cos(th)).astype(np.float32),
            (r * np.sin(th)).astype(np.float32))


def _codes_close(out, ref, scale, tag):
    """Grid values as codes: at most 1 apart, in at most 0.5 %."""
    diff = np.abs(np.rint(out / scale) - np.rint(ref / scale))
    assert diff.max() <= 1, (tag, diff.max())
    assert (diff > 0).mean() <= 5e-3, (tag, (diff > 0).mean())
    return diff


# ------------------------------------------------------- K1 block requant

@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("l,p,block_t,bits", [(37, 8, 8, 16), (64, 12, 16, 16),
                                              (23, 16, 32, 16),
                                              (40, 8, 8, 8)])
def test_scan_block_requant_matches_pallas(carry, l, p, block_t, bits):
    """States on the grid; the carry folds in at the first step; at 8 bits
    the grid clips."""
    rng = np.random.RandomState(l + p + block_t + bits)
    lam = _lam(rng, p)
    bu = tuple(rng.randn(2, l, p).astype(np.float32) for _ in range(2))
    s = (2.0 ** -10, 2.0 ** -11) if bits == 16 else (2.0 ** -6, 2.0 ** -7)
    rq = (s[0], s[1], bits)
    c = (tuple(rng.randn(2, p).astype(np.float32) * 3 for _ in range(2))
         if carry else None)
    ref = pallas_diag_scan(
        tuple(jnp.asarray(a) for a in lam),
        tuple(jnp.asarray(a) for a in bu), block_t=block_t,
        carry_init=None if c is None else tuple(jnp.asarray(a) for a in c),
        block_requant=rq)
    before = launch_counts()["diag_scan_requant"]
    out = diag_scan.diag_scan(
        tuple(torch.from_numpy(a) for a in lam),
        tuple(torch.from_numpy(a) for a in bu),
        carry_init=None if c is None else tuple(torch.from_numpy(a)
                                                for a in c),
        block_requant=rq, block_t=block_t)
    # plain on the CPU
    assert launch_counts()["diag_scan_requant"] == before
    for o, r, sc in zip(out, ref, s):
        o, r = o.numpy(), np.asarray(r)
        assert o.shape == r.shape == (2, l, p)
        np.testing.assert_array_equal(o, np.rint(o / sc) * sc)   # on grid
        _codes_close(o, r, sc, "state")
    if bits == 8:
        assert np.abs(out[0].numpy()).max() >= 127 * s[0]    # clipped


def test_scan_block_requant_carry_is_requantized_last_state():
    """Inside a block the recurrence runs on float32; at a block end the
    state is replaced by its grid value (plain version against a
    hand-written loop), forward and, with blocks counted from the end,
    reverse."""
    rng = np.random.RandomState(3)
    lam = tuple(torch.from_numpy(a) for a in _lam(rng, 4))
    bu = tuple(torch.from_numpy(rng.randn(1, 10, 4).astype(np.float32))
               for _ in range(2))
    s, bits = 2.0 ** -4, 8
    xs, final = tscan.sequential_diag_scan(lam, bu, block_requant=(s, s, bits),
                                           block_t=4)
    x = (torch.zeros(1, 4), torch.zeros(1, 4))
    for t in range(10):
        x = tscan.complex_mul(lam, x)
        x = (x[0] + bu[0][:, t], x[1] + bu[1][:, t])
        q = tuple(tscan.grid_value(v, s, bits) for v in x)
        assert torch.equal(xs[0][:, t], q[0]) and torch.equal(xs[1][:, t], q[1])
        if t in (3, 7, 9):
            x = q
    assert torch.equal(final[0], x[0]) and torch.equal(final[1], x[1])
    # reverse: the walk starts at t = 9, so the blocks end at t = 6, 2, 0
    xs = diag_scan.diag_scan(lam, bu, reverse=True,
                             block_requant=(s, s, bits), block_t=4)
    x = (torch.zeros(1, 4), torch.zeros(1, 4))
    for t in range(9, -1, -1):
        x = tscan.complex_mul(lam, x)
        x = (x[0] + bu[0][:, t], x[1] + bu[1][:, t])
        q = tuple(tscan.grid_value(v, s, bits) for v in x)
        assert torch.equal(xs[0][:, t], q[0]) and torch.equal(xs[1][:, t], q[1])
        if t in (6, 2, 0):
            x = q
    with pytest.raises(ValueError, match="block_t"):
        diag_scan.diag_scan(lam, bu, block_requant=(s, s, bits))
    with pytest.raises(NotImplementedError, match="no gradient"):
        tscan.diag_ssm_scan(lam, (bu[0].requires_grad_(), bu[1]),
                            block_requant=(s, s, bits), block_t=4)


# ------------------------------------------------ K4a engine modes, K4b

def _mixer_inputs(seed, b, l, h, p, wdtype, bits=16):
    rng = np.random.RandomState(seed)
    dt, qmax, step = WDTYPES[wdtype]
    lam = _lam(rng, p)
    if qmax is None:
        w_b = (rng.randn(h, 2 * p) * 0.3).astype(np.float32)
        w_c = (rng.randn(2 * p, h) * 0.3).astype(np.float32)
        wb_s = wc_s = None
    else:
        w_b = rng.randint(-qmax, qmax + 1, (h, 2 * p)).astype(dt)
        w_c = rng.randint(-qmax, qmax + 1, (2 * p, h)).astype(dt)
        wb_s = (step * 64, step * 32)
        wc_s = (2 * step * 32, 2 * step * 64)      # conj-sym 2x folded in
    s = {16: (2.0 ** -10, 2.0 ** -11), 8: (2.0 ** -2, 2.0 ** -3),
         32: (2.0 ** -26, 2.0 ** -27)}[bits]
    return dict(u=rng.randn(b, l, h).astype(np.float32), lam=lam, w_b=w_b,
                w_c=w_c, d=rng.randn(h).astype(np.float32), wb_scales=wb_s,
                wc_scales=wc_s, block_requant=(s[0], s[1], bits),
                carry=tuple((rng.randn(b, p) * 2).astype(np.float32)
                            for _ in range(2)))


def _jax_ops(inp, io):
    u = jnp.asarray(inp["u"]).astype(io)
    return (u, tuple(jnp.asarray(a) for a in inp["lam"]),
            jnp.asarray(inp["w_b"]), jnp.asarray(inp["w_c"]),
            jnp.asarray(inp["d"]))


def _port_ops(inp, io):
    u = torch.from_numpy(inp["u"]).to(io)
    return (u, tuple(torch.from_numpy(a) for a in inp["lam"]),
            torch.from_numpy(inp["w_b"]), torch.from_numpy(inp["w_c"]),
            torch.from_numpy(inp["d"]))


def _statics(inp, requant):
    return dict(wb_scales=inp["wb_scales"], wc_scales=inp["wc_scales"],
                block_requant=inp["block_requant"] if requant else None)


IO = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("wdtype,io,relu,requant,shape", [
    ("int8", "bf16", False, True, (2, 37, 12, 16, 8)),
    ("int8", "f32", True, True, (2, 37, 12, 16, 8)),
    ("int8", "f32", False, False, (2, 24, 12, 16, 8)),
    ("int16", "bf16", True, True, (2, 40, 20, 12, 16)),
    ("f32", "f32", False, True, (1, 23, 16, 8, 32)),
    ("f32", "bf16", True, False, (2, 33, 10, 6, 8)),
    ("f32", "f32", True, True, (2, 29, 12, 8, 16))])
def test_fused_s5_engine_plain_matches_pallas(wdtype, io, relu, requant,
                                              shape):
    """Odd widths, L not a multiple of the block, a short last block."""
    b, l, h, p, block_t = shape
    # f32 weights on a 32-bit grid once: the w32a32 engine's mixer
    bits = 32 if wdtype == "f32" and relu and requant else 16
    inp = _mixer_inputs(sum(shape), b, l, h, p, wdtype, bits)
    jio, tio = IO[io]
    ref = np.asarray(fused_s5_apply(
        *_jax_ops(inp, jio), block_t=block_t, relu_state=relu,
        **_statics(inp, requant)))
    before = launch_counts()["fused_s5_engine"]
    out = fused_s5.fused_s5_engine(
        *_port_ops(inp, tio), block_t=block_t, relu_state=relu,
        **_statics(inp, requant)).numpy()
    assert launch_counts()["fused_s5_engine"] == before
    assert out.shape == ref.shape == (b, l, h) and out.dtype == np.float32
    assert np.abs(out - ref).max() <= 1e-5 * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("wdtype,io,relu,bits", [
    ("int8", "bf16", False, 16), ("int8", "f32", True, 16),
    ("int16", "f32", False, 8), ("f32", "bf16", True, 16)])
def test_fused_s5_engine_carry_matches_pallas(wdtype, io, relu, bits):
    """K4b: two blocks of 16 from a non-zero carry; y and the carry out
    (a requantized state: compared as codes)."""
    inp = _mixer_inputs(7 + bits, 2, 32, 12, 8, wdtype, bits)
    jio, tio = IO[io]
    ref, ref_c = fused_s5_apply_carry(
        *_jax_ops(inp, jio), tuple(jnp.asarray(c) for c in inp["carry"]),
        block_t=16, relu_state=relu, **_statics(inp, True))
    before = launch_counts()["fused_s5_engine_carry"]
    out, out_c = fused_s5.fused_s5_engine(
        *_port_ops(inp, tio), block_t=16, relu_state=relu,
        carry=tuple(torch.from_numpy(c) for c in inp["carry"]),
        **_statics(inp, True))
    assert launch_counts()["fused_s5_engine_carry"] == before
    ref = np.asarray(ref)
    assert np.abs(out.numpy() - ref).max() <= 1e-5 * max(1.0,
                                                         np.abs(ref).max())
    for o, r, sc in zip(out_c, ref_c, inp["block_requant"][:2]):
        assert o.shape == (2, 8)
        _codes_close(o.numpy(), np.asarray(r), sc, "carry")


@pytest.mark.parametrize("relu", [False, True])
def test_fused_s5_engine_chunked_equals_whole(relu):
    """Chunks of one block with the carry flowing == one whole call,
    exactly (the same block boundaries); L not divisible by the block
    raises with a carry."""
    inp = _mixer_inputs(11, 2, 48, 12, 8, "int8")
    ops = _port_ops(inp, torch.bfloat16)
    kw = dict(relu_state=relu, **_statics(inp, True))
    whole = fused_s5.fused_s5_engine(*ops, block_t=16, **kw)
    carry = tuple(torch.zeros(2, 8) for _ in range(2))
    parts = []
    for s in range(0, 48, 16):
        y, carry = fused_s5.fused_s5_engine(
            ops[0][:, s:s + 16], *ops[1:], block_t=16, carry=carry, **kw)
        parts.append(y)
    assert torch.equal(torch.cat(parts, dim=1), whole)
    # the final carry is the requantized last state of the last block
    s_re = inp["block_requant"][0]
    assert torch.equal(carry[0], torch.round(carry[0] / s_re) * s_re)
    with pytest.raises(ValueError, match="divisible"):
        fused_s5.fused_s5_engine(ops[0][:, :20], *ops[1:], block_t=16,
                                 carry=carry, **kw)
    assert fused_s5.engine_block(512, 23) == 24
    assert fused_s5.engine_block(16, 23) == 16


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("b,l,h,p", [(2, 37, 12, 8), (1, 70, 20, 12)])
def test_float_mode_is_the_float_mixer(relu, b, l, h, p):
    """f32 weights without scales and no state grid: the one mixer kernel's
    plain version in its float mode equals ``fused_s5_plain``, the plain
    version of the float models' K4a (both sum in torch's order)."""
    inp = _mixer_inputs(b + l + h + p, b, l, h, p, "f32")
    ops = _port_ops(inp, torch.float32)
    ref = fused_s5.fused_s5_plain(*ops, relu_state=relu)
    out = fused_s5.fused_s5_engine(*ops, block_t=l, relu_state=relu)
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-6)
