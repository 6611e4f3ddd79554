"""The port's quantization-aware-training ops against the JAX package's:
``quantize/qat.py`` (fake-quant with its straight-through estimator,
``q_dot``, ``q_had``, ``QuantizedOps``), the associative scan with the QAT
hadamards, and the QAT modes of the scan kernel K1 (``qat_scan_plain``)
and of the mixer kernel K4a (``fused_s5_qat_plain``) with their gradients
(``DiagScanFn``, ``FusedS5Fn``). Inputs are made from a numpy seed and
handed to both.

The JAX Pallas kernels run in interpret mode with an explicit
``block_t``. Interpret mode compiles the kernel body with XLA, which on the
CPU divides by a scale through its reciprocal and contracts a product and
a sum into one FMA; the port rounds every operation on its own (IEEE
division). Where a state lands near a rounding tie the two sides may take
neighbouring codes, and a flipped code is carried onward; hence the
quantized-state bar (:func:`assert_quantized_close`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsernns_tpu.ops.pallas.fused_s5 import fused_s5_apply
from sparsernns_tpu.ops.pallas.fused_vjp import fused_s5_apply_diff
from sparsernns_tpu.ops.pallas.scan_kernel import pallas_diag_scan
from sparsernns_tpu.ops.pallas.scan_vjp import (pallas_diag_scan_diff,
                                                pallas_diag_scan_diff_rev)
from sparsernns_tpu.ops.scan import associative_diag_scan as jax_assoc
from sparsernns_tpu.quantize import qat as jqat
from sparsernns_tpu.quantize.config import \
    quantization_recipes as jax_recipes
from sparsernns_tpu_torch.ops import scan as tscan
from sparsernns_tpu_torch.ops.cuda import fused_s5, qat_scan
from sparsernns_tpu_torch.quantize import qat as tqat
from sparsernns_tpu_torch.quantize.config import quantization_recipes
from sparsernns_tpu_torch.utils.trace import launch_counts


def assert_quantized_close(out, ref, step, name=""):
    """The quantized-state bar: at most 0.5 % of the elements differ by
    more than 1e-6·max(1, |ref|), and none by more than two grid steps
    ``step`` (broadcastable: absmax/qmax of each element's block)."""
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, name
    diff = np.abs(out - ref)
    share = (diff > 1e-6 * np.maximum(1.0, np.abs(ref))).mean()
    assert share <= 0.005, (name, share, diff.max())
    assert (diff <= 2.0 * step + 1e-6 * np.maximum(1.0, np.abs(ref))).all(), (
        name, (diff / np.maximum(step, 1e-30)).max())


def _lam(rng, p, slow=True):
    """Slowly decaying, strongly rotating eigenvalues (their powers carry
    far, so the padded rows of a last block are large), or faster ones."""
    r = rng.uniform(0.95, 0.999, p) if slow else rng.uniform(0.5, 0.97, p)
    th = rng.uniform(-3.0, 3.0, p)
    return ((r * np.cos(th)).astype(np.float32),
            (r * np.sin(th)).astype(np.float32))


def _pair(rng, *shape):
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


def _t(pair, grad=False):
    return tuple(torch.from_numpy(a.copy()).requires_grad_(grad)
                 for a in pair)


def _j(pair):
    return tuple(jnp.asarray(a) for a in pair)


def _on_jax_tables(monkeypatch):
    """The port's QAT scans from here on take the JAX package's λ tables
    (``lambda_power_tables``, run eagerly), so that a comparison with a
    Pallas kernel holds the two scans on the same tables. The carry table
    is made by exp, log, cos and sin, whose last bits the CPU's math
    library decides: on some hosts a fake-quantized entry whose unrounded
    power lies at a rounding boundary takes the other code
    (:func:`test_qat_tables_match_jax`), and every state folded with it
    moves."""
    from sparsernns_tpu.ops.pallas.scan_kernel import lambda_power_tables

    def tables(lam, t, num_passes, a_bits):
        with jax.disable_jit():
            pr, pi, ct = lambda_power_tables(
                *(jnp.asarray(a.detach().numpy()) for a in lam), t,
                num_passes, (a_bits, None))
        return tuple(torch.from_numpy(np.array(a)) for a in (pr, pi, *ct))

    monkeypatch.setattr(qat_scan, "lambda_power_tables", tables)


def _block_steps(ref, t, bits, reverse):
    """absmax/qmax of each (batch row, time block) of ``ref`` (B, L, P),
    blocks aligned as the kernel aligns them (from the end when reversed);
    the last, padded block takes its row's absmax."""
    ref = np.asarray(ref)
    x = ref[:, ::-1] if reverse else ref
    steps = np.empty_like(x)
    length = x.shape[1]
    for j in range(0, length, t):
        blk = x[:, j:j + t] if j + t <= length else x
        steps[:, j:j + t] = np.abs(blk).max(axis=(1, 2), keepdims=True)
    steps /= 2.0 ** (bits - 1) - 1.0
    return steps[:, ::-1] if reverse else steps


# ------------------------------------------------ fake-quant and the ops

@pytest.mark.parametrize("bits", [4, 8, 16, None, 32])
def test_fake_quant_values_and_ste_gradients_match_jax(bits):
    rng = np.random.RandomState(0 if bits is None else bits)
    x = (rng.randn(3, 7, 5) * 3.0).astype(np.float32)
    x[0, 0, 0] = 0.5 * np.abs(x).max() / (2 ** ((bits or 8) - 1) - 1)
    w = rng.randn(3, 7, 5).astype(np.float32)
    ref = np.asarray(jqat.fake_quant(jnp.asarray(x), bits))
    ref_g = np.asarray(jax.grad(
        lambda a: jnp.sum(jqat.fake_quant(a, bits) * w))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tqat.fake_quant(xt, bits)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(), ref)
    np.testing.assert_array_equal(xt.grad.numpy(), ref_g)
    np.testing.assert_array_equal(xt.grad.numpy(), w)     # the STE
    if bits in (None, 32):
        assert tqat.fake_quant(xt, bits) is xt
    else:
        np.testing.assert_array_equal(
            tqat.dyn_fake_quant(torch.from_numpy(x), bits).numpy(), ref)
    empty = torch.zeros(2, 0, 5)
    assert tqat.fake_quant(empty, bits).shape == (2, 0, 5)
    assert jqat.fake_quant(jnp.zeros((2, 0, 5)), bits).shape == (2, 0, 5)


@pytest.mark.parametrize("recipe", ["w8a16", "w8a8A8", "w4a4", "w32a32",
                                    "none"])
def test_quantized_ops_match_jax(recipe):
    """Every op of ``QuantizedOps`` (hadamards exact, dots 1e-6 relative:
    the two matmuls sum in other orders) and its gradients."""
    rng = np.random.RandomState(1)
    jops = jqat.QuantizedOps.create(jax_recipes[recipe]())
    tops = tqat.QuantizedOps.create(quantization_recipes[recipe]())
    a, b = (rng.randn(2, 9, 6) * 2).astype(np.float32), \
        rng.randn(2, 9, 6).astype(np.float32)
    w = rng.randn(6, 4).astype(np.float32)
    cases = [("a_had0", jops.a_had[0], tops.a_had[0], a, b),
             ("a_had1", jops.a_had[1], tops.a_had[1], a, b),
             ("d_had", jops.d_had, tops.d_had, a, b),
             ("b_dot", jops.b_dot, tops.b_dot, a, w),
             ("c_dot", jops.c_dot, tops.c_dot, a, w),
             ("dense_dot", jops.dense_dot, tops.dense_dot, a, w)]
    for name, jf, tf, x, y in cases:
        ref = np.asarray(jf(jnp.asarray(x), jnp.asarray(y)))
        gx, gy = jax.grad(lambda p, q: jnp.sum(jf(p, q) ** 2),
                          argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
        xt, yt = (torch.from_numpy(v.copy()).requires_grad_(True)
                  for v in (x, y))
        out = tf(xt, yt)
        (out ** 2).sum().backward()
        tol = 1e-6 * max(1.0, np.abs(ref).max())
        np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0,
                                   atol=tol, err_msg=name)
        for g_t, g_j in ((xt.grad, gx), (yt.grad, gy)):
            g_j = np.asarray(g_j)
            np.testing.assert_allclose(
                g_t.numpy(), g_j, rtol=0,
                atol=1e-5 * max(1.0, np.abs(g_j).max()), err_msg=name)


# ------------------------------------------------ the associative QAT scan

@pytest.mark.parametrize("recipe", ["w8a16", "w8a8A8", "w4a4"])
@pytest.mark.parametrize("length", [1, 2, 3, 17, 64])
@pytest.mark.parametrize("reverse", [False, True])
def test_associative_qat_scan_matches_jax(recipe, length, reverse):
    """``jax.lax.associative_scan``'s recursion, combine for combine, with
    ``q_had`` on every Λ·Λ and Λ·x product (lengths 2 and 3 reach
    zero-length slices); the gradients through the STE too."""
    cfg = quantization_recipes[recipe]()
    rng = np.random.RandomState(length + 100 * reverse)
    lam, bu = _lam(rng, 6), _pair(rng, 2, length, 6)
    g = _pair(rng, 2, length, 6)
    jh = (jqat.q_had(cfg.a_precision, cfg.a_precision),
          jqat.q_had(cfg.a_precision, cfg.ssm_act_precision))
    th = tqat.QuantizedOps.create(cfg).a_had

    def jfn(lam_, bu_):
        xs = jax_assoc(lam_, bu_, reverse, *jh)
        return xs, jnp.sum(xs[0] * g[0] + xs[1] * g[1])

    ref, _ = jfn(_j(lam), _j(bu))
    ref_g = jax.grad(lambda a, b: jfn(a, b)[1], argnums=(0, 1))(
        _j(lam), _j(bu))
    t_lam, t_bu = _t(lam, True), _t(bu, True)
    out = tscan.diag_ssm_scan(t_lam, t_bu, reverse=reverse,
                              mode="associative", had_aa=th[0],
                              had_ax=th[1])
    (out[0] * torch.from_numpy(g[0]) + out[1] * torch.from_numpy(g[1])
     ).sum().backward()
    for o, r in zip(out, ref):
        step = np.abs(np.asarray(r)).max() / (2.0 ** (cfg.ssm_act_precision
                                                       - 1) - 1)
        assert_quantized_close(o.detach().numpy(), r, step, "states")
    for ours, theirs in zip((*t_lam, *t_bu), (*ref_g[0], *ref_g[1])):
        theirs = np.asarray(theirs)
        # at length 1 no state depends on λ: autograd leaves no gradient
        grad = np.zeros_like(theirs) if ours.grad is None else ours.grad
        np.testing.assert_allclose(
            np.asarray(grad), theirs, rtol=2e-4,
            atol=2e-4 * max(1.0, np.abs(theirs).max()))


def test_associative_scan_with_carry_folds_it_in():
    """Streaming on the associative mode: the carry folds in with the
    λ powers, as in the JAX package's ``apply_carry``."""
    from sparsernns_tpu.ops.scan import diag_ssm_scan as jax_scan
    rng = np.random.RandomState(5)
    lam, bu, c = _lam(rng, 5), _pair(rng, 2, 20, 5), _pair(rng, 2, 5)
    ref = jax_scan(_j(lam), _j(bu), mode="associative", carry_init=_j(c))
    with torch.no_grad():
        out = tscan.diag_ssm_scan(_t(lam), _t(bu), carry_init=_t(c),
                                  mode="associative")
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-5 * np.abs(np.asarray(r)).max())


# ------------------------------------------------ K1 in its QAT mode

def _ieee_reference(lam, bu, bits, t, reverse=False, carry=None,
                    amax=None):
    """``scan_block_body`` with ``qat_bits`` and its wrapper
    (``pallas_diag_scan``), evaluated one numpy float32 operation at a time
    (IEEE rounding, no contraction), with the λ tables the plain version
    takes (``qat_scan.lambda_power_tables``), so that both sides scan with
    the same tables: the carry table is made by exp, log, cos and sin,
    whose last bit the CPU's math library decides, and
    :func:`test_qat_tables_match_jax` holds it to the JAX package's own
    (codes equal, or one apart at a rounding tie).
    ``amax``: the global-scale mode. The Pallas kernel itself always runs
    jitted, even in interpret mode."""
    f32 = np.float32
    a_bits, act = bits

    def fq(x):
        qmax = f32(2.0 ** (act - 1) - 1.0)
        m = np.abs(x).max() if amax is None else f32(amax)
        s = np.maximum(m, f32(1e-20)) / qmax
        return np.clip(np.round(x / s), -qmax - f32(1), qmax) * s

    br, bi = (a.copy() for a in bu)
    b, length, p = br.shape
    if carry is not None:
        lr, li = lam
        br[:, 0] = br[:, 0] + (lr * carry[0] - li * carry[1])
        bi[:, 0] = bi[:, 0] + (lr * carry[1] + li * carry[0])
    if reverse:
        br, bi = br[:, ::-1], bi[:, ::-1]
    t = min(t, -(-length // 8) * 8)
    l_pad, n_pass = -(-length // t) * t, max(1, (t - 1).bit_length())
    br, bi = (np.pad(a, ((0, 0), (0, l_pad - length), (0, 0)))
              for a in (br, bi))
    pr, pi, cr, ci = (a.numpy() for a in qat_scan.lambda_power_tables(
        _t(lam), t, n_pass, a_bits))
    out = [np.empty_like(br), np.empty_like(bi)]
    for row in range(b):
        c_re, c_im = np.zeros(p, f32), np.zeros(p, f32)
        for j in range(0, l_pad, t):
            xr, xi = br[row, j:j + t], bi[row, j:j + t]
            for k in range(n_pass):
                d = 1 << k
                zero = np.zeros((d, p), f32)
                sr = fq(np.concatenate([zero, xr[:t - d]]))
                si = fq(np.concatenate([zero, xi[:t - d]]))
                xr, xi = (xr + (pr[k] * sr - pi[k] * si),
                          xi + (pr[k] * si + pi[k] * sr))
            qr, qi = fq(c_re), fq(c_im)
            xr = fq(xr + (cr * qr - ci * qi))
            xi = fq(xi + (cr * qi + ci * qr))
            out[0][row, j:j + t], out[1][row, j:j + t] = xr, xi
            c_re, c_im = xr[-1], xi[-1]
    out = [a[:, :length] for a in out]
    return [a[:, ::-1] for a in out] if reverse else out


#: (direction, L, t, P, (a_bits, act_bits)): L not a multiple of t but in
#: one case, odd P
K1_CASES = [
    ("forward", 37, 8, 5, (16, 16)), ("forward", 100, 32, 7, (8, 8)),
    ("forward", 64, 32, 6, (4, 4)), ("reverse", 37, 32, 7, (8, 8)),
    ("reverse", 100, 8, 5, (4, 4)), ("reverse", 64, 8, 6, (16, 16)),
    ("carry", 37, 32, 5, (4, 4)), ("carry", 100, 32, 7, (16, 16)),
    ("carry", 64, 8, 6, (8, 8)),
]


@pytest.mark.parametrize("direction,length,t,p,bits", K1_CASES)
def test_qat_scan_plain_matches_pallas(direction, length, t, p, bits,
                                      monkeypatch):
    """Against the Pallas kernel (interpret mode) under the quantized-state
    bar at 16 and 8 bits. At 4 bits the grids are so coarse that exact
    rounding ties are the rule: the carry is a row of codes times its
    block's scale, so its own fake-quant divides small integers (1 · 7 / 2
    = 3.5), and λ^(2^k) squares quantized values. IEEE division rounds such
    a tie to even; the jitted reference divides through a reciprocal and
    rounds it either way, and a code flipped at a carry moves every later
    state of its channel. So at 4 bits the kernel's first time block is
    held to the Pallas kernel under the bar, and every block to
    ``scan_block_body`` evaluated op by op (:func:`_ieee_reference`)
    exactly. At every width the plain version equals that evaluation.
    Against the Pallas kernel the plain version scans on the JAX package's
    λ tables (:func:`_on_jax_tables`)."""
    rng = np.random.RandomState(length + t + p)
    lam, bu = _lam(rng, p), _pair(rng, 2, length, p)
    reverse = direction == "reverse"
    carry = _pair(rng, 2, p) if direction == "carry" else None
    ref = pallas_diag_scan(
        _j(lam), _j(bu), reverse=reverse,
        carry_init=None if carry is None else _j(carry), block_t=t,
        interpret=True, qat_bits=bits)
    before = launch_counts()["qat_scan"]

    def plain():
        return qat_scan.qat_scan(
            _t(lam), _t(bu), bits, t, reverse=reverse,
            carry_init=None if carry is None else _t(carry))

    out = plain()
    assert launch_counts()["qat_scan"] == before     # plain version on the CPU
    ieee = _ieee_reference(lam, bu, bits, t, reverse, carry)
    for o, e in zip(out, ieee):
        np.testing.assert_array_equal(o.numpy(), e)
    _on_jax_tables(monkeypatch)
    blk = min(t, -(-length // 8) * 8)
    first = slice(length - blk, None) if reverse else slice(0, blk)
    for o, r in zip(plain(), ref):
        o, r = o.numpy(), np.asarray(r)
        if bits[1] == 4:
            # every code the same; the values move with the block scale,
            # whose absmax the reference sums with FMAs (a few ulps)
            np.testing.assert_allclose(o[:, first], r[:, first], rtol=1e-5,
                                       atol=1e-5)
            continue
        assert_quantized_close(o, r, _block_steps(r, blk, bits[1], reverse),
                               direction)


def test_qat_scan_padding_and_block_alignment_are_numerics():
    """The padded rows of the last block set its output scale, and the
    reverse direction aligns its blocks from the end: computing either
    another way gives other values (so the comparison above can see it)."""
    rng = np.random.RandomState(9)
    lam, bu = _lam(rng, 4), _pair(rng, 1, 37, 4)
    bits = (8, 8)
    out = qat_scan.qat_scan_plain(_t(lam), _t(bu), bits, 32)
    # the same 37 rows as one block of 40 (no padded block of 32 + 27)
    other = qat_scan.qat_scan_plain(_t(lam), _t(bu), bits, 40)
    assert not torch.equal(out[0], other[0])
    rev = qat_scan.qat_scan_plain(_t(lam), _t(bu), bits, 32, reverse=True)
    flipped = tuple(a.flip(1) for a in qat_scan.qat_scan_plain(
        _t(lam), tuple(a.flip(1) for a in _t(bu)), bits, 32))
    torch.testing.assert_close(rev, flipped, rtol=0, atol=0)
    # aligned from the start instead, the reverse scan's blocks differ
    unaligned = tuple(a.flip(1) for a in qat_scan.qat_scan_plain(
        _t(lam), tuple(a.flip(1) for a in _t(bu)), bits, 8))
    assert not torch.equal(rev[0], unaligned[0])


def _power_bound(lam, length):
    """How far two float32 evaluations of λ^k = exp(k log|λ|) (cos, sin)(kθ),
    k = 1 .. ``length`` (``lambda_powers``), may lie apart, (length, P):
    each side's |λ| and θ are good to a few ulps, the products k log|λ| and
    kθ carry k times their operands' errors, and exp, cos, sin and the last
    product add a few ulps each, so a side's power is within
    (k (3 + 3 |log|λ|| + 3 |θ|) + 6) 2^-23 of |λ|^k."""
    re, im = (a.astype(np.float64) for a in lam)
    r, theta = np.hypot(re, im), np.abs(np.arctan2(im, re))
    k = np.arange(1, length + 1, dtype=np.float64)[:, None]
    return 2 * 2.0 ** -23 * r ** k * (
        k * (3 + 3 * np.abs(np.log(r)) + 3 * theta) + 6)


def test_qat_tables_match_jax():
    """The λ tables against the JAX package's ``lambda_power_tables``. The
    rows of λ^(2^k) (products and fake-quants, the same roundings) bit for
    bit. The carry table's powers λ^(r+1) come from exp, log, cos and sin,
    whose last bits each host's math library decides: the port's
    ``lambda_powers`` within :func:`_power_bound` of the JAX package's, and
    so the raw table (``bits=None``). Fake-quantized, each half's codes
    (the table over its scale, amax / qmax of its own powers) equal the
    JAX table's, but where the unrounded power lies within that bound of a
    rounding boundary, where they may be one apart."""
    from sparsernns_tpu.ops.pallas.scan_kernel import lambda_power_tables
    from sparsernns_tpu.ops.scan import lambda_powers
    rng = np.random.RandomState(3)
    lam = _lam(rng, 7)
    bound = _power_bound(lam, 32)
    ours_raw = [a.numpy().astype(np.float64)
                for a in tscan.lambda_powers(_t(lam), 32)]
    theirs_raw = [np.asarray(a, np.float64)
                  for a in lambda_powers(_j(lam), 32)]
    for o, r in zip(ours_raw, theirs_raw):
        assert (np.abs(o - r) <= bound).all(), np.abs(o - r).max()
    for bits in (4, 8, 16, None):
        with jax.disable_jit():
            pr, pi, ct = lambda_power_tables(*_j(lam), 32, 5, (bits, 8))
        ours = qat_scan.lambda_power_tables(_t(lam), 32, 5, bits)
        for o, r in zip(ours[:2], (pr, pi)):
            np.testing.assert_array_equal(o.numpy(), np.asarray(r))
        for o, r, o_raw, r_raw in zip(ours[2:], ct, ours_raw, theirs_raw):
            o, r = o.numpy().astype(np.float64), np.asarray(r, np.float64)
            if bits is None:
                assert (np.abs(o - r) <= bound).all(), np.abs(o - r).max()
                continue
            qmax = 2.0 ** (bits - 1) - 1
            step_o = float(np.float32(np.abs(o_raw).max()) / np.float32(qmax))
            step_r = float(np.float32(np.abs(r_raw).max()) / np.float32(qmax))
            assert abs(step_o - step_r) <= bound.max() / qmax, (step_o, step_r)
            codes_o, codes_r = np.round(o / step_o), np.round(r / step_r)
            for codes, step, table in ((codes_o, step_o, o),
                                       (codes_r, step_r, r)):
                np.testing.assert_array_equal(
                    codes.astype(np.float32) * np.float32(step), table)
            u = r_raw / step_r
            tie = (np.abs(np.abs(u - np.floor(u) - 0.5))
                   <= bound / step_r + np.abs(u) * (
                       abs(step_o / step_r - 1) + 2.0 ** -22))
            diff = np.abs(codes_o - codes_r)
            assert diff.max() <= 1 and not diff[~tie].any(), (
                bits, diff.max(), u[(diff > 0) & ~tie])


# ------------------------------------------------ K4a in its QAT mode

def _mixer_inputs(seed, b=2, length=45, h=12, p=7):
    rng = np.random.RandomState(seed)
    lam = _lam(rng, p)
    f32 = lambda a: np.asarray(a, dtype=np.float32)  # noqa: E731
    return dict(u=f32(rng.randn(b, length, h)), lam_re=lam[0],
                lam_im=lam[1], w_b=f32(rng.randn(h, 2 * p) * 0.3),
                w_c=f32(rng.randn(2 * p, h) * 0.3), d=f32(rng.randn(h)),
                g=f32(rng.randn(b, length, h)))


NAMES = ("u", "lam_re", "lam_im", "w_b", "w_c", "d")


def _k4a_both(inp, bits, relu_state, scale):
    j = {k: jnp.asarray(v) for k, v in inp.items()}
    ref = np.asarray(fused_s5_apply(
        j["u"], (j["lam_re"], j["lam_im"]), j["w_b"], j["w_c"], j["d"],
        block_t=16, relu_state=relu_state, qat_bits=bits,
        qat_state_scale=None if scale is None else jnp.asarray(scale)))
    ops = [torch.from_numpy(inp[k]) for k in NAMES]
    before = launch_counts()["fused_s5_qat"]
    out = fused_s5.fused_s5_qat(
        ops[0], (ops[1], ops[2]), *ops[3:], bits, 16, relu_state,
        None if scale is None else torch.tensor(scale)).numpy()
    # plain version on the CPU
    assert launch_counts()["fused_s5_qat"] == before
    return out, ref


@pytest.mark.parametrize("relu_state", [False, True])
@pytest.mark.parametrize("global_scale", [False, True])
@pytest.mark.parametrize("bits", [(16, 16), (8, 8)])
def test_fused_s5_qat_plain_matches_pallas(relu_state, global_scale, bits,
                                           monkeypatch):
    """At L = 45, t = 16 (a padded last block), per-block or one global
    state scale. The states themselves (W_c the identity, d = 0, so that
    y = relu?(states) exactly): equal to ``scan_block_body`` evaluated op
    by op on the same B-projection, and to the Pallas kernel under the
    quantized-state bar, whose share of differing states is 2 % at 16
    bits: a step there is about 2^8 float32 ulps of a state, so the
    reference's FMAs and reciprocal divisions flip a code now and then,
    and a flip spreads over the later rows of its block and, through the
    carry, over the rest of the sequence (over seeds 0 to 5 the share was
    0 to 1.6 %). The output at random weights within 1e-4·max(1, |ref|)
    but for 0.5 % of its elements, and everywhere within two state steps
    times the weights of its column. Against the Pallas kernel the plain
    version scans on the JAX package's λ tables (:func:`_on_jax_tables`)."""
    seed = 11 + 2 * relu_state + global_scale + bits[0]
    scale = np.float32(3.7) if global_scale else None
    inp = _mixer_inputs(seed, h=14)
    ident = dict(inp, w_c=np.eye(14, dtype=np.float32),
                 d=np.zeros(14, np.float32))
    out, ref = _k4a_both(ident, bits, relu_state, scale)
    bu = (torch.from_numpy(inp["u"]) @ torch.from_numpy(inp["w_b"])).numpy()
    ieee = np.concatenate(_ieee_reference(
        (inp["lam_re"], inp["lam_im"]), (bu[..., :7], bu[..., 7:]), bits, 16,
        amax=scale), axis=-1)
    np.testing.assert_array_equal(out, np.maximum(ieee, 0) if relu_state
                                  else ieee)
    _on_jax_tables(monkeypatch)
    out, ref = _k4a_both(ident, bits, relu_state, scale)
    qmax = 2.0 ** (bits[1] - 1) - 1
    steps = (scale / qmax if scale is not None else
             _block_steps(ref, 16, bits[1], False))
    diff = np.abs(out - ref)
    share = (diff > 1e-6 * np.maximum(1.0, np.abs(ref))).mean()
    assert share <= (0.02 if bits[1] == 16 else 0.005), share
    assert (diff <= 2.0 * steps + 1e-6 * np.maximum(1.0, np.abs(ref))).all()
    out, ref = _k4a_both(inp, bits, relu_state, scale)
    diff = np.abs(out - ref)
    assert (diff > 1e-4 * np.maximum(1.0, np.abs(ref))).mean() <= 0.005
    assert diff.max() <= 2 * np.max(steps) * np.abs(inp["w_c"]).sum(
        axis=0).max() + 1e-4 * max(1.0, np.abs(ref).max())


def _k4a_grads(inp, relu_state, bits, scale):
    j = {k: jnp.asarray(inp[k]) for k in NAMES}

    def loss(*ops):
        y = fused_s5_apply_diff(ops[0], (ops[1], ops[2]), *ops[3:],
                                None if scale is None else jnp.asarray(scale),
                                16, relu_state, bits)
        return jnp.sum(y * inp["g"])

    ref = jax.grad(loss, argnums=tuple(range(6)))(*(j[k] for k in NAMES))
    ops = [torch.from_numpy(inp[k].copy()).requires_grad_(True)
           for k in NAMES]
    qs = None if scale is None else torch.tensor(scale)
    y = fused_s5.FusedS5Fn.apply(*ops, relu_state, bits, qs, 16)
    (y * torch.from_numpy(inp["g"])).sum().backward()
    return [o.grad.numpy() for o in ops], [np.asarray(r) for r in ref]


@pytest.mark.parametrize("relu_state,global_scale", [
    (False, False), (False, True), (True, False)])
def test_fused_s5_fn_qat_gradients_match_jax(relu_state, global_scale):
    """The straight-through backward (the float adjoint, states recomputed
    without fake-quant): rtol = atol 2e-4 of max(1, max|ref|); under
    relu_state 2e-2, the JAX package's bar (a recomputed state within
    rounding of zero may pass the relu the other way)."""
    inp = _mixer_inputs(21 + relu_state)
    ours, refs = _k4a_grads(inp, relu_state, (8, 8),
                            np.float32(5.0) if global_scale else None)
    tol = 2e-2 if relu_state else 2e-4
    for name, o, r in zip(NAMES, ours, refs):
        np.testing.assert_allclose(o, r, rtol=tol,
                                   atol=tol * max(1.0, np.abs(r).max()),
                                   err_msg=name)


@pytest.mark.parametrize("reverse", [False, True])
def test_diag_scan_fn_qat_gradients_match_jax(reverse):
    """dbu is the float adjoint of the cotangents; dλ sums it against the
    saved QUANTIZED states, as the JAX package's residual is: rtol = atol
    2e-4 of max(1, max|ref|)."""
    rng = np.random.RandomState(31 + reverse)
    lam, bu, g = _lam(rng, 6, slow=False), _pair(rng, 2, 37, 6), \
        _pair(rng, 2, 37, 6)
    bits = (8, 8)
    fn = pallas_diag_scan_diff_rev if reverse else pallas_diag_scan_diff

    def loss(lam_, bu_):
        xs = fn(lam_, bu_, bits, 16)
        return jnp.sum(xs[0] * g[0] + xs[1] * g[1])

    ref = jax.grad(loss, argnums=(0, 1))(_j(lam), _j(bu))
    t_lam, t_bu = _t(lam, True), _t(bu, True)
    before = launch_counts()
    xs = tscan.diag_ssm_scan(t_lam, t_bu, reverse=reverse, qat_bits=bits,
                             block_t=16)
    (xs[0] * torch.from_numpy(g[0]) + xs[1] * torch.from_numpy(g[1])
     ).sum().backward()
    assert launch_counts() == before
    for ours, theirs in zip((*t_lam, *t_bu), (*ref[0], *ref[1])):
        theirs = np.asarray(theirs)
        np.testing.assert_allclose(
            ours.grad.numpy(), theirs, rtol=2e-4,
            atol=2e-4 * max(1.0, np.abs(theirs).max()))


def test_qat_modes_refuse_what_they_do_not_take():
    lam = (torch.ones(3) * 0.5, torch.zeros(3))
    bu = (torch.zeros(1, 9, 3), torch.zeros(1, 9, 3))
    with pytest.raises(NotImplementedError, match="reverse"):
        qat_scan.qat_scan(lam, bu, (8, 8), 8, reverse=True,
                          carry_init=(torch.zeros(1, 3), torch.zeros(1, 3)))
    with pytest.raises(ValueError, match="act_bits"):
        qat_scan.qat_scan(lam, bu, (8, None), 8)
    with pytest.raises(ValueError, match="block_t"):
        qat_scan.qat_scan(lam, bu, (8, 8), None)
    # qat_bits with block_requant runs in both directions, but the reverse
    # scan takes no carry
    carry = (torch.zeros(1, 3), torch.zeros(1, 3))
    with pytest.raises(NotImplementedError, match="reverse"):
        tscan.diag_ssm_scan(lam, bu, reverse=True, qat_bits=(8, 8),
                            block_t=8, block_requant=(0.1, 0.1, 8),
                            carry_init=carry)
    with pytest.raises(NotImplementedError, match="reverse"):
        qat_scan.qat_scan(lam, bu, (8, 8), 8, reverse=True,
                          block_requant=(0.1, 0.1, 8), carry_init=carry)
