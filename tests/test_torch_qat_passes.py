"""Kernels K1 qat and K4a qat as the card runs them (``ops/cuda/qat_scan.py``,
``ops/cuda/fused_s5.py`` ``fused_s5_qat``, ``csrc/qat_scan.cu``), on the
CPU: the plan of a call and a plain mirror of its decomposition.

- The plan (:func:`qat_scan.qat_plan`): one thread-block cluster per
  (batch row, time block), each CTA of a cluster one slice of the state
  channels of every row of its block; clusters take tickets in
  block-major order, so the carry a cluster waits for comes from a
  cluster with an earlier ticket. Every (batch row, block, channel) is
  held and stored by exactly one CTA; the cluster and each CTA's shared
  memory stay within the card's limits; a block that does not fit is
  refused before any launch, with the limit in the message; K4a's row
  passes are ``engine_layer.pass_plan``'s.
- The mirror, written here: per cluster in ticket order, each CTA's
  channel slice loaded (zero padding rows, the carry folded into the
  first row of K1), the doubling passes on the slices with each pass's
  scale from the maxima of all slices combined, the carry fold from the
  carry its predecessor published, the folded block's maxima combined,
  the fake-quant (and the block requant), the last row published. Bit
  for bit against the unchanged ``qat_scan_plain`` and
  ``fused_s5_qat_plain`` in every mode and at several splits.
- The two modes this slice adds, against the JAX package's kernels in
  interpret mode: K1 qat with ``block_requant`` (forward, with and
  without a carry) and K4a qat over int8 weights with per-half
  ``wb_scales`` / ``wc_scales`` and ``block_requant``: the requantized
  states within one code of the reference's in at most 0.5 % of the
  elements (the engine's state-code bar), the outputs within the
  quantized-state bar of ``tests/test_torch_qat.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sparsernns_tpu.ops.pallas.fused_s5 import fused_s5_apply
from sparsernns_tpu.ops.pallas.scan_kernel import pallas_diag_scan
from sparsernns_tpu_torch.ops.cuda import engine_layer, fused_s5, qat_scan
from sparsernns_tpu_torch.ops.scan import grid_value
from sparsernns_tpu_torch.quantize.qat import _on_grid
from sparsernns_tpu_torch.utils.trace import launch_counts

#: a 16-bit and an 8-bit frozen state grid (s_re, s_im, bits)
GRID16 = (2.0 ** -8, 2.0 ** -9, 16)
GRID8 = (2.0 ** -2, 2.0 ** -3, 8)


# ----------------------------------------------------------------- plan

@pytest.mark.parametrize("length", [37, 70, 3751])
@pytest.mark.parametrize("batch", [1, 8, 32])
@pytest.mark.parametrize("p", [12, 128])
@pytest.mark.parametrize("block_t", [16, 32, 256, 512, 1024])
def test_plan_covers_every_state_once(block_t, p, batch, length):
    """Every (batch row, block, channel) held and stored by one CTA; a
    cluster's predecessor has an earlier ticket; the cluster at most 16
    CTAs (8 where portable suffices), the slice a power of two that
    divides the CTA's threads, no CTA without a channel, shared memory
    within the card's; the launches of K1 and K4a."""
    plan = qat_scan.qat_plan(batch, length, p, block_t)
    t, l_pad, _ = qat_scan.scan_geometry(length, block_t)
    assert (plan.t, plan.l_pad) == (t, l_pad)
    assert plan.cpc & (plan.cpc - 1) == 0
    assert qat_scan.THREADS % plan.cpc == 0 and plan.cpc <= qat_scan.MAX_CPC
    assert plan.cluster <= qat_scan.MAX_CLUSTER
    assert (plan.cluster - 1) * plan.cpc < p <= plan.cluster * plan.cpc
    assert plan.smem <= qat_scan.MAX_SMEM
    assert 8 * t * plan.cpc <= max(qat_scan.CTA_BYTES,
                                   8 * t * -(-p // qat_scan.MAX_CLUSTER))
    covered = np.zeros((batch, plan.n_blocks, p), int)
    ticket_of = {}
    for ticket in range(plan.n_clusters):
        b, j = plan.cluster_of(ticket)
        ticket_of[b, j] = ticket
        for rank in range(plan.cluster):
            ch = plan.channels(rank)
            assert len(ch) > 0
            covered[b, j, ch.start:ch.stop] += 1
    assert (covered == 1).all()
    for (b, j), ticket in ticket_of.items():
        if j:
            assert ticket_of[b, j - 1] < ticket
    assert plan.launches() == [
        (qat_scan.TABLES_KERNEL, qat_scan.TABLE_CLUSTER,
         qat_scan.TABLE_CLUSTER),
        (qat_scan.SCAN_KERNEL, batch * plan.n_blocks * plan.cluster,
         plan.cluster)]
    if (batch, length, p) == (8, 3751, 128) and block_t >= 512:
        assert plan.ctas >= 256
        assert plan.cluster == {512: 8, 1024: 16}[block_t]
        assert plan.smem <= 64 * 1024 + 4096


def test_plan_splits_and_block_limit():
    """The 128 KB split halves the cluster of the default 64 KB; t = 2048
    at P = 128 takes a cluster of 16, 128 KB a CTA; the largest block at
    P = 128 is 3592 rows, and a larger
    one is refused by the plan and by both CUDA wrappers before they build
    or launch anything (here on CPU tensors, where no nvcc exists)."""
    for t, n in ((256, 4), (512, 8), (1024, 16)):
        assert qat_scan.qat_plan(8, 3751, 128, t).cluster == n
        assert qat_scan.qat_plan(8, 3751, 128, t, 128 * 1024).cluster == n // 2
    wide = qat_scan.qat_plan(8, 3751, 128, 2048)
    assert (wide.cluster, wide.cpc, wide.t) == (16, 8, 2048)
    assert qat_scan.max_block(128) == 3592
    qat_scan.qat_plan(1, 3592, 128, 3592)
    with pytest.raises(ValueError, match="largest block at P=128 is 3592"):
        qat_scan.qat_plan(1, 3600, 128, 3600)
    bu = (torch.zeros(1, 5000, 128), torch.zeros(1, 5000, 128))
    lam = (torch.zeros(128), torch.zeros(128))
    with pytest.raises(ValueError, match="3592 rows"):
        qat_scan.qat_scan_cuda(lam, bu, (8, 8), 4096)
    u = torch.zeros(1, 5000, 16)
    with pytest.raises(ValueError, match="3592 rows"):
        fused_s5.fused_s5_qat_cuda(u, lam, torch.zeros(16, 256),
                                   torch.zeros(256, 16), torch.zeros(16),
                                   (8, 8), 4096)


@pytest.mark.parametrize("batch,length", [(1, 37), (3, 70), (8, 3751),
                                          (32, 3751)])
def test_mixer_launches_row_passes_of_pass_plan(batch, length):
    """K4a qat: the tables, the head row pass, the scan, the tail row pass;
    the row passes over ``pass_plan``'s tiles of the flattened rows (938
    CTAs at B = 8), at most five launches."""
    u = torch.zeros(batch, length, 192)
    w_b = torch.zeros(192, 256)
    plan, pp = fused_s5.qat_plan(u, w_b, 512)
    assert pp == engine_layer.pass_plan(batch, length, 192, 128, 1,
                                        encoder=False)
    rows = pp.row_ctas
    assert rows == len(pp.tiles())
    launches = plan.launches(rows)
    assert [k for k, _, _ in launches] == [
        qat_scan.TABLES_KERNEL, engine_layer.ROW_PASS,
        qat_scan.MIXER_SCAN_KERNEL, engine_layer.ROW_PASS]
    assert len(launches) <= 5
    if batch == 8:
        assert rows == 938
    with pytest.raises(ValueError, match="shared memory"):
        fused_s5.qat_plan(torch.zeros(1, 8, 800), w_b, 512)


# --------------------------------------------------- the mirror

def _combined_max(slices, rows):
    """Each half's absmax over ``rows`` of every slice: the partial of each
    CTA, combined across the cluster."""
    out = []
    for half in (0, 1):
        m = torch.zeros(())
        for sl in slices:
            part = sl[half][rows]
            if part.numel():
                m = torch.maximum(m, part.abs().amax())
        out.append(m)
    return out


def _q(x, m, bits, amax):
    if bits >= 32:
        return x
    return _on_grid(x, m if amax is None else amax, bits)


def mirror_scan(x, plan, tables, act_bits, amax=None, block_requant=None):
    """The scan kernel's decomposition of the QAT scan of the padded
    blocks ``x`` ((B, L_pad, P) pair, the load's result): cluster by
    cluster in ticket order, each CTA's channel slice, maxima combined
    across the cluster, the carry from its publisher. Returns the states
    (B, L_pad, P) pair."""
    pow_re, pow_im, ct_re, ct_im = tables
    t, p = plan.t, plan.p
    out = (torch.empty_like(x[0]), torch.empty_like(x[1]))
    published = {}
    for ticket in range(plan.n_clusters):
        b, j = plan.cluster_of(ticket)
        rows = slice(j * t, (j + 1) * t)
        chans = [plan.channels(r) for r in range(plan.cluster)]
        sl = [[x[h][b, rows, ch.start:ch.stop].clone() for h in (0, 1)]
              for ch in chans]
        m = _combined_max(sl, slice(0, t - 1))
        for k in range(plan.num_passes):
            d = 1 << k
            for s, ch in zip(sl, chans):
                sh = [_q(F.pad(s[h][:t - d], (0, 0, d, 0)), m[h], act_bits,
                         amax) for h in (0, 1)]
                lr, li = pow_re[k, ch.start:ch.stop], pow_im[k,
                                                             ch.start:ch.stop]
                s[0], s[1] = (s[0] + (lr * sh[0] - li * sh[1]),
                              s[1] + (lr * sh[1] + li * sh[0]))
            m = _combined_max(sl, slice(0, max(t - 2 * d, 0)))
        carry = published.get((b, j - 1), (torch.zeros(p), torch.zeros(p)))
        qc = [_q(c, c.abs().amax(), act_bits, amax) for c in carry]
        for s, ch in zip(sl, chans):
            tr, ti = ct_re[:, ch.start:ch.stop], ct_im[:, ch.start:ch.stop]
            cr, ci = qc[0][ch.start:ch.stop], qc[1][ch.start:ch.stop]
            s[0], s[1] = (s[0] + (tr * cr - ti * ci),
                          s[1] + (tr * ci + ti * cr))
        m = _combined_max(sl, slice(0, t))
        last = (torch.empty(p), torch.empty(p))
        for s, ch in zip(sl, chans):
            for h in (0, 1):
                y = _q(s[h], m[h], act_bits, amax)
                if block_requant is not None:
                    y = grid_value(y, block_requant[h], block_requant[2])
                out[h][b, rows, ch.start:ch.stop] = y
                last[h][ch.start:ch.stop] = y[-1]
        published[b, j] = last
    return out


def mirror_k1(lam, bu, bits, block_t, reverse=False, carry=None,
              block_requant=None, cta_bytes=None):
    """K1 qat as the kernels run it: the tables, the load (the carry
    folded into time 0, the reverse direction indexed backwards, zero rows
    past L), the scan, the store of rows < L."""
    a_bits, act_bits = bits
    b, length, p = bu[0].shape
    plan = qat_scan.qat_plan(b, length, p, block_t, cta_bytes)
    tables = qat_scan.lambda_power_tables(lam, plan.t, plan.num_passes,
                                          a_bits)
    x = [torch.zeros(b, plan.l_pad, p) for _ in (0, 1)]
    for row in range(length):
        tau = length - 1 - row if reverse else row
        vr, vi = bu[0][:, tau], bu[1][:, tau]
        if carry is not None and tau == 0:
            lr, li = lam
            vr = vr + (lr * carry[0] - li * carry[1])
            vi = vi + (lr * carry[1] + li * carry[0])
        x[0][:, row], x[1][:, row] = vr, vi
    ys = mirror_scan(x, plan, tables, act_bits, None, block_requant)
    ys = [y[:, :length] for y in ys]
    return tuple(y.flip(1) for y in ys) if reverse else tuple(ys)


def _lam(rng, p):
    r = rng.uniform(0.95, 0.999, p)
    th = rng.uniform(-3.0, 3.0, p)
    return (torch.from_numpy((r * np.cos(th)).astype(np.float32)),
            torch.from_numpy((r * np.sin(th)).astype(np.float32)))


def _pair(rng, *shape):
    return tuple(torch.from_numpy(rng.randn(*shape).astype(np.float32))
                 for _ in (0, 1))


#: (direction, L, t, P, (a_bits, act_bits), block requant)
K1_CASES = [
    ("forward", 37, 8, 5, (16, 16), None),
    ("forward", 64, 32, 6, (8, 8), None),
    ("reverse", 100, 32, 7, (8, 8), None),
    ("reverse", 37, 16, 12, (4, 4), None),
    ("carry", 70, 16, 12, (16, 16), None),
    ("forward", 45, 16, 7, (None, 8), None),
    ("carry", 45, 16, 7, (8, 32), None),
    ("forward", 70, 32, 12, (16, 16), GRID16),
    ("carry", 45, 16, 7, (8, 8), GRID8),
]


@pytest.mark.parametrize("split", [None, 8, 16])
@pytest.mark.parametrize("direction,length,t,p,bits,rq", K1_CASES)
def test_k1_mirror_equals_plain(direction, length, t, p, bits, rq, split):
    """The mirrored decomposition equals ``qat_scan_plain`` bit for bit;
    ``split`` sets the bytes of a CTA's slice over 8 t (1 and 2: one or
    two channels a CTA, so every scale combines several CTAs' maxima)."""
    rng = np.random.RandomState(length + t + p)
    lam, bu = _lam(rng, p), _pair(rng, 2, length, p)
    carry = _pair(rng, 2, p) if direction == "carry" else None
    reverse = direction == "reverse"
    cta_bytes = None if split is None else split * t
    if split is not None:
        assert qat_scan.qat_plan(2, length, p, t, cta_bytes).cluster > 1
    ref = qat_scan.qat_scan_plain(lam, bu, bits, t, reverse, carry, rq)
    out = mirror_k1(lam, bu, bits, t, reverse, carry, rq, cta_bytes)
    for o, r in zip(out, ref):
        assert torch.equal(o, r)


def mirror_k4a(u, lam, w_b, w_c, d, bits, block_t, relu_state=False,
               qat_scale=None, wb_scales=None, wc_scales=None,
               block_requant=None, cta_bytes=None):
    """K4a qat as the kernels run it: the head row pass over
    ``pass_plan``'s tiles, the scan of the B-projection with the padding
    rows only in the CTAs' slices, the tail row pass over the tiles."""
    a_bits, act_bits = bits
    b, length, h = u.shape
    p = w_b.shape[-1] // 2
    pp = engine_layer.pass_plan(b, length, h, p, 1, encoder=False)
    plan = qat_scan.qat_plan(b, length, p, block_t, cta_bytes)
    rows = u.reshape(b * length, h)
    bu = torch.empty(b * length, 2 * p)
    for r0, r1 in pp.tiles():
        x = rows[r0:r1] @ w_b.to(torch.float32)
        if wb_scales is not None:
            x = torch.cat([x[:, :p] * wb_scales[0], x[:, p:] * wb_scales[1]],
                          dim=-1)
        bu[r0:r1] = x
    bu = bu.view(b, length, 2 * p)
    pad = (0, 0, 0, plan.l_pad - length)
    x = [F.pad(bu[..., :p], pad), F.pad(bu[..., p:], pad)]
    tables = qat_scan.lambda_power_tables(lam, plan.t, plan.num_passes,
                                          a_bits)
    xs = mirror_scan(x, plan, tables, act_bits, qat_scale, block_requant)
    states = torch.cat([xs[0][:, :length], xs[1][:, :length]], dim=-1)
    states = states.reshape(b * length, 2 * p)
    y = torch.empty(b * length, h)
    for r0, r1 in pp.tiles():
        s = states[r0:r1]
        if relu_state:
            s = torch.relu(s)
        if wc_scales is not None:
            s = torch.cat([s[:, :p] * wc_scales[0], s[:, p:] * wc_scales[1]],
                          dim=-1)
        y[r0:r1] = s @ w_c.to(torch.float32) + d * rows[r0:r1]
    return y.view(b, length, h)


def _mixer(seed, b=2, length=45, h=14, p=7, int8=False):
    rng = np.random.RandomState(seed)
    lam = _lam(rng, p)
    if int8:
        w_b = torch.from_numpy(rng.randint(-127, 128, (h, 2 * p))
                               .astype(np.int8))
        w_c = torch.from_numpy(rng.randint(-127, 128, (2 * p, h))
                               .astype(np.int8))
        scales = dict(wb_scales=(2.0 ** -7, 2.0 ** -8),
                      wc_scales=(2.0 ** -8, 2.0 ** -7))
    else:
        w_b = torch.from_numpy((rng.randn(h, 2 * p) * 0.3)
                               .astype(np.float32))
        w_c = torch.from_numpy((rng.randn(2 * p, h) * 0.3)
                               .astype(np.float32))
        scales = {}
    u = torch.from_numpy(rng.randn(b, length, h).astype(np.float32))
    d = torch.from_numpy(rng.randn(h).astype(np.float32))
    return (u, lam, w_b, w_c, d), scales


@pytest.mark.parametrize("split", [None, 32])
@pytest.mark.parametrize("mode", ["float", "int8", "int8 requant"])
@pytest.mark.parametrize("global_scale", [False, True])
@pytest.mark.parametrize("relu_state", [False, True])
def test_k4a_mirror_equals_plain(relu_state, global_scale, mode, split):
    """The mirrored passes equal ``fused_s5_qat_plain`` bit for bit at
    L = 45, t = 16 (a padded last block): float weights, int8 weights with
    per-half scales, and those with the block requant; per-block and
    global scales; relu_state off and on."""
    ops, scales = _mixer(3 + relu_state + 2 * global_scale,
                         int8=mode != "float")
    if mode == "int8 requant":
        scales["block_requant"] = GRID16
    scale = torch.tensor(3.5) if global_scale else None
    bits = (8, 8) if mode == "float" else (16, 16)
    cta_bytes = None if split is None else split * 16
    ref = fused_s5.fused_s5_qat(*ops, bits, 16, relu_state, scale, **scales)
    out = mirror_k4a(*ops, bits, 16, relu_state, scale, cta_bytes=cta_bytes,
                     **scales)
    assert torch.equal(out, ref)


def test_k4a_plain_modes_reduce_to_the_float_mode():
    """Float weights with unit scales give the float QAT mode's value: the
    new arguments add nothing when they are neutral."""
    ops, _ = _mixer(5)
    ref = fused_s5.fused_s5_qat_plain(*ops, (8, 8), 16, True)
    out = fused_s5.fused_s5_qat_plain(*ops, (8, 8), 16, True,
                                      wb_scales=(1.0, 1.0),
                                      wc_scales=(1.0, 1.0))
    assert torch.equal(out, ref)


# ------------------------------------------- the new modes against JAX

def _codes_close(out, ref, grid, name):
    """The engine's state-code bar: codes on the frozen grid at most one
    apart, in at most 0.5 % of the elements."""
    for h, (o, r) in enumerate(zip(out, ref)):
        o, r = np.asarray(o) / grid[h], np.asarray(r) / grid[h]
        np.testing.assert_array_equal(o, np.round(o))   # on the grid
        diff = np.abs(o - r)
        assert diff.max() <= 1, (name, diff.max())
        assert (diff > 0).mean() <= 0.005, (name, (diff > 0).mean())


def _ieee_k1(lam, bu, bits, t, carry, grid):
    """``pallas_diag_scan`` with ``qat_bits`` and ``block_requant`` (its
    wrapper and ``scan_block_body``) evaluated one numpy float32 operation
    at a time, forward, with the JAX package's own λ tables run eagerly:
    IEEE rounding, no contraction. (The Pallas kernel always runs jitted,
    which divides by a scale through its reciprocal and contracts into
    FMAs.)"""
    import jax
    from sparsernns_tpu.ops.pallas.scan_kernel import lambda_power_tables
    f32 = np.float32
    act = bits[1]

    def fq(x):
        qmax = f32(2.0 ** (act - 1) - 1.0)
        s = np.maximum(np.abs(x).max(), f32(1e-20)) / qmax
        return np.clip(np.round(x / s), -qmax - f32(1), qmax) * s

    def rq(x, s):
        qmax = f32(2.0 ** (grid[2] - 1) - 1.0)
        return np.clip(np.round(x / f32(s)), -qmax - f32(1), qmax) * f32(s)

    br, bi = (a.numpy().copy() for a in bu)
    b, length, p = br.shape
    lr, li = (a.numpy() for a in lam)
    if carry is not None:
        cr, ci = (a.numpy() for a in carry)
        br[:, 0] = br[:, 0] + (lr * cr - li * ci)
        bi[:, 0] = bi[:, 0] + (lr * ci + li * cr)
    t = min(t, -(-length // 8) * 8)
    l_pad, n_pass = -(-length // t) * t, max(1, (t - 1).bit_length())
    br, bi = (np.pad(a, ((0, 0), (0, l_pad - length), (0, 0)))
              for a in (br, bi))
    with jax.disable_jit():
        pr, pi, (tr, ti) = jax.tree.map(np.asarray, lambda_power_tables(
            jnp.asarray(lr), jnp.asarray(li), t, n_pass, bits))
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
            xr = rq(fq(xr + (tr * qr - ti * qi)), grid[0])
            xi = rq(fq(xi + (tr * qi + ti * qr)), grid[1])
            out[0][row, j:j + t], out[1][row, j:j + t] = xr, xi
            c_re, c_im = xr[-1], xi[-1]
    return [a[:, :length] for a in out]


def _lam_fast(rng, p):
    """Eigenvalues of the engine tests' range (|λ| 0.5 to 0.97)."""
    r = rng.uniform(0.5, 0.97, p)
    th = rng.uniform(-np.pi, np.pi, p)
    return (torch.from_numpy((r * np.cos(th)).astype(np.float32)),
            torch.from_numpy((r * np.sin(th)).astype(np.float32)))


@pytest.mark.parametrize("bits,grid", [((16, 16), GRID16), ((8, 8), GRID8)])
@pytest.mark.parametrize("carry", [False, True])
def test_k1_qat_block_requant_matches_pallas(bits, grid, carry):
    """K1 qat with ``block_requant`` (forward, L = 100 over blocks of 32,
    a padded last block). Slowly decaying λ (|λ| 0.95 to 0.999): equal bit
    for bit to ``scan_block_body`` evaluated op by op. λ of the engine
    tests' range: against ``pallas_diag_scan`` in interpret mode, the
    states' codes on the frozen grid within one of the reference's in at
    most 0.5 % (the jitted reference flips a fake-quant code at a rounding
    tie now and then; a requantized carry then carries the flip through
    the channel, and with |λ| near 1 over most of the sequence: 1.2 % of
    the states at one of six seeds). ``diag_ssm_scan`` routes the mode to
    the QAT scan, whose plain version runs on the CPU."""
    from sparsernns_tpu_torch.ops import scan as tscan
    rng = np.random.RandomState(40 + carry + bits[0])
    p, length, t = 7, 100, 32
    lam, bu = _lam(rng, p), _pair(rng, 2, length, p)
    c = _pair(rng, 2, p) if carry else None
    before = launch_counts()["qat_scan"]
    with torch.no_grad():
        out = tscan.diag_ssm_scan(lam, bu, carry_init=c, block_requant=grid,
                                  block_t=t, qat_bits=bits)
    assert launch_counts()["qat_scan"] == before
    for o, r in zip(out, _ieee_k1(lam, bu, bits, t, c, grid)):
        np.testing.assert_array_equal(o.numpy(), r)
    lam = _lam_fast(rng, p)
    j = lambda pair: tuple(jnp.asarray(a.numpy()) for a in pair)  # noqa
    ref = pallas_diag_scan(j(lam), j(bu), carry_init=None if c is None
                           else j(c), block_t=t, interpret=True,
                           block_requant=grid, qat_bits=bits)
    out = qat_scan.qat_scan_plain(lam, bu, bits, t, carry_init=c,
                                  block_requant=grid)
    _codes_close(out, ref, grid, f"K1 qat requant carry={carry}")


@pytest.mark.parametrize("global_scale", [False, True])
@pytest.mark.parametrize("relu_state", [False, True])
def test_k4a_qat_int8_scales_requant_matches_pallas(relu_state,
                                                    global_scale):
    """K4a qat over int8 weights with per-half ``wb_scales`` /
    ``wc_scales`` and ``block_requant`` against ``fused_s5_apply`` in
    interpret mode (L = 45, t = 16). The states alone (W_c the int8
    identity with unit scales, d = 0, so y = relu?(states)): codes within
    one of the reference's in at most 0.5 %. The output at random int8
    weights: within 1e-4 * max(1, |ref|) but for 0.5 % of its elements,
    and everywhere within two state codes times the C-side weights of
    its column."""
    ops, scales = _mixer(50 + relu_state + 2 * global_scale, int8=True)
    u, lam, w_b, w_c, d = ops
    scale = 6.0 if global_scale else None
    bits = (16, 16)

    def both(w_c, d, wc_scales):
        jref = np.asarray(fused_s5_apply(
            jnp.asarray(u.numpy()), tuple(jnp.asarray(a.numpy())
                                          for a in lam),
            jnp.asarray(w_b.numpy()), jnp.asarray(w_c.numpy()),
            jnp.asarray(d.numpy()), block_t=16, relu_state=relu_state,
            interpret=True, block_requant=GRID16,
            wb_scales=scales["wb_scales"], wc_scales=wc_scales,
            qat_bits=bits, qat_state_scale=None if scale is None
            else jnp.asarray(scale, jnp.float32)))
        before = launch_counts()["fused_s5_qat"]
        out = fused_s5.fused_s5_qat(
            u, lam, w_b, w_c, d, bits, 16, relu_state,
            None if scale is None else torch.tensor(scale),
            wb_scales=scales["wb_scales"], wc_scales=wc_scales,
            block_requant=GRID16).numpy()
        assert launch_counts()["fused_s5_qat"] == before
        return out, jref

    p = w_b.shape[1] // 2
    eye = torch.eye(2 * p, dtype=torch.int8)
    out, ref = both(eye, torch.zeros(2 * p), (1.0, 1.0))
    _codes_close((out[..., :p], out[..., p:]), (ref[..., :p], ref[..., p:]),
                 GRID16, "K4a qat states")
    out, ref = both(w_c, d, scales["wc_scales"])
    diff = np.abs(out - ref)
    top = max(1.0, np.abs(ref).max())
    assert (diff > 1e-4 * top).mean() <= 0.005
    col = np.abs(w_c.numpy().astype(np.float64))
    col = np.concatenate([col[:p] * scales["wc_scales"][0] * GRID16[0],
                          col[p:] * scales["wc_scales"][1] * GRID16[1]]
                         ).sum(axis=0).max()
    assert diff.max() <= 2 * col + 1e-4 * top
