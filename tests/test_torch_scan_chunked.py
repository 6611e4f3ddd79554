"""Kernel K1 as the card runs it (``ops/cuda/diag_scan.py``,
``csrc/diag_scan.cu``), on the CPU: the plan of a call and a plain mirror
of its decomposition, and the reverse scan's block requant.

- The plan (:func:`diag_scan.scan_plan`): time, in the walk's order, cut
  into chunks; every row in exactly one chunk; no chunk straddles a block
  end of the requant, forward or reverse (reverse blocks align from the
  end); at least 132 CTAs on every pass over (B, L, P) at the serving
  shape; one launch for a short sequence.
- The mirror (:func:`diag_scan.diag_scan_chunked_plain`): chunk-local scans,
  the carry chain, the walk again from every carry (with the block
  requant: every block from its predicted carry, and again where the
  block before ended elsewhere), rounded as the kernel rounds. Against
  the sequential recurrence: float modes within 1e-5 of max|x| (the
  chunked sum rounds otherwise), the block requant bit for bit. Against
  the JAX package's ``pallas_diag_scan`` in interpret mode: float modes
  within 1e-5 of max|x|, the block requant under the engine's state-code
  bar (states exactly on the grid, codes at most one apart in at most
  0.5 % of the elements: the Pallas kernel's doubling scan rounds
  otherwise, and a requant can flip at a tie).
- The reverse scan with ``block_requant``, sequential and with
  ``qat_bits`` through ``qat_scan_plain``, against the Pallas kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsernns_tpu.ops.pallas.scan_kernel import pallas_diag_scan
from sparsernns_tpu_torch.ops import scan as tscan
from sparsernns_tpu_torch.ops.cuda import diag_scan, qat_scan
from sparsernns_tpu_torch.utils.trace import launch_counts

#: frozen state grids (s_re, s_im, bits): 16 and 8 bits
GRID16 = (2.0 ** -10, 2.0 ** -11, 16)
GRID8 = (2.0 ** -5, 2.0 ** -6, 8)
#: the QAT tests' grids (tests/test_torch_qat_passes.py): the 8-bit one
#: no finer than an 8-bit fake-quant step of the states
QAT_GRIDS = {16: (2.0 ** -8, 2.0 ** -9, 16), 8: (2.0 ** -2, 2.0 ** -3, 8)}


def _inputs(seed, b=2, l=37, p=8, radius=(0.5, 0.99)):
    """λ, bu and a carry from a numpy seed (as tests/test_torch_scan.py)."""
    rng = np.random.RandomState(seed)
    r = rng.uniform(*radius, p)
    th = rng.uniform(-np.pi, np.pi, p)
    lam = ((r * np.cos(th)).astype(np.float32),
           (r * np.sin(th)).astype(np.float32))
    bu = (rng.randn(b, l, p).astype(np.float32),
          rng.randn(b, l, p).astype(np.float32))
    carry = (rng.randn(b, p).astype(np.float32),
             rng.randn(b, p).astype(np.float32))
    return lam, bu, carry


def _t(pair):
    return tuple(torch.from_numpy(a) for a in pair)


def _j(pair):
    return tuple(jnp.asarray(a) for a in pair)


def _float_close(out, ref, name):
    """Within 1e-5 of max|ref| (the f32 sums in another order)."""
    ref = [np.asarray(r) for r in ref]
    scale = max(np.abs(r).max() for r in ref)
    for o, r in zip(out, ref):
        err = np.abs(np.asarray(o) - r).max()
        assert err <= 1e-5 * scale, (name, err, scale)


def _codes_close(out, ref, grid, name):
    """The engine's state-code bar: the states exactly on the frozen grid,
    codes at most one apart, in at most 0.5 % of the elements."""
    for h, (o, r) in enumerate(zip(out, ref)):
        o, r = np.asarray(o) / grid[h], np.asarray(r) / grid[h]
        np.testing.assert_array_equal(o, np.round(o))
        diff = np.abs(o - np.round(r))
        assert diff.max() <= 1, (name, diff.max())
        assert (diff > 0).mean() <= 0.005, (name, (diff > 0).mean())


# ----------------------------------------------------------------- plan

@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("block_t", [None, 7, 16, 40, 512])
@pytest.mark.parametrize("p", [12, 128])
@pytest.mark.parametrize("length", [1, 37, 256, 257, 300, 3751])
@pytest.mark.parametrize("batch", [1, 8])
def test_plan_covers_every_row_once(batch, length, p, block_t, reverse):
    """Every time row in exactly one chunk, chunks in the walk's order and
    each a run of neighbouring rows; a chunk of more than one crosses no
    block end but at its last row, and says so; full chunks but at a
    block's end and the sequence's end; the launches' grids."""
    plan = diag_scan.scan_plan(batch, length, p, block_t, reverse)
    assert plan.vec == (4 if p % 4 == 0 else 1)
    seen = np.zeros(length, int)
    step = 0
    for k in range(plan.n_chunks):
        s0, n, ends = plan.chunk_rows(k)
        assert s0 == step and n >= 1
        rows = plan.time_rows(k)
        walk = [length - 1 - t if reverse else t for t in rows]
        assert walk == list(range(s0, s0 + n))
        seen[list(rows)] += 1
        step += n
        if plan.n_chunks > 1 and block_t is not None:
            inner = [s for s in walk[:-1]
                     if tscan.block_end(s, length, block_t)]
            assert not inner, (k, inner)
            assert ends == tscan.block_end(walk[-1], length, block_t)
        if k < plan.n_chunks - 1:
            assert n == (plan.tail if ends else plan.chunk)
    assert step == length and (seen == 1).all()
    grids = [g for _, g, _ in plan.launches()]
    assert all(threads == diag_scan.LANES
               for _, _, threads in plan.launches())
    if not plan.block_pass:
        assert grids[-1] == (plan.n_chunks, -(-p // (32 * plan.vec)), batch)
    if plan.n_chunks > 1:
        last = diag_scan.OUT_PASS if block_t is None else diag_scan.BLOCK_PASS
        assert [name for name, _, _ in plan.launches()] == [
            diag_scan.CHUNK_PASS, diag_scan.CARRY_PASS, last]
        assert grids[0] == (plan.n_chunks - 1, plan.slices, batch)
        assert grids[1] == (-(-p // 32), batch, 1)
        if block_t is not None:
            assert plan.block_pass and plan.block == min(block_t, length)
            assert grids[2] == (-(-length // plan.block), -(-p // 32), batch)
            assert all(plan.chunk_rows(k)[2] == (k % plan.per_block
                                                 == plan.per_block - 1)
                       for k in range(plan.n_chunks - 1))


@pytest.mark.parametrize("block_t", [None, 512, 100])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("batch", [8, 32])
def test_plan_fills_the_card_at_the_serving_shape(batch, reverse, block_t):
    """B = 8 and 32, L = 3751, P = 128: every pass over (B, L, P) at least
    132 CTAs (one an SM), not B; 128-bit loads; three launches."""
    plan = diag_scan.scan_plan(batch, 3751, 128, block_t, reverse)
    assert plan.vec == 4 and plan.slices == 1
    launches = plan.launches()
    assert len(launches) == 3
    for name, grid, _ in launches:
        if name != diag_scan.CARRY_PASS:
            assert grid[0] * grid[1] * grid[2] >= diag_scan.SMS, (name, grid)


@pytest.mark.parametrize("block_t", [None, 32, 512])
@pytest.mark.parametrize("length", [1, 70, 125, diag_scan.SHORT_LENGTH])
def test_plan_short_sequence_is_one_launch(length, block_t):
    """A sequence of at most SHORT_LENGTH rows (a 1 s streaming chunk is
    125 frames) is one chunk: the output pass alone, one launch, whose
    walk puts the carry on the grid at every block end."""
    plan = diag_scan.scan_plan(8, length, 128, block_t)
    assert plan.n_chunks == 1 and plan.chunk == length
    assert plan.launches() == [(diag_scan.OUT_PASS, (1, 1, 8), 32)]
    assert plan.requant_block == (None if block_t is None
                                  else min(block_t, length))
    longer = diag_scan.scan_plan(8, diag_scan.SHORT_LENGTH + 1, 128, block_t)
    assert len(longer.launches()) == 3


def test_plan_refuses_empty_shapes_and_bad_blocks():
    with pytest.raises(ValueError, match="empty"):
        diag_scan.scan_plan(0, 10, 8)
    with pytest.raises(ValueError, match="block_t"):
        diag_scan.scan_plan(2, 10, 8, 0)
    lam, bu, _ = _inputs(0)
    with pytest.raises(ValueError, match="block_t"):
        diag_scan.diag_scan_chunked_plain(_t(lam), _t(bu),
                                          block_requant=GRID8)


# ------------------------------------------- mirror vs the sequential scan

#: (batch, length, p, chunk): chunk None is the plan's own choice
SHAPES = [(2, 300, 16, None), (3, 100, 12, 16), (2, 37, 8, 8),
          (1, 200, 10, 32), (2, 9, 16, 16)]


@pytest.mark.parametrize("mode", ["forward", "carry", "reverse"])
@pytest.mark.parametrize("shape", SHAPES)
def test_mirror_matches_sequential_float(shape, mode):
    """Chunk-local scans, carries, walk again: within 1e-5 of max|x| of the
    sequential recurrence."""
    b, l, p, chunk = shape
    lam, bu, carry = _inputs(l + p, b, l, p, radius=(0.5, 0.999))
    reverse = mode == "reverse"
    c = _t(carry) if mode == "carry" else None
    plan = diag_scan.scan_plan(b, l, p, None, reverse, chunk)
    out = diag_scan.diag_scan_chunked_plain(_t(lam), _t(bu), c, reverse,
                                            plan=plan)
    ref = tscan.sequential_diag_scan(_t(lam), _t(bu), c, reverse=reverse)[0]
    _float_close(out, ref, f"{shape} {mode}")


@pytest.mark.parametrize("grid", [GRID16, GRID8])
@pytest.mark.parametrize("block_t", [7, 16, 40])
@pytest.mark.parametrize("mode", ["forward", "carry", "reverse"])
@pytest.mark.parametrize("shape", SHAPES)
def test_mirror_matches_sequential_requant(shape, mode, block_t, grid):
    """With the block requant (block_t 7 and 40: no multiple of the chunk;
    16: a multiple): the block pass walks every block from its predicted
    carry and again where the prediction was off, so the states are the
    sequential recurrence's bit for bit (the state-code bar holds with
    no code apart)."""
    b, l, p, chunk = shape
    lam, bu, carry = _inputs(l + p + block_t, b, l, p)
    reverse = mode == "reverse"
    c = _t(carry) if mode == "carry" else None
    plan = diag_scan.scan_plan(b, l, p, block_t, reverse, chunk)
    out = diag_scan.diag_scan_chunked_plain(_t(lam), _t(bu), c, reverse,
                                            grid, block_t, plan)
    ref = tscan.sequential_diag_scan(_t(lam), _t(bu), c, reverse=reverse,
                                     block_requant=grid, block_t=block_t)[0]
    _codes_close(out, ref, grid, f"{shape} {mode} block_t={block_t}")
    for o, r in zip(out, ref):
        assert torch.equal(o, r)
    if grid is GRID8:
        assert np.abs(out[0].numpy()).max() >= 127 * grid[0]   # clipped


def test_mirror_writes_the_carry_at_a_block_end():
    """At the last row of a block-ending chunk the state written is the
    carry into the next block: walking each block alone, from the state
    written at the end of the block before, gives the same states (but
    the block's own last row, which is then the written carry onward)."""
    b, l, p, block_t = 2, 100, 8, 24
    lam, bu, _ = _inputs(5, b, l, p)
    plan = diag_scan.scan_plan(b, l, p, block_t, chunk=16)
    out = diag_scan.diag_scan_chunked_plain(_t(lam), _t(bu), None, False,
                                            GRID16, block_t, plan)
    for t0 in range(block_t, l, block_t):
        n = min(block_t, l - t0)
        c = (out[0][:, t0 - 1], out[1][:, t0 - 1])
        part = diag_scan.diag_scan_chunked_plain(
            _t(lam), tuple(x[:, t0:t0 + n] for x in _t(bu)), c, False,
            GRID16, block_t, diag_scan.scan_plan(b, n, p, block_t, chunk=16))
        keep = n if t0 + n == l else n - 1
        for o, q in zip(out, part):
            assert torch.equal(o[:, t0:t0 + keep], q[:, :keep])


@pytest.mark.parametrize("reverse", [False, True])
def test_block_pass_walks_again_where_a_prediction_was_off(monkeypatch,
                                                         reverse):
    """The block pass checks every block's predicted carry against the
    block before's last state on the grid and walks the block again where
    they differ: with the carry pass's powers spoilt (every prediction
    off) the states are still the sequential recurrence's; the float
    modes, which trust the carries, then are not."""
    lam, bu, _ = _inputs(8, 2, 300, 12, radius=(0.5, 0.999))
    honest = diag_scan.chunk_powers
    monkeypatch.setattr(diag_scan, "chunk_powers", lambda lam_, plan: tuple(
        (r * 0.99, i * 0.99) for r, i in honest(lam_, plan)))
    plan = diag_scan.scan_plan(2, 300, 12, 40, reverse, chunk=16)
    out = diag_scan.diag_scan_chunked_plain(_t(lam), _t(bu), None, reverse,
                                            GRID16, 40, plan)
    ref = tscan.sequential_diag_scan(_t(lam), _t(bu), reverse=reverse,
                                     block_requant=GRID16, block_t=40)[0]
    for o, r in zip(out, ref):
        assert torch.equal(o, r)
    out = diag_scan.diag_scan_chunked_plain(
        _t(lam), _t(bu), None, reverse,
        plan=diag_scan.scan_plan(2, 300, 12, None, reverse, chunk=16))
    ref = tscan.sequential_diag_scan(_t(lam), _t(bu), reverse=reverse)[0]
    assert max((o - r).abs().max().item() for o, r in zip(out, ref)) > 1e-3


def test_block_rewalks_counts_the_warps_that_walk_again(monkeypatch):
    """``block_rewalks``: a (B, blocks, ceil(P / 32)) map of the block pass's
    second walks; none in the first block, all past it when every
    prediction is off."""
    lam, bu, _ = _inputs(9, 2, 300, 40, radius=(0.5, 0.999))
    again = diag_scan.block_rewalks(_t(lam), _t(bu), None, True, GRID16, 64)
    plan = diag_scan.scan_plan(2, 300, 40, 64, True)
    assert again.shape == (2, plan.n_blocks, 2) and again.dtype == torch.bool
    assert not again[:, 0].any()
    honest = diag_scan.chunk_powers
    monkeypatch.setattr(diag_scan, "chunk_powers", lambda lam_, plan_: tuple(
        (r * 0.99, i * 0.99) for r, i in honest(lam_, plan_)))
    again = diag_scan.block_rewalks(_t(lam), _t(bu), None, True, GRID16, 64)
    assert again[:, 1:].all() and not again[:, 0].any()


def test_mirror_one_chunk_is_the_sequential_walk():
    """A plan of one chunk walks like the sequential recurrence, the block
    requant inside the walk: equal bit for bit."""
    lam, bu, carry = _inputs(11, 2, 125, 16)
    for rq, bt in ((None, None), (GRID16, 32)):
        plan = diag_scan.scan_plan(2, 125, 16, bt)
        assert plan.n_chunks == 1
        out = diag_scan.diag_scan_chunked_plain(_t(lam), _t(bu), _t(carry),
                                                False, rq, bt, plan)
        ref = tscan.sequential_diag_scan(_t(lam), _t(bu), _t(carry),
                                         block_requant=rq, block_t=bt)[0]
        for o, r in zip(out, ref):
            assert torch.equal(o, r)


def test_chunk_powers_are_rounded_once():
    """λ^chunk and λ^tail: float64 square and multiply, rounded to float32
    once, within an ulp or two of λ^c."""
    lam, _, _ = _inputs(2, p=16, radius=(0.9, 0.9999))
    plan = diag_scan.scan_plan(2, 300, 16, 40, chunk=16)
    assert (plan.chunk, plan.tail) == (16, 8)
    full, tail = diag_scan.chunk_powers(_t(lam), plan)
    for pw, c in ((full, 16), (tail, 8)):
        z = (lam[0].astype(np.float64) + 1j * lam[1]) ** c
        assert pw[0].dtype == torch.float32
        np.testing.assert_allclose(pw[0].numpy(), z.real, rtol=0, atol=3e-7)
        np.testing.assert_allclose(pw[1].numpy(), z.imag, rtol=0, atol=3e-7)


@pytest.mark.parametrize("s", [2.0 ** -8, 2.0 ** -9, 2.0 ** -20, 2.0 ** 3,
                               1.0])
def test_grid_multiplies_by_an_exact_reciprocal(s):
    """The kernel puts a state on a power-of-two grid by x * (1 / s) in
    place of x / s: for such s both round the same real number, so the
    codes agree for every x, subnormal results included; any other scale
    divides."""
    inv = diag_scan.exact_reciprocal(s)
    assert inv == 1.0 / s
    rng = np.random.RandomState(17)
    x = np.concatenate([
        rng.randn(20000), rng.randn(2000) * 1e-38, rng.randn(2000) * 1e30,
        [0.0, -0.0, 1e-45, -1e-45]]).astype(np.float32)
    t = torch.from_numpy(x)
    assert torch.equal(t * np.float32(inv), t / np.float32(s))
    for other in (0.003, 3.0, 2.0 ** -130, 2.0 ** 127):
        assert diag_scan.exact_reciprocal(other) == 0.0


# ----------------------------------------- mirror vs the JAX Pallas kernel

#: (batch, length, p, chunk, block_t): L below the chunk; L no multiple of
#: block_t; block_t no multiple of the chunk
PALLAS_CASES = [(2, 12, 8, 16, 8), (2, 100, 12, 16, 24),
                (3, 150, 16, 32, 40), (2, 64, 8, 8, 16)]


@pytest.mark.parametrize("mode", ["forward", "carry", "reverse"])
@pytest.mark.parametrize("case", PALLAS_CASES)
def test_mirror_matches_pallas_float(case, mode):
    b, l, p, chunk, block_t = case
    lam, bu, carry = _inputs(7 * l + p, b, l, p)
    reverse = mode == "reverse"
    c = carry if mode == "carry" else None
    ref = pallas_diag_scan(_j(lam), _j(bu), reverse=reverse,
                           carry_init=None if c is None else _j(c),
                           block_t=block_t, interpret=True)
    plan = diag_scan.scan_plan(b, l, p, None, reverse, chunk)
    out = diag_scan.diag_scan_chunked_plain(
        _t(lam), _t(bu), None if c is None else _t(c), reverse, plan=plan)
    _float_close(out, ref, f"{case} {mode}")


@pytest.mark.parametrize("mode", ["forward", "carry", "reverse"])
@pytest.mark.parametrize("case", PALLAS_CASES)
def test_mirror_matches_pallas_requant(case, mode):
    """The block requant, blocks of block_t rows (the Pallas kernel's time
    block), forward, from a carry and reverse: the state-code bar."""
    b, l, p, chunk, block_t = case
    lam, bu, carry = _inputs(5 * l + p, b, l, p)
    reverse = mode == "reverse"
    c = carry if mode == "carry" else None
    ref = pallas_diag_scan(_j(lam), _j(bu), reverse=reverse,
                           carry_init=None if c is None else _j(c),
                           block_t=block_t, interpret=True,
                           block_requant=GRID16)
    plan = diag_scan.scan_plan(b, l, p, block_t, reverse, chunk)
    out = diag_scan.diag_scan_chunked_plain(
        _t(lam), _t(bu), None if c is None else _t(c), reverse, GRID16,
        block_t, plan)
    _codes_close(out, ref, GRID16, f"{case} {mode}")


# ------------------------------------- the reverse scan's block requant

@pytest.mark.parametrize("grid", [GRID16, GRID8])
@pytest.mark.parametrize("shape", [(2, 37, 8, 8), (2, 100, 12, 32),
                                   (3, 64, 16, 16)])
def test_reverse_block_requant_matches_pallas(shape, grid):
    """``diag_scan`` (the sequential recurrence on the CPU) with
    ``reverse`` and ``block_requant`` against ``pallas_diag_scan`` with
    both: blocks from the sequence's end, the state-code bar; through
    ``diag_ssm_scan`` too, which launches nothing on the CPU."""
    b, l, p, block_t = shape
    lam, bu, _ = _inputs(3 * l + block_t, b, l, p)
    ref = pallas_diag_scan(_j(lam), _j(bu), reverse=True, block_t=block_t,
                           interpret=True, block_requant=grid)
    before = launch_counts()
    out = diag_scan.diag_scan(_t(lam), _t(bu), reverse=True,
                              block_requant=grid, block_t=block_t)
    _codes_close(out, ref, grid, f"{shape} sequential")
    with torch.no_grad():
        routed = tscan.diag_ssm_scan(_t(lam), _t(bu), reverse=True,
                                     block_requant=grid, block_t=block_t)
    for o, r in zip(routed, out):
        assert torch.equal(o, r)
    assert launch_counts() == before


@pytest.mark.parametrize("bits", [(16, 16), (8, 8)])
@pytest.mark.parametrize("shape", [(2, 100, 7, 32), (2, 45, 12, 16)])
def test_reverse_qat_block_requant_matches_pallas(shape, bits):
    """K1 qat with ``reverse`` and ``block_requant`` (``qat_scan_plain``,
    which flips the sequence: blocks from the end, the padding before
    t = 0) against ``pallas_diag_scan(reverse=True, block_requant=,
    qat_bits=)`` in interpret mode, at the bar of the forward mode's test
    (``tests/test_torch_qat_passes.py``): codes on the grid within one of
    the reference's in at most 0.5 %; ``diag_ssm_scan`` routes the mode
    to the QAT scan, which launches nothing on the CPU."""
    b, l, p, block_t = shape
    grid = QAT_GRIDS[bits[1]]
    lam, bu, _ = _inputs(9 * l + p, b, l, p, radius=(0.5, 0.97))
    ref = pallas_diag_scan(_j(lam), _j(bu), reverse=True, block_t=block_t,
                           interpret=True, block_requant=grid, qat_bits=bits)
    before = launch_counts()["qat_scan"]
    out = qat_scan.qat_scan_plain(_t(lam), _t(bu), bits, block_t,
                                  reverse=True, block_requant=grid)
    _codes_close(out, ref, grid, f"{shape} qat {bits}")
    with torch.no_grad():
        routed = tscan.diag_ssm_scan(_t(lam), _t(bu), reverse=True,
                                     block_requant=grid, block_t=block_t,
                                     qat_bits=bits)
    for o, r in zip(routed, out):
        assert torch.equal(o, r)
    assert launch_counts()["qat_scan"] == before


@pytest.mark.parametrize("qat_bits", [None, (8, 8)])
def test_reverse_block_requant_has_no_gradient(qat_bits):
    """Both ``diag_ssm_scan`` forms with a requant refuse gradients, in
    either direction, as the forward requant does."""
    lam, bu, _ = _inputs(4)
    for reverse in (False, True):
        with pytest.raises(NotImplementedError, match="no gradient"):
            tscan.diag_ssm_scan(
                _t(lam), (_t(bu)[0].requires_grad_(), _t(bu)[1]),
                reverse=reverse, block_requant=GRID8, block_t=8,
                qat_bits=qat_bits)
