"""K1's launch options for the bidirectional mixer's buffers
(``ops/cuda/diag_scan.py``: ``out``, and the adjoint entry
``diag_scan_adjoint_cuda`` with its dλ and ``accumulate``) and
``ops/scan.py`` ``BiDiagScanFn`` on the card, at small shapes and at
Path-X's (B 32, L 16 384, P 128). The states written into the columns of a
(B, L, 4P) matrix, and the adjoint's written into a (B, L, 2P) buffer or
added to what it holds, are ``diag_scan_chunked_plain``'s bit for bit; the
dλ partials, once reduced, are within float32 round-off of ``_dlam`` in
float64; with the options off every mode gives what it gave.
``DiagScanFn``'s backward, one call of the adjoint entry: bu's gradient
``diag_scan_chunked_plain``'s walk the other way bit for bit, dλ within
round-off. ``BiDiagScanFn`` against the two ``DiagScanFn`` and the
concatenations: the matrix and bu's gradient bit for bit, dλ within
round-off.

The tests need the card and skip without one. This file imports no JAX:
on the card, from the repository's root,
``python -m pytest tests/test_torch_bidir_scan_card.py -q -m card
--noconftest``."""

import pytest
import torch

from sparsernns_tpu_torch.ops import scan as tscan
from sparsernns_tpu_torch.ops.cuda import diag_scan
from sparsernns_tpu_torch.utils.trace import launch_counts

#: (B, L, P): several chunks; an odd width (one channel a thread); one
#: chunk (L <= 256, the output pass alone); Path-X's scan
SHAPES = [(3, 1000, 128), (2, 700, 10), (2, 200, 128), (32, 16384, 128)]
IDS = ["b3_l1000", "p10", "one_chunk", "pathx"]


@pytest.fixture
def card():
    """Skips where no CUDA card is present; decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run on the chip")
    return torch.device("cuda", 0)


def _inputs(b, l, p, dev, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    radius = 0.9 + 0.099 * torch.rand(p, generator=g)
    angle = (torch.rand(p, generator=g) - 0.5) * 6.0
    lam = ((radius * torch.cos(angle)).to(dev),
           (radius * torch.sin(angle)).to(dev))
    cat = torch.randn((b, l, 2 * p), generator=g).to(dev)
    return lam, cat


def _columns(buf, k, p):
    return buf[..., k * p:(k + 1) * p], buf[..., (k + 2) * p:(k + 3) * p]


def _dlam64(v, xs, reverse):
    """(dλ in float64, the sum of its terms' magnitudes), (2, P) each."""
    v64 = tuple(t.double() for t in v)
    x64 = tuple(t.double() for t in xs)
    va = tuple(t.abs() for t in v64)
    d = torch.stack(tscan._dlam(v64, x64, reverse))
    mag = torch.stack([
        tscan._dlam(va, tuple(t.abs() for t in x64), reverse)[0],
        tscan._dlam(va, (x64[0].abs(), -x64[1].abs()), reverse)[1]])
    return d, mag


@pytest.mark.card
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_k1_options_against_the_plain_mirror(card, shape):
    b, l, p = shape
    lam, cat = _inputs(b, l, p, card, seed=l + p)
    bu = (cat[..., :p], cat[..., p:])
    buf = torch.full((b, l, 4 * p), float("nan"), device=card)
    fresh = torch.full((b, l, 2 * p), float("nan"), device=card)
    acc = torch.randn((b, l, 2 * p), device=card)
    worst = 0.0
    for k, reverse in enumerate((False, True)):
        want = diag_scan.diag_scan_chunked_plain(lam, bu, reverse=reverse)
        # the options off: fresh contiguous states, as before
        plain = diag_scan.diag_scan_cuda(lam, bu, reverse=reverse)
        assert all(torch.equal(a, w) for a, w in zip(plain, want))
        # strided output: the direction's column blocks of the 4P matrix
        cols = _columns(buf, k, p)
        got = diag_scan.diag_scan_cuda(lam, bu, reverse=reverse, out=cols)
        assert got[0].data_ptr() == cols[0].data_ptr()
        assert all(torch.equal(a, w) for a, w in zip(cols, want))
        # the adjoint (the other direction, conj λ) over bu as cotangent,
        # with dλ against the 4P matrix's columns: fresh, into a 2P
        # buffer, and added to what a 2P buffer held
        v_want = diag_scan.diag_scan_chunked_plain(
            (lam[0], -lam[1]), bu, reverse=not reverse)
        v, parts = diag_scan.diag_scan_adjoint_cuda(lam, bu, cols, reverse)
        plan = diag_scan.scan_plan(b, l, p, None, not reverse)
        assert parts.shape == (b, plan.n_chunks, 2, p)
        assert all(torch.equal(a, w) for a, w in zip(v, v_want))
        got = torch.stack(diag_scan.reduce_dlam(parts)).double()
        ref, mag = _dlam64(v, cols, reverse)
        ratio = float(((got - ref).abs() / mag).max())
        worst = max(worst, ratio)
        assert ratio <= 1e-5, ratio
        out = (fresh[..., :p], fresh[..., p:])
        _, again = diag_scan.diag_scan_adjoint_cuda(lam, bu, cols, reverse,
                                                    out=out)
        assert torch.equal(fresh, torch.cat(v_want, dim=-1))
        assert torch.equal(again, parts)
        acc0 = acc.clone()
        out = (acc[..., :p], acc[..., p:])
        _, again = diag_scan.diag_scan_adjoint_cuda(lam, bu, cols, reverse,
                                                    out=out, accumulate=True)
        assert torch.equal(acc, acc0 + torch.cat(v_want, dim=-1))
        assert torch.equal(again, parts)
    assert not torch.isnan(buf).any()
    # accumulate is built only with dλ: the launcher refuses it alone
    with pytest.raises(RuntimeError, match="CUDA error"):
        diag_scan._launch(lam, bu, None, False, None, None,
                          (acc[..., :p], acc[..., p:]), True)
    print(f"k1 options {shape}: dλ gap / Σ|terms| at most {worst:.3g}")


@pytest.mark.card
@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_diag_scan_fn_backward_is_the_adjoint_entry(card, shape, reverse):
    """``DiagScanFn``'s gradient: one K1 call walking the other way (the
    adjoint entry), whose v, bu's gradient, is ``diag_scan_chunked_plain``'s
    walk with conj(λ) bit for bit, and whose dλ is within float32 round-off
    of ``_dlam`` in float64 (1e-5 of its terms' magnitudes summed)."""
    b, l, p = shape
    lam, cat = _inputs(b, l, p, card, seed=5 * l + p + reverse)
    g = torch.randn((b, l, 2 * p), device=card)
    g = (g[..., :p], g[..., p:])
    leaves = [t.clone().requires_grad_(True)
              for t in (*lam, cat[..., :p], cat[..., p:])]
    xs = tscan.DiagScanFn.apply(*leaves, reverse)
    before = launch_counts()
    torch.autograd.backward(xs, g)
    walk = "diag_scan" if reverse else "diag_scan_rev"
    moved = launch_counts() - before
    assert moved[walk] == 1 and moved["diag_scan"] + moved[
        "diag_scan_rev"] + moved["diag_scan_requant"] == 1, moved
    v = diag_scan.diag_scan_chunked_plain((lam[0], -lam[1]), g,
                                          reverse=not reverse)
    assert torch.equal(leaves[2].grad, v[0])
    assert torch.equal(leaves[3].grad, v[1])
    ref, mag = _dlam64(v, tuple(x.detach() for x in xs), reverse)
    got = torch.stack([leaves[0].grad, leaves[1].grad]).double()
    ratio = float(((got - ref).abs() / mag).max())
    assert ratio <= 1e-5, ratio


@pytest.mark.card
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_buffers_function_against_the_unfused_composition(card, shape):
    b, l, p = shape
    lam, cat = _inputs(b, l, p, card, seed=3 * l + p)
    cot = torch.randn((b, l, 4 * p), device=card)

    def unfused(lr, li, bu_cat):
        bu = (bu_cat[..., :p], bu_cat[..., p:])
        fwd = tscan.DiagScanFn.apply(lr, li, *bu, False)
        rev = tscan.DiagScanFn.apply(lr, li, *bu, True)
        xs = (torch.cat([fwd[0], rev[0]], dim=-1),
              torch.cat([fwd[1], rev[1]], dim=-1))
        return torch.cat([xs[0], xs[1]], dim=-1)

    res = []
    for fn in (unfused, tscan.BiDiagScanFn.apply):
        leaves = [lam[0].clone().requires_grad_(True),
                  lam[1].clone().requires_grad_(True),
                  cat.clone().requires_grad_(True)]
        out = fn(*leaves)
        out.backward(cot)
        res.append((out.detach(), [t.grad for t in leaves]))
    (want, (w_re, w_im, w_bu)), (got, (g_re, g_im, g_bu)) = res
    assert torch.equal(got, want)
    assert torch.equal(g_bu, w_bu)
    # dλ: both in float32, each within round-off of the float64 sum
    ref = torch.zeros(2, p, dtype=torch.float64, device=card)
    mag = torch.zeros_like(ref)
    for k, reverse in enumerate((False, True)):
        v = diag_scan.diag_scan_cuda((lam[0], -lam[1]), _columns(cot, k, p),
                                     reverse=not reverse)
        d, m = _dlam64(v, _columns(want, k, p), reverse)
        ref += d
        mag += m
    for got_d in (torch.stack([g_re, g_im]), torch.stack([w_re, w_im])):
        ratio = float(((got_d.double() - ref).abs() / mag).max())
        assert ratio <= 1e-5, ratio
