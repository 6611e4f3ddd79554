"""The port's reverse scan and the gradients of both scan directions
(``ops/scan.py`` ``diag_ssm_scan`` / ``DiagScanFn``, on the plain version of
kernel K1) against the JAX package's Pallas scan and its custom VJPs, run in
interpret mode on the CPU, and against autograd through the plain sequential
loop. Inputs are made from a numpy seed and handed to both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsernns_tpu.ops.pallas.scan_kernel import pallas_diag_scan
from sparsernns_tpu.ops.pallas.scan_vjp import (pallas_diag_scan_diff,
                                                pallas_diag_scan_diff_rev)
from sparsernns_tpu_torch.ops import scan as tscan
from sparsernns_tpu_torch.ops.cuda import diag_scan
from sparsernns_tpu_torch.utils.trace import launch_counts


def _inputs(seed, b=2, l=37, p=8):
    rng = np.random.RandomState(seed)
    r = rng.uniform(0.5, 0.99, p)
    th = rng.uniform(-np.pi, np.pi, p)
    lam = ((r * np.cos(th)).astype(np.float32),
           (r * np.sin(th)).astype(np.float32))
    bu = (rng.randn(b, l, p).astype(np.float32),
          rng.randn(b, l, p).astype(np.float32))
    g = (rng.randn(b, l, p).astype(np.float32),
         rng.randn(b, l, p).astype(np.float32))
    return lam, bu, g


def _t(pair, grad=False):
    return tuple(torch.from_numpy(a.copy()).requires_grad_(grad)
                 for a in pair)


def _j(pair):
    return tuple(jnp.asarray(a) for a in pair)


@pytest.mark.parametrize("block_t,l,p", [(8, 37, 8), (16, 33, 12),
                                         (32, 70, 5)])
def test_reverse_scan_matches_pallas(block_t, l, p):
    """x_t = λ x_{t+1} + bu_t. 1e-5·max|x|: the Pallas kernel reassociates
    the sum (doubling), the plain version is sequential."""
    lam, bu, _ = _inputs(block_t + l, l=l, p=p)
    ref = pallas_diag_scan(_j(lam), _j(bu), reverse=True, block_t=block_t)
    out = tscan.diag_ssm_scan(_t(lam), _t(bu), reverse=True)
    plain = diag_scan.diag_scan_plain(_t(lam), _t(bu), reverse=True)
    scale = max(np.abs(np.asarray(r)).max() for r in ref)
    for o, pl, r in zip(out, plain, ref):
        assert np.abs(o.numpy() - np.asarray(r)).max() <= 1e-5 * scale
        assert torch.equal(o, pl)


def test_reverse_scan_is_the_flipped_forward_scan():
    lam, bu, _ = _inputs(1, l=40)
    lam, bu = _t(lam), _t(bu)
    rev, last = tscan.sequential_diag_scan(lam, bu, reverse=True)
    fwd, _ = tscan.sequential_diag_scan(lam, tuple(a.flip(1) for a in bu))
    for r, f, end in zip(rev, fwd, last):
        assert torch.equal(r, f.flip(1))
        assert torch.equal(end, r[:, 0])


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("block_t,l,p", [(8, 37, 8), (32, 70, 12)])
def test_scan_gradients_match_jax_vjp(reverse, block_t, l, p):
    """dλ and dbu of both directions against ``jax.vjp`` of the JAX
    package's differentiable Pallas scans: rtol = atol 2e-4."""
    lam, bu, g = _inputs(7 + block_t + int(reverse), l=l, p=p)
    fn = pallas_diag_scan_diff_rev if reverse else pallas_diag_scan_diff
    ref_out, vjp = jax.vjp(lambda la, x: fn(la, x, None, block_t),
                           _j(lam), _j(bu))
    ref_dlam, ref_dbu = vjp(_j(g))
    t_lam, t_bu = _t(lam, True), _t(bu, True)
    out = tscan.diag_ssm_scan(t_lam, t_bu, reverse=reverse)
    torch.autograd.backward(out, _t(g))
    for o, r in zip(out, ref_out):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(r),
                                   rtol=2e-4, atol=2e-4)
    for ours, theirs in ((t_lam, ref_dlam), (t_bu, ref_dbu)):
        for o, r in zip(ours, theirs):
            np.testing.assert_allclose(o.grad.numpy(), np.asarray(r),
                                       rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("reverse", [False, True])
def test_scan_gradients_match_autograd_through_the_plain_loop(reverse):
    """The explicit adjoint (the other direction with conj λ) against
    autograd through the sequential loop: 1e-5·max(1, |ref|)."""
    lam, bu, g = _inputs(11 + int(reverse), b=3, l=45, p=6)
    a_lam, a_bu = _t(lam, True), _t(bu, True)
    ref, _ = tscan.sequential_diag_scan(a_lam, a_bu, reverse=reverse)
    torch.autograd.backward(ref, _t(g))
    t_lam, t_bu = _t(lam, True), _t(bu, True)
    out = tscan.diag_ssm_scan(t_lam, t_bu, reverse=reverse)
    torch.autograd.backward(out, _t(g))
    for ours, theirs in zip((*t_lam, *t_bu), (*a_lam, *a_bu)):
        limit = 1e-5 * max(1.0, theirs.grad.abs().max().item())
        assert (ours.grad - theirs.grad).abs().max().item() <= limit


def test_scan_gradient_takes_strided_and_partial_cotangents():
    """Cotangents that are halves of one (B, L, 2P) tensor go to the kernel
    wrapper as they are; unequal strides are made contiguous; an unused
    output gets a zero cotangent."""
    lam, bu, g = _inputs(13, l=20)
    t_lam, t_bu = _t(lam, True), _t(bu, True)
    out = tscan.diag_ssm_scan(t_lam, t_bu)
    loss = (torch.cat(out, dim=-1) * torch.cat(_t(g), dim=-1)).sum()
    loss.backward()
    ref = [a.grad.clone() for a in (*t_lam, *t_bu)]
    for a in (*t_lam, *t_bu):
        a.grad = None
    out = tscan.diag_ssm_scan(t_lam, t_bu)
    torch.autograd.backward(out, _t(g))
    for a, r in zip((*t_lam, *t_bu), ref):
        torch.testing.assert_close(a.grad, r, rtol=1e-6, atol=1e-6)
    # only the real half is used
    for a in (*t_lam, *t_bu):
        a.grad = None
    tscan.diag_ssm_scan(t_lam, t_bu)[0].sum().backward()
    assert all(torch.isfinite(a.grad).all() for a in (*t_lam, *t_bu))
    a, b = tscan._kernel_operand((torch.zeros(2, 5, 8)[..., :4],
                                  torch.zeros(2, 5, 4)))
    assert a.is_contiguous() and b.is_contiguous()


def test_reverse_with_carry_raises():
    lam, bu, _ = _inputs(14)
    carry = (torch.zeros(2, 8), torch.zeros(2, 8))
    with pytest.raises(NotImplementedError, match="reverse"):
        tscan.diag_ssm_scan(_t(lam), _t(bu), reverse=True, carry_init=carry)
    with pytest.raises(NotImplementedError, match="reverse"):
        diag_scan.diag_scan(_t(lam), _t(bu), carry, reverse=True)
    with pytest.raises(NotImplementedError, match="reverse"):
        diag_scan.diag_scan_cuda(_t(lam), _t(bu), carry, reverse=True)


def test_carried_scan_with_requires_grad_raises():
    """With a carry the scan has no gradient in the JAX package either: the
    port raises instead of guessing one; under no_grad the call goes
    through."""
    lam, bu, _ = _inputs(15)
    carry = (torch.zeros(2, 8), torch.zeros(2, 8))
    with pytest.raises(NotImplementedError, match="no gradient"):
        tscan.diag_ssm_scan(_t(lam, True), _t(bu), carry_init=carry)
    with pytest.raises(NotImplementedError, match="no gradient"):
        tscan.diag_ssm_scan(_t(lam), _t(bu, True), carry_init=carry)
    with torch.no_grad():
        out = tscan.diag_ssm_scan(_t(lam, True), _t(bu), carry_init=carry)
    ref = tscan.sequential_diag_scan(_t(lam), _t(bu), carry_init=carry)[0]
    for o, r in zip(out, ref):
        assert torch.equal(o, r) and not o.requires_grad


def test_cpu_tensors_launch_nothing():
    lam, bu, g = _inputs(16)
    before = launch_counts()
    t_lam, t_bu = _t(lam, True), _t(bu, True)
    for reverse in (False, True):
        out = tscan.diag_ssm_scan(t_lam, t_bu, reverse=reverse)
        torch.autograd.backward(out, _t(g))
    assert launch_counts() == before
