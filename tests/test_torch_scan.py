"""The port's diagonal scan (kernel K1's plain version and the scan
dispatch) against the JAX package's Pallas scan, run in interpret mode on
the CPU. Inputs are made from a numpy seed and handed to both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsernns_tpu.ops.pallas.scan_kernel import pallas_diag_scan
from sparsernns_tpu.ops.scan import lambda_powers as jax_lambda_powers
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
    carry = (rng.randn(b, p).astype(np.float32),
             rng.randn(b, p).astype(np.float32))
    return lam, bu, carry


def _t(pair):
    return tuple(torch.from_numpy(a) for a in pair)


@pytest.mark.parametrize("with_carry", [False, True])
@pytest.mark.parametrize("block_t,l", [(8, 37), (16, 33)])
def test_diag_scan_plain_matches_pallas(with_carry, block_t, l):
    lam, bu, carry = _inputs(block_t + l, l=l)
    ref = pallas_diag_scan(
        tuple(jnp.asarray(a) for a in lam), tuple(jnp.asarray(a) for a in bu),
        carry_init=tuple(jnp.asarray(a) for a in carry) if with_carry
        else None, block_t=block_t)
    out = diag_scan.diag_scan_plain(_t(lam), _t(bu),
                                    _t(carry) if with_carry else None)
    scale = max(np.abs(np.asarray(r)).max() for r in ref)
    # the Pallas kernel reassociates the sum (doubling); the plain
    # version is sequential: f32 rounding differs at ~1e-7 relative
    for o, r in zip(out, ref):
        assert np.abs(o.numpy() - np.asarray(r)).max() <= 1e-5 * scale


def test_diag_scan_dispatch_on_cpu_takes_plain_version():
    lam, bu, carry = _inputs(3)
    before = launch_counts()["diag_scan"]
    for carry_init in (None, _t(carry)):
        out = tscan.diag_ssm_scan(_t(lam), _t(bu), carry_init=carry_init)
        ref = tscan.sequential_diag_scan(_t(lam), _t(bu),
                                         carry_init=carry_init)[0]
        for o, r in zip(out, ref):
            torch.testing.assert_close(o, r, rtol=0, atol=0)
    # CPU tensors launch nothing
    assert launch_counts()["diag_scan"] == before


def test_carry_splits_the_sequence():
    """Scanning two halves with the first half's final state as carry
    equals one scan over the whole sequence (the streaming contract)."""
    lam, bu, _ = _inputs(4, l=40)
    lam, bu = _t(lam), _t(bu)
    whole, _ = tscan.sequential_diag_scan(lam, bu)
    first, last = tscan.sequential_diag_scan(
        lam, (bu[0][:, :17], bu[1][:, :17]))
    second = diag_scan.diag_scan(lam, (bu[0][:, 17:], bu[1][:, 17:]),
                                 carry_init=last)
    for w, a, b in zip(whole, first, second):
        torch.testing.assert_close(torch.cat([a, b], dim=1), w,
                                   rtol=1e-6, atol=1e-6)


def test_lambda_powers_and_complex_mul_match_jax():
    lam, _, _ = _inputs(5)
    ref = jax_lambda_powers(tuple(jnp.asarray(a) for a in lam), 12)
    out = tscan.lambda_powers(_t(lam), 12)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-6)
    a, b = _t(lam), tuple(x.flip(0) for x in _t(lam))
    re, im = tscan.complex_mul(a, b)
    z = torch.complex(a[0], a[1]) * torch.complex(b[0], b[1])
    torch.testing.assert_close(re, z.real)
    torch.testing.assert_close(im, z.imag)


def test_diag_scan_cuda_rejects_bad_operands():
    lam, bu, carry = _inputs(6)
    with pytest.raises(ValueError):
        diag_scan.diag_scan_cuda(_t(lam), (torch.zeros(2, 3, 8),
                                           torch.zeros(2, 4, 8)))
    with pytest.raises(ValueError):   # float32 on the bu device only
        diag_scan.diag_scan_cuda(
            _t(lam), tuple(x.double() for x in _t(bu)), _t(carry))
