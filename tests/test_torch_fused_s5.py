"""The port's S5 mixer (kernel K4a's plain version ``fused_s5_plain`` and
its gradient ``FusedS5Fn``) against the JAX package's fused mixer kernel
``fused_s5_apply`` and its custom VJP ``fused_s5_apply_diff``, run in
interpret mode on the CPU, and against plain autograd through the composed
mixer. Inputs are made from a numpy seed and handed to both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsernns_tpu.ops.pallas.fused_s5 import fused_s5_apply
from sparsernns_tpu.ops.pallas.fused_vjp import fused_s5_apply_diff
from sparsernns_tpu_torch.ops import scan as tscan
from sparsernns_tpu_torch.ops.cuda import fused_s5
from sparsernns_tpu_torch.utils.trace import launch_counts

NAMES = ("u", "lam_re", "lam_im", "w_b", "w_c", "d")


def _inputs(seed, b=2, l=37, h=16, p=8):
    rng = np.random.RandomState(seed)
    r = rng.uniform(0.5, 0.97, p)
    th = rng.uniform(-np.pi, np.pi, p)
    f32 = lambda a: np.asarray(a, dtype=np.float32)  # noqa: E731
    return dict(u=f32(rng.randn(b, l, h)), lam_re=f32(r * np.cos(th)),
                lam_im=f32(r * np.sin(th)),
                w_b=f32(rng.randn(h, 2 * p) * 0.3),
                w_c=f32(rng.randn(2 * p, h) * 0.3), d=f32(rng.randn(h)),
                g=f32(rng.randn(b, l, h)))


def _torch_ops(inp, grad=False):
    return [torch.from_numpy(inp[k].copy()).requires_grad_(grad)
            for k in NAMES]


def _port(ops, relu_state):
    u, lam_re, lam_im, w_b, w_c, d = ops
    return fused_s5.fused_s5(u, (lam_re, lam_im), w_b, w_c, d, relu_state)


@pytest.mark.parametrize("relu_state", [False, True])
@pytest.mark.parametrize("l,h,p,block_t", [(37, 16, 8, 8), (70, 20, 12, 32),
                                           (64, 24, 10, 32)])
def test_fused_s5_plain_matches_pallas(relu_state, l, h, p, block_t):
    """Odd widths, L not a multiple of the tile: 1e-4·max(1, |ref|)."""
    inp = _inputs(l + h, l=l, h=h, p=p)
    j = {k: jnp.asarray(v) for k, v in inp.items()}
    ref = np.asarray(fused_s5_apply(
        j["u"], (j["lam_re"], j["lam_im"]), j["w_b"], j["w_c"], j["d"],
        block_t=block_t, relu_state=relu_state))
    before = launch_counts()["fused_s5"]
    out = _port(_torch_ops(inp), relu_state).numpy()
    # plain version on the CPU
    assert launch_counts()["fused_s5"] == before
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= 1e-4 * max(1.0, np.abs(ref).max())


def _port_grads(inp, relu_state):
    ops = _torch_ops(inp, grad=True)
    out = fused_s5.FusedS5Fn.apply(*ops, relu_state)
    out.backward(torch.from_numpy(inp["g"]))
    return out.detach(), [t.grad for t in ops]


@pytest.mark.parametrize("relu_state", [False, True])
@pytest.mark.parametrize("l,h,p,block_t", [(37, 16, 8, 8), (70, 20, 12, 32)])
def test_fused_s5_gradients_match_jax_vjp(relu_state, l, h, p, block_t):
    """u, λ, W_b, W_c, D against ``jax.vjp`` of ``fused_s5_apply_diff``:
    2e-4 of max(1, max|ref|) per gradient."""
    inp = _inputs(3 + l + int(relu_state), l=l, h=h, p=p)
    j = {k: jnp.asarray(v) for k, v in inp.items()}

    def fn(u, lam_re, lam_im, w_b, w_c, d):
        return fused_s5_apply_diff(u, (lam_re, lam_im), w_b, w_c, d, None,
                                   block_t, relu_state)

    ref_out, vjp = jax.vjp(fn, *(j[k] for k in NAMES))
    refs = vjp(j["g"])
    out, grads = _port_grads(inp, relu_state)
    assert np.abs(out.numpy() - np.asarray(ref_out)).max() <= 1e-4 * max(
        1.0, np.abs(np.asarray(ref_out)).max())
    for name, ours, ref in zip(NAMES, grads, refs):
        ref = np.asarray(ref)
        err = np.abs(ours.numpy() - ref).max()
        assert err <= 2e-4 * max(1.0, np.abs(ref).max()), (name, err)


@pytest.mark.parametrize("relu_state", [False, True])
def test_fused_s5_gradients_match_plain_autograd(relu_state):
    """The explicit adjoint against autograd through the composed mixer
    (matmul, sequential loop, relu, matmul): 2e-4 of max(1, max|ref|)."""
    inp = _inputs(21 + int(relu_state), b=3, l=45, h=12, p=6)
    ops = _torch_ops(inp, grad=True)
    fused_s5.fused_s5_plain(ops[0], (ops[1], ops[2]), *ops[3:],
                            relu_state).backward(torch.from_numpy(inp["g"]))
    _, grads = _port_grads(inp, relu_state)
    for name, ours, op in zip(NAMES, grads, ops):
        err = (ours - op.grad).abs().max().item()
        limit = 2e-4 * max(1.0, op.grad.abs().max().item())
        assert err <= limit, (name, err)


def test_fused_s5_fn_saves_inputs_only_and_launches_nothing_on_cpu():
    inp = _inputs(30)
    ops = _torch_ops(inp, grad=True)
    before = launch_counts()
    out = fused_s5.FusedS5Fn.apply(*ops, True)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == len(ops)
    assert all(s.data_ptr() == o.data_ptr() for s, o in zip(saved, ops))
    out.sum().backward()
    assert launch_counts() == before
    # the mixer equals B-projection, stand-alone scan, C-projection
    u, lam_re, lam_im, w_b, w_c, d = (t.detach() for t in ops)
    bu = u @ w_b
    xs = tscan.diag_ssm_scan((lam_re, lam_im), (bu[..., :8], bu[..., 8:]))
    ref = torch.cat([torch.relu(x) for x in xs], dim=-1) @ w_c + d * u
    torch.testing.assert_close(out.detach(), ref, rtol=1e-6, atol=1e-6)


def test_fused_s5_cuda_rejects_bad_operands():
    inp = _inputs(31)
    u, lam_re, lam_im, w_b, w_c, d = _torch_ops(inp)
    with pytest.raises(ValueError, match="w_c"):
        fused_s5.fused_s5_cuda(u, (lam_re, lam_im), w_b, w_c[:-1], d)
    with pytest.raises(ValueError, match="float32"):
        fused_s5.fused_s5_cuda(u.double(), (lam_re, lam_im), w_b, w_c, d)
    with pytest.raises(ValueError, match="B, L, H"):
        fused_s5.fused_s5_cuda(u[0], (lam_re, lam_im), w_b, w_c, d)
    with pytest.raises(ValueError, match="shared memory"):
        fused_s5.fused_s5_cuda(
            torch.zeros(1, 4, 2048), (torch.zeros(8), torch.zeros(8)),
            torch.zeros(2048, 16), torch.zeros(16, 2048), torch.zeros(2048))
