"""The training forward (K2 with dropout masks) and the backward (K3a carry
history, K3b reverse-time adjoint) of the whole-layer tail: the port's plain
versions against the JAX package's Pallas kernels (interpret mode on the
CPU, explicit ``block_t``), against its XLA rematerializing backward, and
against ``torch.autograd``. Inputs and masks are made with numpy from a
seed and handed to both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsernns_tpu.ops.pallas.fused_layer_train import (
    fused_layer_tail, fused_layer_tail_diff)
from sparsernns_tpu_torch.ops.cuda import layer_tail as lt
from sparsernns_tpu_torch.ops.cuda import layer_tail_bwd as lb
from sparsernns_tpu_torch.ops.scan import sequential_diag_scan
from sparsernns_tpu_torch.utils.trace import launch_counts

B, L, H, P = 2, 37, 16, 8
BLOCK_T = 16
ACT_SETS = [("gelu", False, False), ("relu", True, True)]
NAMES = ("x", "lam_re", "lam_im", "w_b", "w_c", "d", "nw", "nb", "o2k",
         "o2b", "o1k", "o1b", "m1", "m2")


def _operands(seed, glu):
    """name -> numpy array (None where the GLU variant has no such
    operand), plus the output cotangent ``g``."""
    rng = np.random.RandomState(seed)
    f = lambda *s, sc=1.0: (rng.randn(*s) * sc).astype(np.float32)  # noqa
    r = rng.uniform(0.6, 0.99, P)
    th = rng.uniform(-np.pi, np.pi, P)
    mask = lambda: (rng.binomial(1, 0.8, (B, 1, H)) / 0.8  # noqa: E731
                    ).astype(np.float32)
    ops = dict(
        x=f(B, L, H), lam_re=(r * np.cos(th)).astype(np.float32),
        lam_im=(r * np.sin(th)).astype(np.float32),
        w_b=f(H, 2 * P, sc=0.3), w_c=f(2 * P, H, sc=0.3), d=f(H),
        nw=(1.0 + 0.2 * rng.randn(H)).astype(np.float32), nb=f(H, sc=0.1),
        o2k=f(H, H, sc=0.3), o2b=f(H, sc=0.1), o1k=f(H, H, sc=0.3),
        o1b=f(H, sc=0.1), m1=mask(), m2=mask())
    if glu == "none":
        ops.update(o2k=None, o2b=None, m2=None)
    if glu != "full":
        ops.update(o1k=None, o1b=None)
    return ops, f(B, L, H)


def _torch_ops(ops, requires_grad=False):
    return {k: None if v is None else
            torch.from_numpy(v).requires_grad_(requires_grad)
            for k, v in ops.items()}


def _plain_forward(t, act, glu, relu_state, layer_relu):
    return lt.layer_tail_plain(
        t["x"], (t["lam_re"], t["lam_im"]), t["w_b"], t["w_c"], t["d"],
        t["nw"], t["nb"], t["o2k"], t["o2b"], t["o1k"], t["o1b"], act=act,
        glu=glu, relu_state=relu_state, layer_relu=layer_relu, m1=t["m1"],
        m2=t["m2"])


def _jax_forward(j, act, glu, relu_state, layer_relu, diff=False):
    if diff:
        return fused_layer_tail_diff(
            j["x"], None, (j["lam_re"], j["lam_im"]), j["w_b"], j["w_c"],
            j["d"], j["o2k"], j["o2b"], j["o1k"], j["o1b"], j["m1"], j["m2"],
            j["nw"], j["nb"], BLOCK_T, act, glu, relu_state, layer_relu)
    return fused_layer_tail(
        j["x"], None, (j["lam_re"], j["lam_im"]), j["w_b"], j["w_c"], j["d"],
        j["o2k"], j["o2b"], j["o1k"], j["o1b"], j["m1"], j["m2"], j["nw"],
        j["nb"], block_t=BLOCK_T, act=act, glu=glu, relu_state=relu_state,
        layer_relu=layer_relu)


@pytest.mark.parametrize("act,relu_state,layer_relu", ACT_SETS)
@pytest.mark.parametrize("glu", ["full", "half1", "half2", "none"])
def test_masked_forward_matches_pallas(glu, act, relu_state, layer_relu):
    """K2's plain version with dropout masks vs the Pallas training
    forward. 1e-5: f32 products summed in another order, values O(10)."""
    ops, _ = _operands(11, glu)
    j = {k: None if v is None else jnp.asarray(v) for k, v in ops.items()}
    ref = np.asarray(_jax_forward(j, act, glu, relu_state, layer_relu))
    out = _plain_forward(_torch_ops(ops), act, glu, relu_state, layer_relu)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)
    # the masks do something: without them the output differs
    bare = dict(_torch_ops(ops), m1=None, m2=None)
    assert not torch.allclose(
        out, _plain_forward(bare, act, glu, relu_state, layer_relu))


def _fn_grads(ops, g, act, glu, relu_state, layer_relu):
    """Gradients of sum(out * g) through LayerTailFn, by operand name."""
    t = _torch_ops(ops, requires_grad=True)
    before = launch_counts()
    out = lt.LayerTailFn.apply(*(t[n] for n in NAMES), act, glu, relu_state,
                               layer_relu)
    live = [n for n in NAMES if t[n] is not None]
    grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(),
                                [t[n] for n in live])
    # CPU tensors launch no kernel
    assert launch_counts() == before
    return {n: v.numpy() for n, v in zip(live, grads)}


@pytest.mark.parametrize("act,relu_state,layer_relu", ACT_SETS)
@pytest.mark.parametrize("glu", ["full", "half1", "half2", "none"])
def test_fn_gradients_match_both_jax_backwards(glu, act, relu_state,
                                               layer_relu, monkeypatch):
    """LayerTailFn's gradient of every input (x, λ, weights, masks, nw, nb)
    vs ``jax.grad`` through ``fused_layer_tail_diff``: its Pallas adjoint
    kernel and, with SPARSERNNS_XLA_TAIL_BWD=1, its XLA rematerializing
    backward. rtol = atol = 2e-4, the JAX package's own bar between those
    two (sums over blocks of 16 rows vs over the whole sequence)."""
    ops, g = _operands(12, glu)
    live = [n for n in NAMES if ops[n] is not None]
    j = {n: jnp.asarray(ops[n]) for n in live}
    gj = jnp.asarray(g)

    def loss(*args):
        full = dict.fromkeys(NAMES)
        full.update(zip(live, args))
        return jnp.sum(_jax_forward(full, act, glu, relu_state, layer_relu,
                                    diff=True) * gj)

    grad_fn = jax.grad(loss, argnums=tuple(range(len(live))))
    out = _fn_grads(ops, g, act, glu, relu_state, layer_relu)
    for route, env in (("pallas adjoint", "0"), ("xla remat", "1")):
        monkeypatch.setenv("SPARSERNNS_XLA_TAIL_BWD", env)
        ref = grad_fn(*(j[n] for n in live))
        for n, r in zip(live, ref):
            np.testing.assert_allclose(
                out[n], np.asarray(r), rtol=2e-4, atol=2e-4,
                err_msg=f"{n} vs {route}")


@pytest.mark.parametrize("act,relu_state,layer_relu", ACT_SETS)
@pytest.mark.parametrize("glu", ["full", "half1", "half2", "none"])
def test_plain_adjoint_matches_autograd(glu, act, relu_state, layer_relu):
    """The explicit adjoint (K3b's plain version) vs torch.autograd through
    K2's plain version. 1e-5 relative to max(1, |ref|): the same f32
    arithmetic in another association."""
    ops, g = _operands(13, glu)
    out = _fn_grads(ops, g, act, glu, relu_state, layer_relu)
    t = _torch_ops(ops, requires_grad=True)
    live = [n for n in NAMES if t[n] is not None]
    y = _plain_forward(t, act, glu, relu_state, layer_relu)
    ref = torch.autograd.grad((y * torch.from_numpy(g)).sum(),
                              [t[n] for n in live])
    for n, r in zip(live, ref):
        r = r.numpy()
        np.testing.assert_allclose(out[n], r, rtol=0, err_msg=n,
                                   atol=1e-5 * max(1.0, np.abs(r).max()))


def test_gelu_derivative_is_of_the_tanh_form():
    y = torch.linspace(-4, 4, 101, dtype=torch.float64, requires_grad=True)
    x1, dact = lb._act_and_grad(y, "gelu")
    ref, = torch.autograd.grad(
        torch.nn.functional.gelu(y, approximate="tanh").sum(), y)
    np.testing.assert_allclose(dact.detach().numpy(), ref.numpy(), atol=1e-12)
    np.testing.assert_allclose(
        x1.detach().numpy(),
        torch.nn.functional.gelu(y, approximate="tanh").detach().numpy(),
        atol=1e-12)


@pytest.mark.parametrize("length,block", [(37, 16), (64, 32), (20, 32)])
def test_plain_history_is_the_state_entering_each_block(length, block):
    """K3a's plain version vs a direct scan: row k is the state after step
    k * block - 1, row 0 is zero."""
    ops, _ = _operands(14, "none")
    t = _torch_ops(ops)
    x = t["x"][:, :1].repeat(1, length, 1) * torch.linspace(
        0.5, 1.5, length)[None, :, None]
    lam = (t["lam_re"], t["lam_im"])
    hist = lb.layer_tail_hist_plain(x, lam, t["w_b"], t["nw"], t["nb"],
                                    block=block)
    n_blocks = -(-length // block)
    assert hist[0].shape == hist[1].shape == (B, n_blocks, P)
    bu = (x * t["nw"] + t["nb"]) @ t["w_b"]
    carry = None
    for k in range(n_blocks):
        for half, c in zip(hist, carry or (torch.zeros(B, P),) * 2):
            np.testing.assert_allclose(half[:, k].numpy(), c.numpy(),
                                       atol=1e-5, rtol=0)
        chunk = bu[:, k * block:(k + 1) * block]
        _, carry = sequential_diag_scan(lam, (chunk[..., :P], chunk[..., P:]),
                                        carry_init=carry)
    # the dispatching wrapper takes the plain version for CPU tensors
    whole = lb.layer_tail_hist(x, lam, t["w_b"], t["nw"], t["nb"])
    assert whole[0].shape == (B, -(-length // lb.HIST_BLOCK), P)


def test_wrappers_check_operands():
    ops, g = _operands(15, "half1")
    t = _torch_ops(ops)
    args = (t["x"], (t["lam_re"], t["lam_im"]), t["w_b"], t["w_c"], t["d"],
            t["nw"], t["nb"])
    with pytest.raises(ValueError, match="m1"):     # (B, H) is not (B, 1, H)
        lt.layer_tail_cuda(*args, t["o2k"], t["o2b"], glu="half1",
                           m1=t["m1"][:, 0])
    with pytest.raises(ValueError, match="m2"):     # no gate, no second mask
        lt.layer_tail_cuda(*args, glu="none", m2=t["m2"])
    with pytest.raises(ValueError, match="g"):
        lb.layer_tail_bwd_cuda(t["x"], torch.from_numpy(g)[:, :5], *args[1:],
                               t["o2k"], t["o2b"], glu="half1")
    with pytest.raises(ValueError, match="non-empty"):
        lb.layer_tail_hist_cuda(t["x"][:, :0], *args[1:3], t["nw"], t["nb"])
