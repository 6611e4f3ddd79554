"""Kernel K2's plain version against the JAX package's whole-layer tail
kernel (``fused_layer_tail`` in affine mode, run in interpret mode on the
CPU), for every GLU variant and both activations."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsernns_tpu.ops.pallas.fused_layer_train import fused_layer_tail
from sparsernns_tpu_torch.ops.cuda import layer_tail as lt
from sparsernns_tpu_torch.utils.trace import launch_counts

B, L, H, P = 2, 37, 16, 8


def _operands(seed):
    rng = np.random.RandomState(seed)
    f = lambda *s, sc=1.0: (rng.randn(*s) * sc).astype(np.float32)  # noqa
    r = rng.uniform(0.6, 0.99, P)
    th = rng.uniform(-np.pi, np.pi, P)
    return dict(
        x=f(B, L, H), lam=((r * np.cos(th)).astype(np.float32),
                           (r * np.sin(th)).astype(np.float32)),
        w_b=f(H, 2 * P, sc=0.3), w_c=f(2 * P, H, sc=0.3), d=f(H),
        nw=(1.0 + 0.2 * rng.randn(H)).astype(np.float32), nb=f(H, sc=0.1),
        o2k=f(H, H, sc=0.3), o2b=f(H, sc=0.1), o1k=f(H, H, sc=0.3),
        o1b=f(H, sc=0.1))


def _both(ops, glu, act, relu_state=False, layer_relu=False, block_t=16):
    j = {k: (tuple(jnp.asarray(a) for a in v) if isinstance(v, tuple)
             else jnp.asarray(v)) for k, v in ops.items()}
    t = {k: (tuple(torch.from_numpy(a) for a in v) if isinstance(v, tuple)
             else torch.from_numpy(v)) for k, v in ops.items()}
    use2, use1 = glu != "none", glu == "full"
    ref = fused_layer_tail(
        j["x"], None, j["lam"], j["w_b"], j["w_c"], j["d"],
        j["o2k"] if use2 else None, j["o2b"] if use2 else None,
        j["o1k"] if use1 else None, j["o1b"] if use1 else None,
        nw=j["nw"], nb=j["nb"], block_t=block_t, act=act, glu=glu,
        relu_state=relu_state, layer_relu=layer_relu)
    out = lt.layer_tail(
        t["x"], t["lam"], t["w_b"], t["w_c"], t["d"], t["nw"], t["nb"],
        t["o2k"] if use2 else None, t["o2b"] if use2 else None,
        t["o1k"] if use1 else None, t["o1b"] if use1 else None,
        act=act, glu=glu, relu_state=relu_state, layer_relu=layer_relu)
    return out.numpy(), np.asarray(ref)


@pytest.mark.parametrize("act", ["gelu", "relu"])
@pytest.mark.parametrize("glu", ["full", "half1", "half2", "none"])
def test_layer_tail_plain_matches_pallas(glu, act):
    before = launch_counts()["layer_tail_train"]
    out, ref = _both(_operands(7), glu, act)
    assert out.shape == (B, L, H)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    # CPU tensors launch nothing
    assert launch_counts()["layer_tail_train"] == before


def test_layer_tail_relufied_matches_pallas():
    """Mixer relufication (relu on the states) and the layer relu."""
    out, ref = _both(_operands(8), "half1", "relu", relu_state=True,
                     layer_relu=True, block_t=8)
    assert (out >= 0).all()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_layer_tail_cuda_checks_operands():
    ops = {k: (tuple(torch.from_numpy(a) for a in v)
               if isinstance(v, tuple) else torch.from_numpy(v))
           for k, v in _operands(9).items()}
    args = (ops["x"], ops["lam"], ops["w_b"], ops["w_c"], ops["d"],
            ops["nw"], ops["nb"])
    with pytest.raises(ValueError, match="o2k"):   # half1 needs the gate
        lt.layer_tail_cuda(*args, glu="half1")
    with pytest.raises(ValueError, match="glu"):
        lt.layer_tail_cuda(*args, glu="quarter")
