"""The port's kernel-free routes against the JAX package's, on the CPU:
``blocked_diag_scan`` (forward, from a carry, reverse, ragged L, the block
requant) and its gradients, a ``scan_mode="blocked"`` model's forward and
train step, and the serving engine's ``route="xla"`` offline and chunked.
The same numpy inputs (and for the engine the same frozen tree, the JAX
calibration of ``tests/test_torch_quantize.py``) go through both.

Tolerances: states 1e-5 of max|x| (the f32 matmuls sum in another order);
the block requant at the engine's state-code bar (codes at most one apart
in at most 0.5 % of the elements); gradients 2e-4 of each leaf's largest;
the model at the bars of ``tests/test_torch_train.py``; the engine at its
bar, max 2e-3·max(1,|ref|) and mean 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsernns_tpu.fxp.derive import FxpModelConfig as JaxModelConfig
from sparsernns_tpu.ops import scan as jscan
from sparsernns_tpu.quantize.config import quantization_recipes as jax_recipes
from sparsernns_tpu.quantize.engine import W8A16Engine as JaxEngine
from sparsernns_tpu.train.steps import make_ndns_train_step as jax_train_step
from sparsernns_tpu_torch.ops import scan as tscan
from sparsernns_tpu_torch.ops.scan import blocked_diag_scan
from sparsernns_tpu_torch.quantize import engine
from sparsernns_tpu_torch.train.steps import make_ndns_train_step
from sparsernns_tpu_torch.weights import to_flax
from tests.test_torch_engine import jax_eng, port_eng
from tests.test_torch_quantize import frozen  # noqa: F401
from tests.test_torch_scan_chunked import (GRID8, GRID16, _codes_close,
                                           _float_close, _inputs, _j, _t)
from tests.test_torch_train import (D_IO, _paired_states, assert_trees_close,
                                    audio_batch, jax_features, paired,
                                    small_config, torch_features)


@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("block_t", [1, 8, 16, 128])
@pytest.mark.parametrize("length", [1, 16, 37])
def test_blocked_scan_matches_jax(length, block_t, carry):
    lam, bu, c = _inputs(length * 10 + block_t, l=length)
    kw = dict(block_t=block_t)
    ref = jscan.blocked_diag_scan(_j(lam), _j(bu),
                                  carry_init=_j(c) if carry else None, **kw)
    out = tscan.blocked_diag_scan(_t(lam), _t(bu),
                                  carry_init=_t(c) if carry else None, **kw)
    _float_close(out, ref, (length, block_t, carry))
    # and the sequential recurrence it stands for
    seq = tscan.sequential_diag_scan(_t(lam), _t(bu),
                                     carry_init=_t(c) if carry else None)[0]
    _float_close(out, seq, "sequential")


@pytest.mark.parametrize("block_t", [4, 16])
def test_blocked_scan_reverse_matches_jax(block_t):
    lam, bu, c = _inputs(3, l=21)
    ref = jscan.blocked_diag_scan(_j(lam), _j(bu), block_t=block_t,
                                  reverse=True)
    out = tscan.blocked_diag_scan(_t(lam), _t(bu), block_t=block_t,
                                  reverse=True)
    _float_close(out, ref, "reverse")
    with pytest.raises(NotImplementedError, match="reverse"):
        tscan.blocked_diag_scan(_t(lam), _t(bu), reverse=True,
                                carry_init=_t(c))
    with pytest.raises(NotImplementedError, match="reverse"):
        jscan.blocked_diag_scan(_j(lam), _j(bu), reverse=True,
                                carry_init=_j(c))


@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("grid", [GRID16, GRID8], ids=["16", "8"])
@pytest.mark.parametrize("length,block_t", [(37, 8), (64, 16), (30, 128)])
def test_blocked_scan_block_requant_matches_jax(length, block_t, grid,
                                                carry):
    """Every state on the frozen grid, the carry the requantized
    block-final state: the state-code bar against JAX's."""
    lam, bu, c = _inputs(7 + length, l=length)
    if carry:
        c = tuple(np.round(a / g) * g for a, g in zip(c, grid[:2]))
    kw = dict(block_t=block_t, block_requant=grid)
    ref = jscan.blocked_diag_scan(_j(lam), _j(bu),
                                  carry_init=_j(c) if carry else None, **kw)
    out = tscan.blocked_diag_scan(_t(lam), _t(bu),
                                  carry_init=_t(c) if carry else None, **kw)
    _codes_close(out, ref, grid[:2], (length, block_t, grid, carry))


@pytest.mark.parametrize("carry", [False, True])
def test_blocked_scan_gradients_match_jax(carry):
    """Gradients in λ, bu and the carry of a weighted sum of the states,
    2e-4 of each one's largest entry."""
    lam, bu, c = _inputs(11, l=29)
    rng = np.random.RandomState(12)
    w = (rng.randn(2, 29, 8).astype(np.float32),
         rng.randn(2, 29, 8).astype(np.float32))

    def jloss(lam, bu, c):
        xs = jscan.blocked_diag_scan(lam, bu, block_t=8,
                                     carry_init=c if carry else None)
        return jnp.sum(xs[0] * w[0]) + jnp.sum(xs[1] * w[1])

    ref = jax.grad(jloss, argnums=(0, 1, 2))(_j(lam), _j(bu), _j(c))
    tl, tb, tc = (tuple(t.requires_grad_() for t in _t(p))
                  for p in (lam, bu, c))
    xs = tscan.blocked_diag_scan(tl, tb, block_t=8,
                                 carry_init=tc if carry else None)
    (torch.sum(xs[0] * torch.from_numpy(w[0]))
     + torch.sum(xs[1] * torch.from_numpy(w[1]))).backward()
    pairs = [(tl, ref[0]), (tb, ref[1])] + ([(tc, ref[2])] if carry else [])
    for ours, theirs in pairs:
        for o, r in zip(ours, theirs):
            r = np.asarray(r)
            np.testing.assert_allclose(o.grad.numpy(), r, rtol=0,
                                       atol=2e-4 * np.abs(r).max())


def test_blocked_mode_dispatch_and_refusals():
    """``diag_ssm_scan(mode="blocked")`` is the blocked scan with a block
    of 128 by default; the QAT hadamards raise in both packages."""
    lam, bu, c = _inputs(5, l=40)
    out = tscan.diag_ssm_scan(_t(lam), _t(bu), mode="blocked",
                              carry_init=_t(c))
    ref = jscan.diag_ssm_scan(_j(lam), _j(bu), mode="blocked",
                              carry_init=_j(c))
    _float_close(out, ref, "dispatch")
    from sparsernns_tpu.quantize.qat import q_had as jq_had
    from sparsernns_tpu_torch.quantize.qat import q_had
    with pytest.raises(NotImplementedError, match="hadamards"):
        tscan.diag_ssm_scan(_t(lam), _t(bu), mode="blocked",
                            had_aa=q_had(8, 8))
    with pytest.raises(NotImplementedError, match="hadamards"):
        jscan.diag_ssm_scan(_j(lam), _j(bu), mode="blocked",
                            had_aa=jq_had(8, 8))


def test_blocked_model_forward_and_train_step_match_jax():
    """A ``scan_mode="blocked"`` model (time block 16): the training
    forward 1e-4, then one train step at the bars of
    ``tests/test_torch_train.py`` (loss, SI-SNR and gradient norms 1e-3
    relative, parameters rtol 1e-3 + 1e-5, running statistics 1e-5)."""
    cfg = small_config(scan_mode="blocked", block_t=16)
    jm, variables, tm = paired(cfg, seed=4)
    x = np.random.RandomState(5).randn(2, 37, D_IO).astype(np.float32)
    ref, _ = jm.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    out = tm(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-4, rtol=0)
    assert tm.encoder.layers[0].mixer.scan_mode == "blocked"
    assert not tm.encoder.layers[0].takes_tail()

    jm, jstate, tm, state = _paired_states(cfg, seed=6)
    noisy, clean = audio_batch(2, seed=7)
    jstate, jmet = jax_train_step(jm, batchnorm=True)(
        jstate, jax.random.PRNGKey(0), *jax_features(noisy, clean))
    state, met = make_ndns_train_step(tm)(state, *torch_features(noisy,
                                                                 clean))
    for key in ("loss", "si_snr", "grad_norm", "grad_norm/encoder",
                "grad_norm/decoder"):
        assert met[key].item() == pytest.approx(float(jmet[key]), rel=1e-3,
                                                abs=1e-3), key
    params, stats = to_flax(tm)
    assert_trees_close(params, jax.device_get(jstate.params), rtol=1e-3,
                       atol=1e-5)
    assert_trees_close(stats, jax.device_get(jstate.batch_stats), rtol=0,
                       atol=1e-5)


def _engine_close(out, ref):
    """The engine bar: max 2e-3·max(1,|ref|), mean 1e-4."""
    out, ref = np.asarray(out), np.asarray(ref)
    err = np.abs(out - ref)
    assert (err <= 2e-3 * np.maximum(1.0, np.abs(ref))).all(), err.max()
    assert err.mean() <= 1e-4, err.mean()


def _carry_codes_close(out, ref, scan, grid, name):
    """A carry's codes on its frozen grid against the JAX package's: equal,
    but where the unrounded state (the last row of the recorded blocked
    scan ``scan`` = (lam, bu, carry_init) of the chunk, redone without the
    requant) lies within float32 round-off of a rounding boundary, where
    they may be one apart. The state sums T + 1 terms (the chunk's T rows
    and the carry, each times a power of λ made by exp, log, cos and sin:
    λ^k's angle rounds like k times θ's, |θ| <= π, so a power is good to
    about 2k ulps), in another order on each side: the round-off is at most
    4 (T + 1) 2^-23 of the terms' magnitudes summed."""
    lam, bu, carry = scan
    raw = blocked_diag_scan(lam, bu, block_t=bu[0].shape[1],
                            carry_init=carry)
    t = bu[0].shape[1]
    r = torch.sqrt(lam[0].double() ** 2 + lam[1].double() ** 2)
    mag = torch.sqrt(bu[0].double() ** 2 + bu[1].double() ** 2)
    powers = r ** torch.arange(t - 1, -1, -1, dtype=torch.float64)[:, None]
    terms = ((mag * powers).sum(dim=1) + r ** t * torch.sqrt(
        carry[0].double() ** 2 + carry[1].double() ** 2)).numpy()
    for h, (o, q, u) in enumerate(zip(out, ref, raw)):
        o, q = np.asarray(o) / grid[h], np.asarray(q) / grid[h]
        u = u[..., -1, :].double().numpy() / grid[h]
        np.testing.assert_array_equal(o, np.round(o))
        tie = (np.abs(u - np.floor(u) - 0.5)
               <= 4 * (t + 1) * 2.0 ** -23 * terms / grid[h])
        diff = np.abs(o - np.round(q))
        assert diff.max() <= 1 and not diff[~tie].any(), (
            name, h, diff.max(), u[(diff > 0) & ~tie])


@pytest.mark.parametrize("act", ["float32", "bfloat16"])
@pytest.mark.parametrize("glu,relu,prenorm", [("full", True, True),
                                              ("half1", False, False)])
def test_xla_engine_matches_jax_xla_engine(frozen, glu, relu, prenorm, act,  # noqa: F811
                                           monkeypatch):
    """``route="xla"`` offline and chunked (three chunks of the time
    block, carries between them) against the JAX package's ``"xla"``
    engine, and with float32 activations against the kernel route. With
    bf16 activations the per-op route rounds each mixer input to bf16
    where the whole-layer kernels do not, in both packages, so there the
    route is held against JAX's xla engine only. The last carries' codes
    are equal to JAX's but at rounding ties (:func:`_carry_codes_close`)."""
    t_act = getattr(torch, act)
    kw = dict(glu=glu, relu=relu, prenorm=prenorm, block_t=8, act=t_act)
    je_x = JaxEngine(
        frozen["frozen_params"], frozen["frozen_stats"],
        jax_recipes["w8a16"](static_quant=True, calibrating=False),
        JaxModelConfig.infer(frozen["frozen_params"], glu_variant=glu,
                             relufication=relu, prenorm=prenorm,
                             clip_eigs=True),
        act_dtype=getattr(jnp, act), block_t=8, route="xla")
    te_x = port_eng(frozen, engine_kw=dict(route="xla"), **kw)
    assert te_x.route == "xla" and not te_x._stack_ok
    x = frozen["batches"][0]
    ref = np.asarray(je_x(jnp.asarray(x)), np.float32)
    out = te_x(torch.from_numpy(x)).float().numpy()
    _engine_close(out, ref)
    if act == "float32":
        te = port_eng(frozen, **kw)
        _engine_close(out, te(torch.from_numpy(x)).numpy())
        _engine_close(out, np.asarray(jax_eng(frozen, **kw)(jnp.asarray(x))))
    # chunked at the time block against the JAX xla engine's chunks and
    # against the whole call
    carries, jcarries, outs, jouts = None, None, [], []
    scans = []

    def recorded(lam, bu, **kw):
        scans.append((lam, bu, kw["carry_init"]))
        return blocked_diag_scan(lam, bu, **kw)

    monkeypatch.setattr(engine, "blocked_diag_scan", recorded)
    for i in range(0, x.shape[1], 8):
        chunk = x[:, i:i + 8]
        scans.clear()
        y, carries = te_x.process_chunk(torch.from_numpy(chunk), carries)
        jy, jcarries = je_x.process_chunk(jnp.asarray(chunk), jcarries)
        outs.append(y.numpy())
        jouts.append(np.asarray(jy))
    _engine_close(np.concatenate(outs, 1), np.concatenate(jouts, 1))
    _engine_close(np.concatenate(outs, 1), out)
    # one recorded scan a layer, each over the last chunk
    assert len(scans) == len(te_x.layers) == len(carries) == len(jcarries)
    for (_, bu, _), ours in zip(scans, carries):
        assert bu[0].shape == bu[1].shape == (*chunk.shape[:2],
                                              ours[0].shape[-1])
    for layer, ours, theirs, scan in zip(te_x.layers, carries, jcarries,
                                         scans):
        _carry_codes_close([c.numpy() for c in ours], theirs, scan,
                           layer.state_requant[:2], "carry")
