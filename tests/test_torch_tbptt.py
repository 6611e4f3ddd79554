"""Truncated backpropagation through time: the port's ``data/tbptt.py``
against the JAX package's on the CPU. The chunker and its loader exactly;
the carried eval forward chunk by chunk against the whole forward and
against JAX's chunks (1e-4·max(1,|ref|)); TBPTT train steps from the same
weights on the ``"associative"`` and ``"blocked"`` scans (losses 1e-3
relative, parameters rtol 1e-3 + 1e-5 and running statistics 1e-5 after
the steps, carries 1e-4 of their largest); and a ``"fused"`` model
raising in both packages, since the carried scan kernel has no gradient
in either."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsernns_tpu.data import tbptt as jtb
from sparsernns_tpu.train import optim as jax_optim
from sparsernns_tpu.train.state import TrainState as JaxTrainState
from sparsernns_tpu_torch.data import tbptt as ttb
from sparsernns_tpu_torch.train import loop
from sparsernns_tpu_torch.weights import from_flax, to_flax
from tests.test_torch_classification import close
from tests.test_torch_train import (D_IO, assert_trees_close,
                                    jax_training_model, small_config)

D_OUT = 5


@pytest.mark.parametrize("chunk_len,overlap", [(8, 1), (8, 4), (10, 3),
                                               (37, 1), (5, 5)])
def test_chunks_equal_jax(chunk_len, overlap):
    rng = np.random.RandomState(chunk_len + overlap)
    x = rng.randn(2, 37, 3).astype(np.float32)
    for y in (rng.randn(2, 37, 1).astype(np.float32),
              np.asarray([3, 1])):
        ours = list(ttb.tbptt_chunks(x, y, chunk_len, overlap, -1.0))
        theirs = list(jtb.tbptt_chunks(x, y, chunk_len, overlap, -1.0))
        assert len(ours) == len(theirs)
        for (ox, oy, orr), (jx, jy, jr) in zip(ours, theirs):
            assert orr == jr
            np.testing.assert_array_equal(ox, jx)
            np.testing.assert_array_equal(oy, jy)
    for bad in (dict(chunk_len=0), dict(chunk_len=4, overlap_len=0)):
        with pytest.raises(ValueError):
            next(ttb.tbptt_chunks(x, None, **bad))


def test_loader_equals_jax():
    class Loader:
        seq_len = 30

        def __iter__(self):
            rng = np.random.RandomState(1)
            for _ in range(3):
                yield (rng.randn(2, 30, 2).astype(np.float32),
                       rng.randn(2, 30, 1).astype(np.float32))

        def __len__(self):
            return 3

    for chunk, overlap in ((8, 1), (7, 3)):
        ours = ttb.TBPTTLoader(Loader(), chunk, overlap)
        theirs = jtb.TBPTTLoader(Loader(), chunk, overlap)
        assert len(ours) == len(theirs)
        a, b = list(ours), list(theirs)
        assert len(a) == len(b) == len(ours)
        for (ox, oy, orr), (jx, jy, jr) in zip(a, b):
            assert orr == jr
            np.testing.assert_array_equal(ox, jx)
            np.testing.assert_array_equal(oy, jy)
    with pytest.raises(TypeError, match="seq_len"):
        len(ttb.TBPTTLoader([], 4))


def _paired(cfg, training, seed):
    jm = jax_training_model(cfg, block_t=16)
    jm = jm.clone(training=training, d_output=D_OUT)
    variables = jax.device_get(jm.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 16, D_IO), jnp.float32)))
    rng = np.random.RandomState(seed + 1)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (0.2 * rng.randn(*a.shape) if path[-1].key == "mean"
                         else rng.uniform(0.5, 1.5, a.shape)
                         ).astype(np.float32), variables["batch_stats"])
    tm = loop.build_model(cfg, D_IO, D_OUT, training=training, device="cpu")
    tm.load_state_dict(from_flax(variables["params"], stats))
    return jm, {"params": variables["params"], "batch_stats": stats}, tm


def _jax_carry(jm, variables, x):
    """JAX's zero ``cache`` collection for chunks like ``x``."""
    return jtb.init_carry(jm.clone(training=False), variables, x)


@pytest.mark.parametrize("scan_mode", ["associative", "blocked",
                                       "sequential"])
def test_chunked_forward_equals_whole_and_jax(scan_mode):
    cfg = small_config(scan_mode=scan_mode, block_t=16)
    jm, variables, tm = _paired(cfg, False, seed=2)
    x = np.random.RandomState(3).randn(2, 40, D_IO).astype(np.float32)
    with torch.no_grad():
        whole = tm(torch.from_numpy(x)).numpy()
        carry = ttb.init_carry(tm, torch.from_numpy(x[:, :10]))
        assert [c[0].shape for c in carry] == [(2, 8)] * cfg.n_layers
        outs = []
        for i in range(0, 40, 10):
            y, carry = tm.forward_stream(torch.from_numpy(x[:, i:i + 10]),
                                         carry)
            outs.append(y.numpy())
    close(np.concatenate(outs, 1), whole)
    jcarry = _jax_carry(jm, variables, jnp.asarray(x[:, :10]))
    jouts = []
    for i in range(0, 40, 10):
        y, mut = jm.apply({**variables, "cache": jcarry},
                          jnp.asarray(x[:, i:i + 10]), mutable=["cache"])
        jcarry = mut["cache"]
        jouts.append(np.asarray(y))
    close(np.concatenate(outs, 1), np.concatenate(jouts, 1))
    zeros = ttb.zero_carry(carry)
    assert all(not c[0].any() and not c[1].any() for c in zeros)


@pytest.mark.parametrize("overlap", [1, 3])
@pytest.mark.parametrize("scan_mode", ["associative", "blocked"])
def test_tbptt_steps_match_jax(scan_mode, overlap):
    """Four chunk steps over two batches (a reset between them) with a
    mean-squared-error loss, prenorm BatchNorm in training mode."""
    cfg = small_config(scan_mode=scan_mode, block_t=16)
    jm, variables, tm = _paired(cfg, True, seed=4)
    tx = jax_optim.create_optimizer(
        cfg.opt_config, lr=cfg.lr, ssm_lr=cfg.ssm_lr_base,
        weight_decay=cfg.weight_decay, total_steps=8, warmup_steps=2)
    jstate = JaxTrainState.create(apply_fn=jm.apply,
                                  params=variables["params"], tx=tx,
                                  batch_stats=variables["batch_stats"])
    state = loop.create_run_state(dataclasses.replace(cfg, epochs=4), tm, 2)
    jloss = lambda pred, tgt: jnp.mean((pred - tgt) ** 2)  # noqa: E731
    tloss = lambda pred, tgt: torch.mean((pred - tgt) ** 2)  # noqa: E731
    jstep = jtb.make_tbptt_train_step(jm, jloss, batchnorm=True,
                                      overlap_len=overlap)
    step = ttb.make_tbptt_train_step(tm, tloss, overlap_len=overlap)
    rng = np.random.RandomState(5)
    jcarry = carry = None
    losses = []
    for _ in range(2):
        x = rng.randn(2, 24, D_IO).astype(np.float32)
        y = (0.1 * rng.randn(2, 24, D_OUT)).astype(np.float32)
        for xc, yc, reset in ttb.tbptt_chunks(x, y, 8, overlap):
            if reset:
                carry = ttb.init_carry(tm, torch.from_numpy(xc))
                jcarry = _jax_carry(jm, variables, jnp.asarray(xc))
            jstate, jcarry, jm_ = jstep(jstate, jax.random.PRNGKey(0),
                                        jcarry, jnp.asarray(xc),
                                        jnp.asarray(yc))
            state, carry, m = step(state, carry, torch.from_numpy(xc),
                                   torch.from_numpy(yc))
            assert m["loss"].item() == pytest.approx(float(jm_["loss"]),
                                                     rel=1e-3)
            losses.append(m["loss"].item())
            assert not any(c[0].requires_grad for c in carry)
    assert len(losses) == 4 and state.step == 4 == int(jstate.step)
    params, stats = to_flax(tm)
    assert_trees_close(params, jax.device_get(jstate.params), rtol=1e-3,
                       atol=1e-5)
    assert_trees_close(stats, jax.device_get(jstate.batch_stats), rtol=0,
                       atol=1e-5)
    for i, (re, im) in enumerate(carry):
        ref = jcarry["encoder"][f"layers_{i}"]["mixer"]
        for ours, key in ((re, "carry_re"), (im, "carry_im")):
            r = np.asarray(ref[key])
            np.testing.assert_allclose(ours.numpy(), r, rtol=0,
                                       atol=1e-4 * np.abs(r).max())


def test_fused_model_raises_in_both_packages():
    """The carried scan kernel has no gradient: a ``"fused"`` (or
    ``"pallas"``) model's TBPTT step raises in JAX and in the port."""
    cfg = small_config(scan_mode="fused", block_t=16)
    jm, variables, tm = _paired(cfg, True, seed=6)
    x = np.random.RandomState(7).randn(2, 8, D_IO).astype(np.float32)
    y = np.zeros((2, 8, D_OUT), np.float32)
    tx = jax_optim.create_optimizer(cfg.opt_config, lr=cfg.lr,
                                    ssm_lr=cfg.ssm_lr_base, total_steps=4,
                                    warmup_steps=1)
    jstate = JaxTrainState.create(apply_fn=jm.apply,
                                  params=variables["params"], tx=tx,
                                  batch_stats=variables["batch_stats"])
    jstep = jtb.make_tbptt_train_step(
        jm, lambda p, t: jnp.mean((p - t) ** 2), batchnorm=True)
    with pytest.raises(NotImplementedError):
        jstep(jstate, jax.random.PRNGKey(0),
              _jax_carry(jm, variables, jnp.asarray(x)), jnp.asarray(x),
              jnp.asarray(y))
    state = loop.create_run_state(cfg, tm, 1)
    step = ttb.make_tbptt_train_step(
        tm, lambda p, t: torch.mean((p - t) ** 2))
    with pytest.raises(NotImplementedError, match="no gradient"):
        step(state, ttb.init_carry(tm, torch.from_numpy(x)),
             torch.from_numpy(x), torch.from_numpy(y))
