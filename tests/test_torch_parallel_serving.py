"""The port's parallel serving of the engine against the JAX package's,
on the CPU: the data-, sequence- and tensor-parallel forwards on 2 gloo
ranks and the pipeline over a list of devices, from the frozen tree of
``tests/test_torch_quantize.py`` (H 12, P 8, 2 layers; the JAX
calibration runs once per module). The DP forward equals the one-device
engine bit for bit; SP, TP and the pipeline's float route hold the JAX
package's forwards to the engine bar (max 2e-3, mean 1e-4 of
max(1, |ref|)); the pipeline's mxu16 route equals ``process_chunk`` at the
same chunk length bit for bit. The collective bytes: none for DP, one
gather of the (λ^T, end) pairs a layer for SP whatever the length, one
all-reduce of (B, L, H) float32 a layer for TP."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsernns_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from sparsernns_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sparsernns_tpu.parallel.pp_engine import \
    make_pp_forward as jax_pp_forward
from sparsernns_tpu.parallel.sp_engine import \
    make_sp_forward as jax_sp_forward
from sparsernns_tpu.parallel.sp_engine import \
    make_tp_forward as jax_tp_forward
from sparsernns_tpu_torch.parallel.launch import run_ranks
from sparsernns_tpu_torch.parallel.pp_engine import (_engine_on,
                                                     make_pp_forward)
from sparsernns_tpu_torch.parallel.sp_engine import (make_sp_forward,
                                                     make_tp_forward)
from tests import torch_parallel_workers as workers
from tests.test_torch_engine import jax_eng
from tests.test_torch_quantize import D_IO, LAYERS, frozen  # noqa: F401

B = 2


def _x(length, seed=3):
    return (0.5 * np.random.RandomState(seed).randn(B, length, D_IO)
            ).astype(np.float32)


def _engine_close(out, ref):
    scale = np.maximum(1.0, np.abs(ref))
    err = np.abs(out - ref) / scale
    assert err.max() <= 2e-3 and err.mean() <= 1e-4, (err.max(), err.mean())


def _jax_mesh(model=1, seq=1):
    return jax_make_mesh(JaxMeshConfig(data=1, model=model, seq=seq),
                         devices=jax.devices()[:model * seq])


def _jax_engine(frozen):  # noqa: F811
    return jax_eng(frozen, glu="half1")


def test_dp_forward_equals_one_device_engine(frozen):  # noqa: F811
    """Each data rank's rows of the mask are the one-device call's, bit for
    bit, and no collective runs."""
    x = _x(24)
    outs = run_ranks(workers.serve_rank, 2, (frozen, [x], "dp"))
    engine = workers.port_engine(frozen)
    whole = engine(torch.from_numpy(x)).numpy()
    got = np.concatenate([o[0][0] for o in outs], axis=0)
    np.testing.assert_array_equal(got, whole)
    for o in outs:
        assert o[0][1]["total_bytes"] == 0


@pytest.mark.parametrize("n", [2])
def test_sp_and_tp_forwards_match_jax(frozen, n):  # noqa: F811
    """SP (each rank's chunk) and TP (the whole mask on every rank)
    against the JAX package's on n virtual devices; SP's exchange a layer
    is the same at 24 and 48 frames, TP's one all-reduce of (B, L, H)."""
    xs = [_x(24), _x(48, seed=4)]
    je = _jax_engine(frozen)
    h = je.encoder_bias.shape[0]
    p = je.layers[0].lam[0].shape[0]
    sp = run_ranks(workers.serve_rank, n, (frozen, xs, "sp"))
    jsp = jax.jit(jax_sp_forward(je, _jax_mesh(seq=n)))
    for k, x in enumerate(xs):
        ref = np.asarray(jsp(jnp.asarray(x)))
        got = np.concatenate([o[k][0] for o in sp], axis=1)
        _engine_close(got, ref)
    for o in sp:
        accts = [o[k][1] for k in range(len(xs))]
        assert accts[0] == accts[1]
        assert accts[0]["per_op_counts"] == {"all-gather": LAYERS}
        assert accts[0]["per_op_bytes"]["all-gather"] == \
            LAYERS * n * 4 * (2 * p + 2 * B * p)
    tp = run_ranks(workers.serve_rank, n, (frozen, xs, "tp"))
    jtp = jax_tp_forward(je, _jax_mesh(model=n))
    for k, x in enumerate(xs):
        ref = np.asarray(jtp(jnp.asarray(x)))
        for o in tp:
            _engine_close(o[k][0], ref)
            assert o[k][1]["per_op_counts"] == {"all-reduce": LAYERS}
            assert o[k][1]["per_op_bytes"]["all-reduce"] == \
                LAYERS * B * x.shape[1] * h * 4


def test_pp_float_route_matches_jax(frozen):  # noqa: F811
    """Two stages (one layer each) over two CPU devices, 4 chunks of 6
    frames, against the JAX package's pipeline on a 2-device model
    axis."""
    x = _x(24)
    ref = np.asarray(jax_pp_forward(_jax_engine(frozen),
                                    _jax_mesh(model=2))(jnp.asarray(x)))
    engine = workers.port_engine(frozen)
    for chunks in (None, 2):
        got = make_pp_forward(engine, ["cpu", "cpu"], chunks=chunks)(
            torch.from_numpy(x)).numpy()
        _engine_close(got, ref)


def test_pp_mxu16_route_equals_process_chunk(frozen):  # noqa: F811
    """The mxu16 engine through two stages equals ``process_chunk`` chunk
    by chunk, bit for bit (the whole-layer kernel with a carry per stage,
    its plain version here)."""
    engine = workers.port_engine(frozen, engine_kw=dict(mxu16=True))
    assert engine.mxu16["mixer"] or engine.mxu16["requants"]
    x = torch.from_numpy(_x(32))
    got = make_pp_forward(engine, ["cpu", "cpu"], chunks=4)(x)
    carries, want = None, []
    for c in range(4):
        y, carries = engine.process_chunk(x[:, 8 * c:8 * (c + 1)], carries)
        want.append(y)
    torch.testing.assert_close(got, torch.cat(want, dim=1), rtol=0, atol=0)


def test_pp_stage_engine_copies(frozen):  # noqa: F811
    """A stage on another device gets a shallow copy of the engine with
    every tensor there (the ``meta`` device stands in for a second card);
    the engine itself stays where it was."""
    engine = workers.port_engine(frozen)
    moved = _engine_on(engine, torch.device("meta"))
    assert moved is not engine and moved.device == torch.device("meta")
    for lp, lq in zip(moved.layers, engine.layers):
        assert lp.w_b.is_meta and lp.lam[0].is_meta and lq.w_b.device.type \
            == "cpu"
    assert moved.encoder_kernel.data.is_meta
    assert not engine.encoder_kernel.data.is_meta
    assert _engine_on(engine, "cpu") is engine


def test_parallel_serving_refusals(frozen):  # noqa: F811
    """As the JAX package refuses: layers that do not divide into the
    stages, a length that the chunks do not divide, GLU other than half1
    or none, top-k, non-uniform layer operands on the float route, and the
    mxu16 mode on the SP and TP paths."""
    engine = workers.port_engine(frozen)
    with pytest.raises(ValueError, match="partition"):
        make_pp_forward(engine, ["cpu"] * 3)
    with pytest.raises(ValueError, match="divisible"):
        make_pp_forward(engine, ["cpu", "cpu"])(torch.zeros(1, 6, D_IO))
    with pytest.raises(NotImplementedError, match="glu"):
        make_pp_forward(workers.port_engine(frozen, glu_variant="full"),
                        ["cpu", "cpu"])
    with pytest.raises(NotImplementedError, match="top-k"):
        make_pp_forward(workers.port_engine(frozen, topk=0.5,
                                            approx_topk=True),
                        ["cpu", "cpu"])
    odd = copy.copy(engine)
    odd.layers = [engine.layers[0], dataclasses.replace(
        engine.layers[1], residual_requant=(1.0, 4))]
    with pytest.raises(NotImplementedError, match="uniform"):
        make_pp_forward(odd, ["cpu", "cpu"])
    mxu16 = workers.port_engine(frozen, engine_kw=dict(mxu16=True))
    for make in (make_sp_forward, make_tp_forward):
        with pytest.raises(NotImplementedError, match="mxu16"):
            make(mxu16, None)
