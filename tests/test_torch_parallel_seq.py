"""The port's sequence-parallel training against the JAX package's, on the
CPU over gloo ranks (the scans themselves are in
``test_torch_parallel_mesh.py``): the refusals of the scans and of the sp
mixer, the ``"sp"`` train step on seq 2 and on data 2 x seq 2 against the
JAX package's unsharded ``"associative"`` step at the single-device
step's bars (the clip of 37 frames splits 19 + 18), and ``train(cfg)``
with ``mesh_seq=2``."""

import dataclasses

import numpy as np
import pytest
import torch

from sparsernns_tpu_torch.parallel.launch import run_ranks
from sparsernns_tpu_torch.parallel.mesh import Mesh
from sparsernns_tpu_torch.parallel.seqscan import (make_seq_parallel_scan,
                                                   make_sp_train_scan)
from sparsernns_tpu_torch.parallel.sharding import seq_bounds
from sparsernns_tpu_torch.train import loop
from tests import torch_parallel_workers as workers
from tests.test_torch_parallel_mesh import _scan_inputs
from tests.test_torch_parallel_train import _cfg, _check_run, jax_reference


def _seq_mesh(n=2):
    """A seq axis of n ranks as rank 0 sees it, without process groups: the
    checks below raise before any exchange."""
    return Mesh(shape={"data": 1, "model": 1, "seq": n}, rank=0,
                coords={"data": 0, "model": 0, "seq": 0},
                device=torch.device("cpu"), groups={})


def test_seq_scan_refusals():
    """A length the seq axis does not divide (the serving scan), a rank
    without a frame, a training scan of other than (B, L, P) inputs, and
    the sp mixer's bidirectional or carried calls, as the JAX package
    refuses them."""
    with pytest.raises(ValueError, match="split"):
        seq_bounds(5, 4, 0)          # chunks of 2: the last rank gets none
    lam, bu = _scan_inputs(23)
    lam_t = tuple(torch.from_numpy(a) for a in lam)
    bu_t = tuple(torch.from_numpy(a) for a in bu)
    with pytest.raises(ValueError, match="divisible"):
        make_seq_parallel_scan(_seq_mesh())(lam_t, bu_t)
    with pytest.raises(ValueError, match=r"\(B, L, P\)"):
        make_sp_train_scan(_seq_mesh())(lam_t, (bu_t[0][0], bu_t[1][0]))
    cfg = _cfg(scan_mode="associative")
    with pytest.raises(NotImplementedError, match="classification"):
        loop.build_model(dataclasses.replace(cfg, dataset="smnist"), 1, 10,
                         device="cpu", mesh=_seq_mesh())
    for kw in (dict(bidirectional=True), {}):
        model = loop.build_model(dataclasses.replace(cfg, **kw), 257, 257,
                                 training=True, device="cpu")
        mixer = model.encoder.layers[0].mixer
        mixer.scan_mode = "sp"
        u = torch.zeros(1, 6, cfg.d_model)
        with pytest.raises(NotImplementedError, match="bidirectional"):
            if kw:
                mixer(u)
            else:
                mixer.forward_stream(u, None)


@pytest.fixture(scope="module")
def reference():
    return jax_reference(_cfg(scan_mode="associative"))


@pytest.mark.parametrize("shape", [(1, 1, 2), (2, 1, 2)],
                         ids=["seq2", "dp2xseq2"])
def test_sp_train_steps_match_jax_associative_step(reference, shape):
    """Three steps of the ``"sp"`` model (``build_model`` on a mesh with a
    seq axis) against the JAX unsharded associative step: each seq rank
    runs its 19 or 18 frames, the BatchNorm statistics cover every rank's
    rows and frames, the mask is gathered whole for the loss."""
    world = shape[0] * shape[2]
    outs = run_ranks(workers.train_rank, world,
                     (reference["cfg"], reference["start"],
                      reference["batches"], shape))
    for out in outs:
        _check_run(reference, out)
    acct = outs[0]["accounts"][0]
    # per layer one carry gather forward; the decoder's mask gathered once
    assert acct["per_op_counts"]["all-gather"] == \
        reference["cfg"].n_layers + 1
    assert acct["per_op_counts"]["reduce-scatter"] == \
        reference["cfg"].n_layers


def test_train_loop_with_seq_mesh(tmp_path):
    """``train(cfg)`` with ``mesh_seq=2`` on 2 ranks: the mixer runs the
    sp scan, one epoch, equal metrics and parameters on both ranks."""
    cfg = _cfg(mesh_data=1, mesh_seq=2, epochs=1, synthetic_size=8,
               checkpoint_dir=str(tmp_path))
    outs = run_ranks(workers.loop_rank, 2, (cfg,))
    assert outs[0]["metadata"] == outs[1]["metadata"]
    assert np.isfinite(outs[0]["metadata"]["best_val_loss"])
    for k, v in outs[0]["last_log"].items():
        assert v == outs[1]["last_log"][k], k
