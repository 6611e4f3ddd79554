"""The port's mesh, collectives, sharding rules and cost accounting against
the JAX package's, on the CPU: the (data, model, seq) grid over 4 gloo
ranks and its refusal of a grid that is not the world, the gather's
backward (a replicated consumer's gradient stays on its rank), the
parameter rules
against ``param_sharding``, ``shard_batch``, the scaling model, and
``S5Cost`` / ``model_forward_flops`` at the flagship's shape against the
JAX package's numbers; and the sequence-parallel scans
(``make_seq_parallel_scan``, ``make_sp_train_scan`` with a length the seq
axis does not divide) against the JAX package's on its virtual devices
(1e-5 of max|x|), the training scan's gradients against ``jax.vjp`` of
the JAX one (rtol = atol 2e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsernns_tpu.parallel.comms import \
    scaling_efficiency_model as jax_scaling
from sparsernns_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from sparsernns_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sparsernns_tpu.parallel.seqscan import \
    make_seq_parallel_scan as jax_seq_scan
from sparsernns_tpu.parallel.seqscan import make_sp_train_scan as jax_sp_scan
from sparsernns_tpu.parallel.sharding import param_sharding as jax_sharding
from sparsernns_tpu.utils import profiling as jax_profiling
from sparsernns_tpu_torch.parallel import comms
from sparsernns_tpu_torch.parallel.launch import run_ranks
from sparsernns_tpu_torch.parallel.mesh import (MeshConfig, make_mesh,
                                                maybe_initialize_distributed)
from sparsernns_tpu_torch.parallel.sharding import (param_sharding,
                                                    param_spec, seq_bounds,
                                                    shard_batch)
from sparsernns_tpu_torch.utils import profiling
from tests import torch_parallel_workers as workers


def _scan_inputs(l, p=8, b=2, seed=0):
    rng = np.random.RandomState(seed)
    lam_c = 0.9 * np.exp(1j * rng.uniform(0, np.pi, p)) * \
        rng.uniform(0.5, 1, p)
    lam = (lam_c.real.astype(np.float32), lam_c.imag.astype(np.float32))
    bu = (rng.randn(b, l, p).astype(np.float32),
          rng.randn(b, l, p).astype(np.float32))
    return lam, bu


def _jax_mesh(n):
    return jax_make_mesh(JaxMeshConfig(data=1, model=1, seq=n),
                         devices=jax.devices()[:n])


@pytest.mark.parametrize("n,l,mode", [(2, 64, "serve"), (4, 64, "serve"),
                                      (2, 23, "train"), (4, 23, "train")])
def test_seq_scans_match_jax(n, l, mode):
    """Each rank's chunk of the states against the JAX package's scan on n
    devices; for the training scan (23 frames: chunks 12 + 11 and
    6 + 6 + 6 + 5) the gradients of sum(x_re w + x_im w²), w = cos(t),
    summed over the ranks, against ``jax.vjp``; the exchange is one
    gather of n (λ^T, end) pairs, (2P + 2BP) float32 each, forward and
    one reduce-scatter of one pair backward."""
    lam, bu = _scan_inputs(l)
    outs = run_ranks(workers.scan_rank, n, (lam, bu, mode))
    jlam = tuple(jnp.asarray(a) for a in lam)
    jbu = tuple(jnp.asarray(a) for a in bu)
    make = jax_sp_scan if mode == "train" else jax_seq_scan
    scan = jax.jit(make(_jax_mesh(n)))
    ref, vjp = jax.vjp(scan, jlam, jbu)
    for k in range(2):
        got = np.concatenate([o[0][k] for o in outs], axis=1)
        want = np.asarray(ref[k])
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    p, b = lam[0].shape[0], bu[0].shape[0]
    pair = 4 * (2 * p + 2 * b * p)
    for o in outs:
        assert o[2]["per_op_bytes"]["all-gather"] == n * pair
        assert o[2]["per_op_counts"] == {"all-gather": 1,
                                         "reduce-scatter": 1}
        assert o[2]["per_op_bytes"]["reduce-scatter"] == pair
    if mode != "train":
        return
    w = np.cos(np.arange(l, dtype=np.float32))[:, None]
    g_lam, g_bu = vjp((jnp.broadcast_to(w, bu[0].shape),
                       jnp.broadcast_to(w * w, bu[0].shape)))
    mine = [sum(o[1][k] for o in outs) for k in range(4)]
    theirs = [np.asarray(a) for a in (*g_lam, *g_bu)]
    for got, want in zip(mine, theirs):
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    assert seq_bounds(l, n, n - 1)[1] == l


def test_mesh_over_four_ranks():
    """-1 x 2 x 2 on 4 ranks is 1 x 2 x 2, row-major as the JAX package
    reshapes its devices; a 3 x 3 grid is refused on every rank; the seq
    gather of parts of 3 and 2 elements (length 5) is the concatenation,
    and its backward keeps each rank's slot."""
    outs = run_ranks(workers.mesh_rank, 4)
    for rank, o in enumerate(outs):
        assert o["shape"] == {"data": 1, "model": 2, "seq": 2}
        assert o["coords"] == {"data": 0, "model": rank // 2,
                               "seq": rank % 2}
        assert o["sizes"] == {"model": 2, "seq": 2, "data+seq": 2}
        assert o["shard"] == (1, 0)
        assert "3x3x1 != 4 ranks" in o["error"]
        np.testing.assert_array_equal(o["whole"], [0, 1, 2, 0, 1])
        i = rank % 2
        np.testing.assert_array_equal(o["rep_grad"],
                                      [1, 2, 3] if i == 0 else [4, 5])
    jmesh = jax_make_mesh(JaxMeshConfig(data=-1, model=2, seq=2))
    assert dict(jmesh.shape) == {"data": 2, "model": 2, "seq": 2}


def test_mesh_on_one_rank():
    """Without a process group the world is one rank: the trivial mesh has
    no group (no collective), and any other is refused."""
    mesh = make_mesh(MeshConfig(), device="cpu")
    assert mesh.shape == {"data": 1, "model": 1, "seq": 1}
    assert mesh.groups == {} and mesh.group("data") is None
    with pytest.raises(ValueError, match="1 ranks"):
        make_mesh(MeshConfig(data=2), device="cpu")
    assert not maybe_initialize_distributed("gloo")
    t = torch.ones(3)
    with comms.CollectiveCounter() as counter:
        comms.all_reduce(t, None)
        assert comms.gather_cat(t, None, 0) is t
    assert counter.result() == {"per_op_bytes": {}, "per_op_counts": {},
                                "total_bytes": 0}


def test_param_rules_match_jax():
    params = {"mixer": {"B": jnp.ones((8, 4, 2)), "C": jnp.ones((4, 8, 2)),
                        "C1": jnp.ones((4, 8, 2)),
                        "Lambda_re": jnp.ones((8,)),
                        "log_step": jnp.ones((8, 1)), "D": jnp.ones((4,))},
              "encoder": {"kernel": jnp.ones((4, 4))}}
    jspecs = jax_sharding(params, jax_make_mesh(
        JaxMeshConfig(data=4, model=2, seq=1)))
    named = [("mixer.B", None), ("mixer.C", None), ("mixer.C1", None),
             ("mixer.Lambda_re", None), ("mixer.log_step", None),
             ("mixer.D", None), ("encoder.weight", None)]
    ours = param_sharding(named)
    for name, dim in ours.items():
        mod, leaf = name.split(".")
        jleaf = {"weight": "kernel"}.get(leaf, leaf)
        spec = tuple(jspecs[mod][jleaf].spec)
        want = spec.index("model") if "model" in spec else None
        assert dim == want, name
    assert param_spec("['encoder']['layers_0']['mixer']['B']") == 0
    assert param_spec("encoder/layers_0/mixer/C2") == 1


def test_shard_batch_and_seq_bounds():
    class FakeMesh:
        shape = {"data": 2, "model": 1, "seq": 2}
        device = torch.device("cpu")

        def size(self, axes):
            return self.shape[axes]

        def index(self, axes):
            return {"data": 1, "seq": 1}[axes]

    spec = torch.arange(4 * 3 * 37.0).view(4, 3, 37)
    audio = torch.arange(4 * 10.0).view(4, 10)
    rows, clip = shard_batch((spec, audio), FakeMesh())
    torch.testing.assert_close(rows, spec[2:])
    torch.testing.assert_close(clip, audio[2:])
    rows, clip = shard_batch((spec, audio), FakeMesh(), time_axis_3d=-1)
    torch.testing.assert_close(rows, spec[2:, :, 19:])
    torch.testing.assert_close(clip, audio[2:])
    assert [seq_bounds(37, 2, i) for i in range(2)] == [(0, 19), (19, 37)]
    assert [seq_bounds(23, 4, i) for i in range(4)] == [
        (0, 6), (6, 12), (12, 18), (18, 23)]
    with pytest.raises(ValueError, match="divisible"):
        shard_batch((torch.zeros(3, 2),), FakeMesh())


def test_scaling_model_formula():
    """The JAX package's formula; the port's default rates are the H100
    SXM data sheet's."""
    ours = comms.scaling_efficiency_model(1e9, 1e7, hbm_gbps=819.0,
                                          nvlink_gbps=180.0)
    theirs = jax_scaling(1e9, 1e7)
    for k in theirs:
        assert ours[k] == pytest.approx(theirs[k], rel=1e-12)
    h100 = comms.scaling_efficiency_model(3.35e9, 4.5e8)
    assert h100["t_compute_s"] == pytest.approx(1e-3)
    assert h100["t_comm_s"] == pytest.approx(1e-3)
    assert h100["efficiency"] == pytest.approx(0.5)


@pytest.mark.parametrize("b,l", [(8, 3751), (32, 3751), (8, 128)])
def test_cost_accounting_matches_jax(b, l):
    """At the flagship's widths (H 192, P 128, d_io 257, 3 layers): the
    layer's FLOPs and bytes and the stack's FLOPs are the JAX package's;
    the speed of light at equal rates too."""
    ours = profiling.S5Cost.forward(b, l, 192, 128)
    theirs = jax_profiling.S5Cost.forward(b, l, 192, 128)
    assert (ours.flops, ours.hbm_bytes_fused, ours.hbm_bytes_unfused) == (
        theirs.flops, theirs.hbm_bytes_fused, theirs.hbm_bytes_unfused)
    assert ours.speed_of_light_us(820.0, 98.0) == \
        theirs.speed_of_light_us(820.0, 98.0)
    for glu in ("half1", "full", "none"):
        assert profiling.model_forward_flops(b, l, 257, 192, 128, 3, glu) \
            == jax_profiling.model_forward_flops(b, l, 257, 192, 128, 3,
                                                 glu)


def test_peaks_timer_and_memory(monkeypatch):
    """The H100's published peaks by its name; any other card raises (no
    fallback to a default); the step timer drops its warm-up steps."""
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    assert profiling.chip_peaks() == (989e12, 3.35e12)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "TPU v5 lite")
    with pytest.raises(ValueError, match="no published peaks"):
        profiling.chip_peaks()

    class Props:
        total_memory = 80 * 2 ** 30

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: Props())
    assert profiling.hbm_limit(0) == 80 * 2 ** 30
    timer = profiling.StepTimer(warmup=2)
    for _ in range(5):
        with timer:
            pass
    assert len(timer.times) == 3 and timer.mean >= 0.0
