"""The bidirectional mixer's buffers route (``ops/scan.py``
``BiDiagScanFn``, taken by ``models/ssm.S5SSM._apply_scan`` where
``_buffers_route`` holds) against the composition it replaces: two
``DiagScanFn`` scans, the concatenations into the (B, L, 4P) states
matrix and autograd's assembly of bu's gradient. On the CPU both run the
plain scans (K1's plain version), so the states, the matrix, ``ys`` and
bu's gradient are bit-equal, and dλ is held to float64 within float32
round-off. Shapes: ``benchmark/tasks/pathx.TINY``'s mixer (B 4, L 64, P 8)
and an odd length and width (B 3, L 37, P 5). The launch ledger's route
counts (``bidir_buffers``, ``bidir_unfused``; ``utils/trace.launch_counts``)
show which route a tiny Path-X step takes."""

import dataclasses
import json
import os

import pytest
import torch

from benchmark.tasks import pathx as task
from benchmark.traffic import synthetic_pathx
from sparsernns_tpu_torch.models.ssm import S5SSM
from sparsernns_tpu_torch.ops import scan as tscan
from sparsernns_tpu_torch.ops.cuda import diag_scan
from sparsernns_tpu_torch.train.loop import build_model, create_run_state
from sparsernns_tpu_torch.train.steps import make_classification_train_step
from sparsernns_tpu_torch.utils.config import RunConfig
from sparsernns_tpu_torch.utils.trace import launch_counts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: (name, B, L, P): the Path-X configuration's tiny mixer, an odd one
SHAPES = [("pathx_tiny", 4, 64, 8), ("odd", 3, 37, 5)]


def _lam(p: int, g: torch.Generator):
    radius = 0.55 + 0.44 * torch.rand(p, generator=g)
    angle = (torch.rand(p, generator=g) - 0.5) * 6.0
    return radius * torch.cos(angle), radius * torch.sin(angle)


def _unfused(lam_re, lam_im, bu_cat):
    """The replaced composition: both scans, then the concatenations in
    ``_apply_scan``'s order."""
    p = bu_cat.shape[-1] // 2
    bu = (bu_cat[..., :p], bu_cat[..., p:])
    fwd = tscan.diag_ssm_scan((lam_re, lam_im), bu)
    rev = tscan.diag_ssm_scan((lam_re, lam_im), bu, reverse=True)
    xs = (torch.cat([fwd[0], rev[0]], dim=-1),
          torch.cat([fwd[1], rev[1]], dim=-1))
    return torch.cat([xs[0], xs[1]], dim=-1)


def _run(fn, lam, bu_cat, g):
    leaves = [lam[0].clone().requires_grad_(True),
              lam[1].clone().requires_grad_(True),
              bu_cat.clone().requires_grad_(True)]
    out = fn(*leaves)
    out.backward(g)
    return out.detach(), [t.grad for t in leaves]


def _dlam64(lam, bu_cat, g):
    """dλ of both directions in float64: each adjoint's v (the float32
    plain scan the route runs) against the float32 states, summed in
    float64; and the sum of the terms' magnitudes, the scale of float32
    round-off."""
    p = bu_cat.shape[-1] // 2
    bu = (bu_cat[..., :p], bu_cat[..., p:])
    conj = (lam[0], -lam[1])
    d = torch.zeros(2, p, dtype=torch.float64)
    mag = torch.zeros(2, p, dtype=torch.float64)
    for k, reverse in enumerate((False, True)):
        xs = diag_scan.diag_scan_plain(lam, bu, reverse=reverse)
        gk = (g[..., k * p:(k + 1) * p], g[..., (k + 2) * p:(k + 3) * p])
        v = diag_scan.diag_scan_plain(conj, gk, reverse=not reverse)
        v64 = tuple(t.double() for t in v)
        x64 = tuple(t.double() for t in xs)
        d += torch.stack(tscan._dlam(v64, x64, reverse))
        va = tuple(t.abs() for t in v64)
        mag[0] += tscan._dlam(va, tuple(t.abs() for t in x64), reverse)[0]
        mag[1] += tscan._dlam(va, (x64[0].abs(), -x64[1].abs()), reverse)[1]
    return d, mag


@pytest.mark.parametrize("name,b,l,p", SHAPES)
def test_buffers_function_is_the_unfused_composition(name, b, l, p):
    """The states matrix and bu_cat's gradient bit for bit; dλ within
    float32 round-off of float64 (1e-5 of the sum of its terms'
    magnitudes: a sum of B·L float32 products rounds far below)."""
    g = torch.Generator().manual_seed(b * 1000 + l)
    lam = _lam(p, g)
    bu_cat = torch.randn((b, l, 2 * p), generator=g)
    cot = torch.randn((b, l, 4 * p), generator=g)
    want, (_, _, want_bu) = _run(_unfused, lam, bu_cat, cot)
    got, (d_re, d_im, got_bu) = _run(tscan.BiDiagScanFn.apply, lam, bu_cat,
                                     cot)
    assert got.shape == (b, l, 4 * p) and got.is_contiguous()
    assert torch.equal(got, want)
    assert torch.equal(got_bu, want_bu)
    ref, mag = _dlam64(lam, bu_cat, cot)
    gap = (torch.stack([d_re, d_im]).double() - ref).abs()
    assert bool((gap <= 1e-5 * mag).all()), float((gap / mag).max())


@pytest.mark.parametrize("name,b,l,p", SHAPES)
def test_mixer_route_is_bit_equal_to_the_unfused_route(name, b, l, p,
                                                       monkeypatch):
    """A bidirectional ``complex_normal`` mixer (H 16) on both routes:
    ``ys``, the states and the gradients of u, B, C and D bit for bit (bu's
    gradient reaches each of them), the λ leaves' within round-off."""
    from sparsernns_tpu_torch.models.ssm_init import blocked_dplr_init
    init = blocked_dplr_init(2 * p, 1, True)
    g = torch.Generator().manual_seed(7 + l)
    mixer = S5SSM(init["Lambda"], init["V"], init["Vinv"], h=16,
                  p=init["P"], c_init="complex_normal", clip_eigs=True,
                  bidirectional=True, generator=g)
    u = torch.randn((b, l, 16), generator=g)
    cot = torch.randn((b, l, 16), generator=g)

    def run():
        mixer.zero_grad()
        x = u.clone().requires_grad_(True)
        ys, states = mixer(x)
        ys.backward(cot)
        grads = {n: q.grad.clone() for n, q in mixer.named_parameters()}
        return ys.detach(), [s.detach() for s in states], x.grad, grads

    before = launch_counts()
    new = run()
    after = launch_counts()
    assert after["bidir_buffers"] - before["bidir_buffers"] == 2
    assert after["bidir_unfused"] == before["bidir_unfused"]
    monkeypatch.setattr(S5SSM, "_buffers_route", lambda self, c, b: False)
    old = run()
    assert launch_counts()["bidir_unfused"] == after["bidir_unfused"] + 1
    assert torch.equal(new[0], old[0])
    assert all(torch.equal(a, c) for a, c in zip(new[1], old[1]))
    assert torch.equal(new[2], old[2])
    for n in ("B", "C", "D"):
        assert torch.equal(new[3][n], old[3][n]), n
    for n in ("Lambda_re", "Lambda_im", "log_step"):
        torch.testing.assert_close(new[3][n], old[3][n], rtol=1e-5,
                                   atol=1e-6)


def _pathx_tiny(**over):
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "s5_pathx.json")) as f:
        conf = json.load(f)
    conf["recipe"] = {**conf["recipe"], **task.TINY["recipe"]}
    recipe = task.recipe_of(conf)
    with open(os.path.join(ROOT, "benchmark", "traffic",
                           "pathx_b32.json")) as f:
        mix = {**json.load(f), **task.TINY["mix"]}
    inputs, labels = synthetic_pathx.make_pool(mix, 5, torch.device("cpu"))
    cfg = dataclasses.replace(RunConfig(), **recipe, **over)
    torch.manual_seed(5)
    model = build_model(cfg, 1, 2, training=True, device="cpu")
    return (cfg, model, inputs[:mix["batch"]], labels[:mix["batch"]],
            recipe["n_layers"])


@pytest.mark.parametrize("over,route", [
    ({}, "buffers"),
    ({"relufication": True}, "unfused"),
    ({"quantization": "w8a16"}, "unfused"),
])
def test_a_tiny_pathx_step_takes_its_route(over, route):
    """A tiny Path-X train step: the float model runs every layer's mixer
    on the buffers route, forward and backward (2 x n_layers); relufied
    and QAT bidirectional mixers keep the two scans (n_layers forwards)."""
    cfg, model, x, y, n_layers = _pathx_tiny(**over)
    state = create_run_state(cfg, model, 1)
    step = make_classification_train_step(model)
    before = launch_counts()
    _, metrics = step(state, x, y)
    after = launch_counts()
    assert torch.isfinite(metrics["loss"])
    moved = {k: after[f"bidir_{k}"] - before[f"bidir_{k}"]
             for k in ("buffers", "unfused")}
    want = 2 * n_layers if route == "buffers" else n_layers
    other = "unfused" if route == "buffers" else "buffers"
    assert moved == {route: want, other: 0}


def test_scan_options_refuse_what_they_cannot_do():
    """``accumulate`` needs ``out``; the block requant takes no ``out``; on
    the CPU ``out`` takes the plain states, and the adjoint's v copied or
    added, its dλ ``_dlam``'s."""
    g = torch.Generator().manual_seed(3)
    lam = _lam(4, g)
    bu = (torch.randn((2, 9, 4), generator=g),
          torch.randn((2, 9, 4), generator=g))
    xs = diag_scan.diag_scan_plain(lam, bu, reverse=True)
    with pytest.raises(ValueError, match="accumulate"):
        diag_scan.diag_scan_adjoint(lam, bu, xs, True, accumulate=True)
    with pytest.raises(ValueError, match="requant"):
        diag_scan.diag_scan_cuda(lam, bu, block_requant=(0.5, 0.5, 8),
                                 block_t=4, out=bu)
    buf = torch.ones((2, 9, 8))
    out = (buf[..., :4], buf[..., 4:])
    got = diag_scan.diag_scan(lam, bu, reverse=True, out=out)
    assert got[0].data_ptr() == buf.data_ptr()
    assert torch.equal(buf, torch.cat(xs, dim=-1))
    v = diag_scan.diag_scan_plain((lam[0], -lam[1]), bu)
    got, d = diag_scan.diag_scan_adjoint(lam, bu, xs, True, out=out,
                                         accumulate=True)
    assert got[0].data_ptr() == buf.data_ptr()
    assert torch.equal(buf, torch.cat(xs, dim=-1) + torch.cat(v, dim=-1))
    want = tscan._dlam(v, xs, True)
    assert all(torch.equal(a, w) for a, w in zip(d, want))


#: one tiny run of the Path-X cell with the buffers route's reverse column
#: blocks zeroed, in a fresh interpreter (the harness refuses a process
#: that holds JAX, as this test process does): prints the result and the
#: ledger's count of buffers passes
_FORWARD_ONLY = """
import json
import torch
from benchmark.tests.tiny import tiny_run
from sparsernns_tpu_torch.models import ssm
from sparsernns_tpu_torch.utils.trace import launch_counts
both = ssm.BiDiagScanFn

class ForwardOnly:
    @staticmethod
    def apply(lam_re, lam_im, bu_cat):
        buf = both.apply(lam_re, lam_im, bu_cat)
        p = bu_cat.shape[-1] // 2
        keep = torch.ones(4 * p, dtype=buf.dtype)
        keep[p:2 * p] = 0
        keep[3 * p:] = 0
        return buf * keep

ssm.BiDiagScanFn = ForwardOnly
out = tiny_run("pathx_train_b32")
print(json.dumps({"correct": out["correct"], "checks": out["checks"],
                  "buffers": launch_counts()["bidir_buffers"]}))
"""


def test_a_reverse_scan_left_out_fails_the_pathx_check():
    """The buffers route's reverse column blocks zeroed, so that the
    bidirectional mixer sees its forward direction alone: the Path-X
    cell's check (``pathx_train_b32`` at its small sizes on the CPU, held
    against its plain reference) is not correct. The ledger's route count
    shows that the fault reached the program."""
    import subprocess
    import sys
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    done = subprocess.run([sys.executable, "-c", _FORWARD_ONLY], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    out = json.loads(done.stdout.strip().splitlines()[-1])
    assert out["buffers"] > 0
    assert not out["correct"], out["checks"]
