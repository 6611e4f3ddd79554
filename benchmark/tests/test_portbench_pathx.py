"""The Path-X configuration (``configs/s5_pathx.json``, cell
``pathx_train_b32``), added as files only: the cell at its task's small
sizes on the CPU, untraced and traced, through ``core.run_cell``; the
control, a planted fault and a reverse scan left out failing the check;
its cost counts and its readers against hand counts. On the card, the
cell at its full size."""

import time
from types import SimpleNamespace

import pytest

from benchmark.cost import pathx as cost
from benchmark.harness import core, spec
from benchmark.harness import trace as htrace
from benchmark.tests.tiny import tiny_run

CELL = "pathx_train_b32"
H100 = "NVIDIA H100 80GB HBM3"
#: the cell's per-layer metrics in the manifest's order: the training
#: cells' readers, then the three of this task
READERS = ["dispatch_ms.train", "idle_share.train", "fwd_ms.train",
           "bwd_ms.train", "opt_ms.train", "kernel_host_ms.train",
           "mfu.pathx", "k1_roofline.pathx", "mixer_fwd_ms.pathx"]
#: the readers of the program's spans
SPAN_READERS = {"fwd_ms.train", "bwd_ms.train", "opt_ms.train",
                "kernel_host_ms.train", "mixer_fwd_ms.pathx"}
FULL = cost.Shape(32, 16384, 1, 128, 128, 6, 2)


def test_the_cell_runs_untraced_and_traced():
    out = tiny_run(CELL)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"loss_gap", "grad_gap", "change_gap"}
    assert set(out["metrics"]) == {"train_clips_per_s", "step_p95_ms",
                                   "setup_s"}
    assert out["failed"] == 0
    traced = tiny_run(CELL, trace=True, seconds=0.0)
    assert traced["correct"], traced["checks"]
    # the timed stretch's one step and the traced stretch's six; the CPU
    # has no device trace, so only the host clock's reader reads
    assert traced["attempted"] == 1 + 6
    assert set(traced["metrics"]) == {"dispatch_ms.train"}


def test_the_manifest_lists_the_cell_and_its_readers():
    bench = spec.manifest()
    assert [w for w in bench["workloads"] if w["name"] == CELL] == [
        {"name": CELL, "config": "s5_pathx", "traffic": "pathx_b32",
         "chips": 1, "why": spec.cell(CELL)["why"]}]
    assert {m["name"] for m in spec.reported(bench, CELL, "end_to_end")} \
        == {"train_clips_per_s", "step_p95_ms", "setup_s"}
    assert [m["name"] for m in spec.reported(bench, CELL, "per_layer")] \
        == READERS


def test_the_control_and_a_halved_batch_fail_the_limits():
    rows = tiny_run(CELL, readings={"seeds": [7, 8, 9], "control": True,
                                    "faults": ["half_batch",
                                               "state_unchanged"]})
    limits = spec.cell(CELL)["limits"]
    for row in rows:
        assert all(v <= limits[k] for k, v in row["program"].items()), row
        for bad in ("control", "half_batch", "state_unchanged"):
            assert any(v > limits[k] for k, v in row[bad].items()), (bad,
                                                                    row)


def test_a_reverse_scan_left_out_fails_the_check(monkeypatch):
    """The program's reverse scans return zero states: the bidirectional
    mixer sees its forward direction alone."""
    from sparsernns_tpu_torch.models import ssm
    scan = ssm.diag_ssm_scan

    def forward_only(lam, bu, reverse=False, **kw):
        xs = scan(lam, bu, reverse=reverse, **kw)
        return (xs[0] * 0, xs[1] * 0) if reverse else xs

    monkeypatch.setattr(ssm, "diag_ssm_scan", forward_only)
    out = tiny_run(CELL)
    assert not out["correct"], out["checks"]


def test_cost_by_hand():
    s = cost.Shape(b=2, l=10, d_in=1, h=4, p=3, n_layers=2, classes=2)
    # per layer over 20 rows: B-projection 2*20*4*6, two scans 2*8*20*3,
    # C-projection 2*20*12*4, D / residual / norm / act 8*20*4, gate
    # 2*20*16 + 3*20*4
    layer = 960 + 960 + 1920 + 640 + 880
    assert cost.layer_forward_flops(s) == layer
    # encoder 2*20*1*4, the pool 20*4, the decoder 2*2*4*2
    assert cost.model_forward_flops(s) == 160 + 2 * layer + 80 + 32
    assert cost.k1(s) == (8 * 60, 16 * 60)
    # at full size: 0.73 TFLOP a forward, K1 a GiB a call
    assert cost.model_forward_flops(FULL) == 732627484672
    assert cost.k1(FULL).bytes == 2 ** 30


def _x(name, cat, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


#: (kernel, host launch, device start, duration) in us; one step
OPS = [("sm80_xmma_gemm_f32f32", 30, 40, 50),                   # bproj
       ("void (anonymous namespace)::k1_walk_kernel<4, 0, true>(Args)",
        150, 100, 40),                                          # scan
       ("(anonymous namespace)::k1_carry_kernel(Args)", 160, 140, 10),
       ("sm80_xmma_gemm_f32f32", 350, 360, 60),                 # cproj
       ("void at::native::vectorized_elementwise_kernel<4>", 500, 500,
        100),                                                   # forward
       ("void (anonymous namespace)::k1_walk_kernel<4, 1, true>(Args)",
        900, 900, 40),                                          # backward
       ("sm80_xmma_gemm_f32f32", 1000, 1000, 300),
       ("void at::native::multi_tensor_apply_kernel<Adam>", 1760, 1760,
        20)]                                                    # AdamW


def _events(program: bool) -> list:
    ev = [_x("bench.trace", "user_annotation", 0, 2000),
          _x("bench.train_step", "user_annotation", 5, 1900)]
    for corr, (name, host, start, dur) in enumerate(OPS, 1):
        ev += [_x("cudaLaunchKernel", "cuda_runtime", host, 4, corr,
                  tid=2 if 800 <= host <= 1700 else 1),
               _x(name, "kernel", start, dur, corr, tid=7)]
    if program:
        p = "sparsernns."
        ev += [_x(p + "train.forward", "user_annotation", 10, 790),
               _x(p + "mixer.bproj", "user_annotation", 20, 80),
               _x(p + "mixer.scan", "user_annotation", 100, 200),
               _x(p + "kernel.diag_scan", "user_annotation", 140, 30),
               _x(p + "mixer.cproj", "user_annotation", 300, 100),
               _x(p + "train.backward", "user_annotation", 800, 900),
               _x(p + "train.reduce", "user_annotation", 1700, 40),
               _x(p + "train.optimizer", "user_annotation", 1750, 50)]
    return ev


def _ctx(tr):
    return SimpleNamespace(
        cell={"mix": {"batch": 32}}, shape=FULL, ranks=1, trace=tr,
        setup_s=20.0, device_name=H100,
        window={"steps": 200, "elapsed": 33.0, "latencies": [0.165] * 200},
        timed={"steps": 10, "elapsed": 1.5, "dispatch": [0.02] * 10})


def test_the_readers_by_hand():
    ctx = _ctx(htrace.parse(_events(program=True), steps=1))
    got = {m: spec.reader(m)(ctx) for m in READERS}
    # device us launched inside each span: the forward 50+40+10+60+100,
    # the mixers 50+40+10+60, the backward (autograd's thread) 40+300,
    # AdamW 20
    assert got["fwd_ms.train"] == pytest.approx(0.260)
    assert got["mixer_fwd_ms.pathx"] == pytest.approx(0.160)
    assert got["bwd_ms.train"] == pytest.approx(0.340)
    assert got["opt_ms.train"] == pytest.approx(0.020)
    # host us inside K1's wrapper: 30
    assert got["kernel_host_ms.train"] == pytest.approx(0.030)
    # the timed stretch's mean enqueue, 20 ms
    assert got["dispatch_ms.train"] == pytest.approx(20.0)
    # busy 620 of 2000 us
    assert got["idle_share.train"] == pytest.approx(69.0)
    # 3 x 0.7326 TFLOP over 0.15 s a step against 989 TFLOP/s
    assert got["mfu.pathx"] == pytest.approx(
        3 * 732627484672 / 0.15 / 989e12 * 100)
    # K1: 90 us over 4 calls a layer of 6 layers; a GiB at 3.35 TB/s
    assert got["k1_roofline.pathx"] == pytest.approx(
        2 ** 30 / 3.35e12 / (90e-6 / 24) * 100)


def test_without_the_programs_spans_their_readers_read_nothing():
    """The parent's program opens none of these spans: its readers give
    nothing and raise nothing; the others read as before."""
    with_spans = _ctx(htrace.parse(_events(program=True), steps=1))
    without = _ctx(htrace.parse(_events(program=False), steps=1))
    for m in READERS:
        value = spec.reader(m)(without)
        if m in SPAN_READERS:
            assert value is None, m
        else:
            assert value == spec.reader(m)(with_spans), m


@pytest.mark.card
def test_the_cell_at_full_size(card):
    """The published step on the card: correct, no failed step, and in a
    traced run every reader of the cell reads, the shares in (0, 100]."""
    out = core.run_cell(CELL, 2147500011, 5.0, False, time.time())
    assert out["correct"] and out["failed"] == 0, out["checks"]
    traced = core.run_cell(CELL, 2147500012, 2.0, True, time.time())
    assert traced["correct"], traced["checks"]
    assert set(traced["metrics"]) == set(READERS)
    for share in ("mfu.pathx", "k1_roofline.pathx"):
        assert 0 < traced["metrics"][share]["value"] <= 100, share
