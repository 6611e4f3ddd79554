"""The program's own spans (``sparsernns.<name>`` ranges of
``sparsernns_tpu_torch/utils/trace.py``, on the host and, as the profiler
mirrors them, on the device) in a trace beside the benchmark's
``bench.*`` spans: ``trace.parse``, ``breakdown`` and every metric
reader give on a fixed event list exactly what they give on the same
list without them; the readers of the program's spans (``source``
``program_span``) read nothing without them."""

import glob
import os
from types import SimpleNamespace

import pytest

from benchmark.cost.model import Shape
from benchmark.harness import spec
from benchmark.harness import trace as htrace

H100 = "NVIDIA H100 80GB HBM3"
METRICS = sorted(os.path.basename(p)[:-3] for p in glob.glob(
    os.path.join(spec.HERE, "metrics", "*.py")))
PROGRAM_READERS = {m["name"] for m in spec.manifest()["per_layer"]
                   if m["source"] == "program_span"}


def _x(name, cat, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _launched(name, host, start, dur, corr, tid=1):
    return [_x("cudaLaunchKernel", "cuda_runtime", host, 4, corr, tid),
            _x(name, "kernel", start, dur, corr, tid=7)]


def _bench_events() -> list:
    """Two requests and a train step's backward on one clock (us): the
    benchmark's spans, launches, kernels, a copy and a fill."""
    ev = [_x("bench.trace", "user_annotation", 0, 2000)]
    corr = 1
    for base in (0, 1000):
        ev += [_x("bench.stft", "user_annotation", base + 10, 200),
               _x("bench.model", "user_annotation", base + 210, 300),
               _x("bench.istft", "user_annotation", base + 510, 300)]
        for name, host, start, dur in (
                ("Memcpy HtoD (Pageable -> Device)", 20, 30, 5),
                ("sm80_xmma_gemm_f32f32", 60, 70, 90),
                ("void engine::engine_row_pass_kernel<4>(RowPass)", 220,
                 240, 150),
                ("engine::engine_scan_pass_kernel(ScanPass)", 230, 400, 60),
                ("void (anonymous namespace)::layer_tail_row_kernel(A)",
                 300, 470, 30),
                ("void tail::tail_hist_bproj_kernel(float const*)", 310,
                 500, 20),
                ("(anonymous namespace)::tail_bwd_proj_kernel(B)", 320,
                 520, 40),
                ("ncclDevKernel_AllReduce_Sum_f32", 330, 560, 5),
                ("Memset (Device)", 520, 600, 2),
                ("void at::native::vectorized_elementwise_kernel<4>", 560,
                 610, 100),
                ("Memcpy HtoD (Pageable -> Device)", 720, 730, 5),
                ("void at::native::elementwise_kernel<128, 2>", 760, 780,
                 40)):
            ev += _launched(name, base + host, base + start, dur, corr)
            corr += 1
    ev.append(_x("train_step tail", "kernel", 1900, 50, None))
    ev += [_x("bench.train_step", "user_annotation", 1850, 100),
           _x("ac2g", "ac2g", 0, 0)]
    return ev


def _program_events() -> list:
    """The program's spans in the same stretch: host ranges, one on
    autograd's thread, and the device mirrors of the profiler."""
    p = "sparsernns."
    ev = []
    for base in (0, 1000):
        ev += [_x(p + "stft.frames", "user_annotation", base + 12, 8),
               _x(p + "stft.upload", "user_annotation", base + 20, 16),
               _x(p + "stft.dft", "user_annotation", base + 40, 150),
               _x(p + "engine.call", "user_annotation", base + 215, 280),
               _x(p + "kernel.engine_network", "user_annotation",
                  base + 218, 20),
               _x(p + "istft.dft", "user_annotation", base + 515, 200),
               _x(p + "istft.upload", "user_annotation", base + 700, 36),
               _x(p + "istft.ola", "user_annotation", base + 740, 60),
               _x(p + "istft.norm_upload", "user_annotation", base + 790,
                  5),
               _x(p + "engine.call", "gpu_user_annotation", base + 240,
                  220, tid=7),
               _x(p + "istft.dft", "gpu_user_annotation", base + 610, 100,
                  tid=7)]
    ev += [_x(p + "train.backward", "user_annotation", 1860, 80),
           _x(p + "kernel.layer_tail_bwd", "user_annotation", 1870, 30,
              tid=2)]
    return ev


def _ctx(tr):
    return SimpleNamespace(
        cell={"mix": {"batch": 32}}, shape=Shape(32, 3751, 257, 192, 128, 3),
        ranks=1, trace=tr, setup_s=9.5, device_name=H100,
        window={"steps": 40, "elapsed": 0.6,
                "latencies": [0.014 + 1e-4 * i for i in range(40)]},
        timed={"steps": 20, "elapsed": 0.3,
               "dispatch": [0.013 + 1e-4 * i for i in range(20)]})


@pytest.fixture(scope="module")
def traces():
    bench = _bench_events()
    return (htrace.parse(bench, steps=2),
            htrace.parse(bench + _program_events(), steps=2))


def test_parse_keeps_spans_ops_and_window(traces):
    without, with_program = traces
    assert with_program == without
    assert {s.name for s in without.spans} == {"stft", "model", "istft",
                                               "train_step"}
    assert len(without.ops) == 25 and without.window == (0.0, 2000e-6)


@pytest.mark.parametrize("metric", METRICS)
def test_every_reader_reads_the_same(traces, metric):
    without, with_program = traces
    read = spec.reader(metric)
    if metric in PROGRAM_READERS:
        assert read(_ctx(without)) is None
    else:
        assert read(_ctx(with_program)) == read(_ctx(without))


def test_the_readers_read_something(traces):
    ctx = _ctx(traces[1])
    for metric in ("stft_ms.denoise", "idle_share.denoise", "k6_roofline",
                   "k2_roofline", "k3b_roofline", "dispatch_ms.denoise"):
        value = spec.reader(metric)(ctx)
        assert value is not None and value > 0, metric


def test_breakdown_keeps_device_ops_and_gaps(traces):
    without, with_program = traces
    a, b = htrace.breakdown(without, top=40), htrace.breakdown(with_program,
                                                               top=40)
    assert a == b
    assert {n for n, _ in a["idle_gaps"]} <= {"stft", "model", "istft",
                                              "train_step", "outside",
                                              "unknown", "end"}
