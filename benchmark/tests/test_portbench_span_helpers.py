"""The two readers' helpers of the program's spans, against hand counts on
hand-made events: ``span_host_seconds`` (the union of the matching spans,
nested or on other threads counted once) and ``span_device_seconds`` (the
operations launched while one was open, by launch time); and the seven
readers of ``BENCHMARK.json`` whose source is the program's spans."""

from types import SimpleNamespace

import pytest

from benchmark.harness import spec
from benchmark.harness import trace as htrace

US = 1e-6


def _x(name, cat, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _events() -> list:
    """Two steps' worth on one clock (us), the window 0..1000."""
    p = "sparsernns."
    ev = [_x("bench.trace", "user_annotation", 0, 1000),
          # forward 100..290, the kernel wrappers inside nested
          _x(p + "train.forward", "user_annotation", 100, 190),
          _x(p + "kernel.layer_tail", "user_annotation", 150, 100),
          _x(p + "kernel.diag_scan", "user_annotation", 170, 30),
          # backward 300..500; a wrapper on autograd's thread overlaps one
          # on the main thread
          _x(p + "train.backward", "user_annotation", 300, 200),
          _x(p + "kernel.layer_tail_bwd", "user_annotation", 320, 40, tid=2),
          _x(p + "kernel.layer_tail_hist", "user_annotation", 340, 40),
          # an optimizer span that launches nothing
          _x(p + "train.optimizer", "user_annotation", 800, 50),
          # uploads
          _x(p + "stft.upload", "user_annotation", 20, 16),
          _x(p + "istft.upload", "user_annotation", 700, 36),
          _x(p + "istft.norm_upload", "user_annotation", 790, 5),
          # the profiler's device mirror of a span, and a span after the
          # window: neither is a host span of the stretch
          _x(p + "train.forward", "gpu_user_annotation", 400, 300, tid=7),
          _x(p + "kernel.late", "user_annotation", 1100, 50)]
    corr = 1
    for name, host, start, dur, tid in (
            ("fwd_kernel", 120, 400, 50, 1),     # inside forward
            ("fwd_kernel2", 200, 700, 30, 1),    # inside forward, nested
            ("edge_kernel", 290, 460, 7, 1),     # at forward's end
            ("gap_kernel", 291, 600, 10, 1),     # just after forward
            ("bwd_kernel", 330, 500, 80, 2),     # backward, other thread
            ("copy", 900, 910, 5, 1)):           # outside every span
        ev += [_x("cudaLaunchKernel", "cuda_runtime", host, 4, corr, tid),
               _x(name, "kernel", start, dur, corr, tid=7)]
        corr += 1
    return ev


@pytest.fixture(scope="module")
def tr():
    return htrace.parse(_events(), steps=2)


def test_parse_keeps_the_host_spans_of_the_window_apart(tr):
    assert [s.name for s in tr.program] == [
        "stft.upload", "train.forward", "kernel.layer_tail",
        "kernel.diag_scan", "train.backward", "kernel.layer_tail_bwd",
        "kernel.layer_tail_hist", "istft.upload", "istft.norm_upload",
        "train.optimizer"]
    assert tr.spans == [] and len(tr.ops) == 6


@pytest.mark.parametrize("patterns,us", [
    ("train.forward", 190),
    ("kernel.*", 100 + 60),            # nested once; two threads' union
    ("*upload", 16 + 36 + 5),
    (("train.forward", "train.backward"), 190 + 200),
    ("train.optimizer", 50),
    ("serve.*", 0),
])
def test_span_host_seconds(tr, patterns, us):
    assert htrace.span_host_seconds(tr, patterns) == pytest.approx(us * US)


@pytest.mark.parametrize("patterns,us", [
    ("train.forward", 50 + 30 + 7),    # the launch at its end counts
    ("kernel.diag_scan", 30),          # launched inside the nested span
    ("train.backward", 80),            # launched from autograd's thread
    ("train.optimizer", 0),            # a span with no operation
    ("train.*", 50 + 30 + 7 + 80),     # the one just outside counts not
])
def test_span_device_seconds(tr, patterns, us):
    assert htrace.span_device_seconds(tr, patterns) == pytest.approx(us * US)


@pytest.mark.parametrize("metric,ms", [
    ("fwd_ms.train", 87e-3 / 2),
    ("bwd_ms.train", 80e-3 / 2),
    ("opt_ms.train", None),            # nothing to read: no value
    ("h2d_wait_ms.train", 57e-3 / 2),
    ("h2d_wait_ms.denoise", 57e-3 / 2),
    ("kernel_host_ms.train", 160e-3 / 2),
    ("kernel_host_ms.denoise", 160e-3 / 2),
])
def test_the_program_span_readers(tr, metric, ms):
    m = next(m for m in spec.manifest()["per_layer"] if m["name"] == metric)
    assert m["source"] == "program_span" and m["unit"] == "ms"
    value = spec.reader(metric)(SimpleNamespace(trace=tr))
    assert value == (None if ms is None else pytest.approx(ms))
    assert spec.reader(metric)(SimpleNamespace(trace=None)) is None
