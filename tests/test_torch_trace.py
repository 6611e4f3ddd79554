"""The port's spans (``utils/trace.py``): a no-op without a profiler,
bit-equal outputs with the profiler on and off, the named spans and their
nesting in a CPU profiler's chrome trace, and ``utils/profiling``'s
summary of a region (busy share as a union, the spans by name); the launch
ledger, and ``chip_smoke.py``'s check of a phase's launches against it."""

import dataclasses
import json
import os
import tempfile

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sparsernns_tpu_torch.ops import stft
from sparsernns_tpu_torch.serve.streaming import (ContinuousBatcher,
                                                  StreamingDenoiser)
from sparsernns_tpu_torch.train import loop
from sparsernns_tpu_torch.train.steps import (
    make_classification_train_step, make_ndns_train_step)
from sparsernns_tpu_torch.utils import profiling, trace
from sparsernns_tpu_torch.utils.config import RunConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D_IO = 257
AUDIO = 36 * 128            # 37 STFT frames


def _config(**kw) -> RunConfig:
    base = dict(n_layers=2, d_model=16, ssm_size_base=16, blocks=2,
                p_dropout=0.1, bsz=4, epochs=2)
    return dataclasses.replace(
        RunConfig().with_recipe(os.path.join(ROOT, "recipes", "ndns.json")),
        **{**base, **kw})


def _audio(batch: int, seed: int, length: int = AUDIO):
    rng = np.random.RandomState(seed)
    clean = (0.3 * rng.randn(batch, length)).astype(np.float32)
    noisy = (clean + 0.1 * rng.randn(batch, length)).astype(np.float32)
    return torch.from_numpy(noisy), torch.from_numpy(clean)


def _events(prof) -> list:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def _spans(events) -> list:
    """(name, start, end) of the program's spans, by start."""
    out = [(e["name"][len(trace.PREFIX):], float(e["ts"]),
            float(e["ts"]) + float(e.get("dur", 0.0)))
           for e in events if e.get("ph") == "X"
           and e.get("cat") == "user_annotation"
           and e["name"].startswith(trace.PREFIX)]
    return sorted(out, key=lambda s: s[1])


def _traced(fn):
    """(fn's result, the program's spans) under a CPU profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(_events(prof))


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


# ------------------------------------------------------------ off


def test_span_without_profiler_is_the_shared_no_op(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(trace, "record_function", refuse)
    assert trace.span("a") is trace.span("b")
    with trace.span("a"):
        pass

    @trace.traced("kernel.x")
    def f(a, b=1):
        return a + b

    assert f(1, b=2) == 3 and f.__name__ == "f"


def test_span_records_only_while_a_profiler_does():
    with trace.span("before"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("during"):
            torch.ones(3).sum()
    with trace.span("after"):
        pass
    assert [s[0] for s in _spans(_events(prof))] == ["during"]


# ------------------------------------------------------------ bit-equal


def _train_once(profiled: bool, microbatch=None):
    cfg = _config()
    model = loop.build_model(cfg, D_IO, D_IO, training=True, device="cpu",
                             seed=3)
    state = loop.create_run_state(cfg, model, steps_per_epoch=4)
    state.generator = torch.Generator().manual_seed(11)
    noisy, clean = _audio(4, seed=5)
    step = make_ndns_train_step(model, microbatch=microbatch)

    def run():
        return step(state, *loop.prep_ndns_batch(noisy, clean), clean)[1]

    if profiled:
        metrics, spans = _traced(run)
    else:
        metrics, spans = run(), []
    values = {f"metric/{k}": v for k, v in metrics.items()}
    values.update({f"param/{k}": v for k, v in model.state_dict().items()})
    return values, spans


def _classify_once(profiled: bool):
    """One step of a bidirectional classification model (the Path-X
    configuration's route: BatchNorm, ``complex_normal`` C, the mixer's
    B-projection, K1 both ways and C-projection), with or without a
    profiler."""
    cfg = _config(dataset="synthetic-classification", bidirectional=True,
                  C_init="complex_normal", opt_config="BfastandCdecay")
    model = loop.build_model(cfg, 1, 2, training=True, device="cpu",
                             seed=3)
    state = loop.create_run_state(cfg, model, steps_per_epoch=4)
    state.generator = torch.Generator().manual_seed(11)
    g = torch.Generator().manual_seed(5)
    x = torch.rand((4, 40, 1), generator=g) * 2 - 1
    y = torch.tensor([0, 1, 1, 0])
    step = make_classification_train_step(model)

    def run():
        return step(state, x, y)[1]

    if profiled:
        metrics, spans = _traced(run)
    else:
        metrics, spans = run(), []
    values = {f"metric/{k}": v for k, v in metrics.items()}
    values.update({f"param/{k}": v for k, v in model.state_dict().items()})
    return values, spans


def _stream_once(profiled: bool):
    model = loop.build_model(_config(n_layers=1), D_IO, D_IO, device="cpu",
                             seed=4)
    model.eval()
    den = StreamingDenoiser(model, batch_size=2)
    audio = _audio(2, seed=6, length=3000)[0].numpy()

    def run():
        return den.process(audio)

    return _traced(run) if profiled else (run(), [])


def _splitter(profiled: bool):
    audio = _audio(3, seed=7)[0]
    run = lambda: stft.stft_splitter(audio)  # noqa: E731
    return _traced(run) if profiled else (run(), [])


def _mixer(profiled: bool):
    mag, phase = stft.stft_splitter(_audio(3, seed=8)[0])
    run = lambda: stft.stft_mixer_tm(  # noqa: E731
        mag.transpose(1, 2) * 1.1, phase.transpose(1, 2))
    return _traced(run) if profiled else (run(), [])


def _flat(out) -> dict:
    if isinstance(out, dict):
        return {k: torch.as_tensor(v) for k, v in out.items()}
    if isinstance(out, (tuple, list)):
        return {str(i): torch.as_tensor(v) for i, v in enumerate(out)}
    return {"0": torch.as_tensor(out)}


@pytest.mark.parametrize("path", ["stft_splitter", "stft_mixer_tm",
                                  "train_step", "stream_process",
                                  "classify_step"])
def test_outputs_bit_equal_with_profiler_on_and_off(path):
    run = {"stft_splitter": _splitter, "stft_mixer_tm": _mixer,
           "train_step": lambda on: _train_once(on),
           "stream_process": _stream_once,
           "classify_step": _classify_once}[path]
    off, _ = run(False)
    on, spans = run(True)
    assert spans, "the profiled run recorded no span"
    off, on = _flat(off), _flat(on)
    assert off.keys() == on.keys()
    for k in off:
        assert torch.equal(off[k], on[k]), k


# ------------------------------------------------------------ spans


def _names(spans) -> list:
    return [s[0] for s in spans]


def _one(spans, name):
    found = [s for s in spans if s[0] == name]
    assert len(found) == 1, (name, _names(spans))
    return found[0]


def test_stft_spans_and_their_uploads():
    _, spans = _splitter(True)
    frames, upload, dft = (_one(spans, n) for n in
                           ("stft.frames", "stft.upload", "stft.dft"))
    assert frames[2] <= upload[1] and upload[2] <= dft[1]
    _, spans = _mixer(True)
    assert _inside(_one(spans, "istft.upload"), _one(spans, "istft.dft"))
    assert _inside(_one(spans, "istft.norm_upload"),
                   _one(spans, "istft.ola"))
    assert _one(spans, "istft.dft")[2] <= _one(spans, "istft.ola")[1]


@pytest.mark.parametrize("microbatch", [None, 2])
def test_train_step_phases_in_order(microbatch):
    _, spans = _train_once(True, microbatch)
    chunks = 1 if microbatch is None else 4 // microbatch
    fwd = [s for s in spans if s[0] == "train.forward"]
    bwd = [s for s in spans if s[0] == "train.backward"]
    assert len(fwd) == len(bwd) == chunks
    for f, b in zip(fwd, bwd):
        assert f[2] <= b[1]
    for a, b in zip(bwd, fwd[1:]):
        assert a[2] <= b[1]
    reduce, opt = _one(spans, "train.reduce"), _one(spans, "train.optimizer")
    assert bwd[-1][2] <= reduce[1] and reduce[2] <= opt[1]
    assert "train.masks" not in _names(spans)
    # the loss's iSTFT lies in the forward, the STFTs of the batch outside
    istft = [s for s in spans if s[0] == "istft.upload"]
    assert len(istft) == chunks
    assert all(any(_inside(s, f) for f in fwd) for s in istft)
    assert [s for s in spans if s[0] == "stft.upload"][-1][2] <= fwd[0][1]


def test_classification_step_phases_and_mixer_spans():
    """The step's four phases in order; in the forward, per layer, the
    mixer's B-projection, scans (both directions) and C-projection in
    order, nested in ``train.forward``; none outside it (the backward's
    kernels are autograd's)."""
    _, spans = _classify_once(True)
    fwd, bwd, reduce, opt = (_one(spans, f"train.{n}") for n in
                             ("forward", "backward", "reduce", "optimizer"))
    assert fwd[2] <= bwd[1] and bwd[2] <= reduce[1] and reduce[2] <= opt[1]
    mixer = [s for s in spans if s[0].startswith("mixer.")]
    layers = 2
    assert _names(mixer) == ["mixer.bproj", "mixer.scan",
                             "mixer.cproj"] * layers
    assert all(_inside(s, fwd) for s in mixer)
    for a, b in zip(mixer, mixer[1:]):
        assert a[2] <= b[1]


def test_mask_refresh_span_on_a_due_step():
    from sparsernns_tpu_torch.train.steps import make_mask_update_fn
    cfg = _config(pruning="iterative-ste-block-0.9")
    model = loop.build_model(cfg, D_IO, D_IO, training=True, device="cpu",
                             seed=3)
    state = loop.create_run_state(cfg, model, steps_per_epoch=4)
    update = make_mask_update_fn(state.pruner)
    p = state.pruner.cfg
    assert p.update_freq > 1
    state.step = p.update_start
    _, spans = _traced(lambda: update(state))
    assert _names(spans) == ["train.masks"]
    _, spans = _traced(lambda: update(state))     # the step after: not due
    assert spans == []


def test_stream_spans_in_one_process():
    _, spans = _stream_once(True)
    names = _names(spans)
    order = ["stream.frames", "stream.upload", "stream.forward",
             "stream.download", "stream.ola"]
    assert [n for n in names if n.startswith("stream.")] == order
    for a, b in zip(order, order[1:]):
        assert _one(spans, a)[2] <= _one(spans, b)[1]


def test_batcher_step_span():
    model = loop.build_model(_config(n_layers=1), D_IO, D_IO, device="cpu",
                             seed=4)
    model.eval()
    batcher = ContinuousBatcher(StreamingDenoiser(model, batch_size=2))
    batcher.add_stream("a")
    batcher.feed("a", _audio(1, seed=9, length=2000)[0].numpy()[0])
    _, spans = _traced(lambda: batcher.step(1000))
    batch = _one(spans, "stream.batch")
    assert all(_inside(s, batch) for s in spans if s[0] != "stream.batch")


KERNEL_WRAPPERS = [
    ("layer_tail", "layer_tail_cuda", "kernel.layer_tail"),
    ("layer_tail_bwd", "layer_tail_hist_cuda", "kernel.layer_tail_hist"),
    ("layer_tail_bwd", "layer_tail_bwd_cuda", "kernel.layer_tail_bwd"),
    ("engine_network", "engine_network_cuda", "kernel.engine_network"),
    ("engine_layer", "engine_layer_cuda", "kernel.engine_layer"),
    ("fused_s5", "fused_s5_cuda", "kernel.fused_s5"),
    ("fused_s5", "fused_s5_qat_cuda", "kernel.fused_s5_qat"),
    ("fused_s5", "fused_s5_engine_cuda", "kernel.fused_s5_engine"),
    ("diag_scan", "diag_scan_cuda", "kernel.diag_scan"),
    ("qat_scan", "qat_scan_cuda", "kernel.qat_scan"),
    ("block_sparse", "block_sparse_matmul_cuda", "kernel.block_sparse"),
    ("fxp_scan", "fxp_scan_cuda", "kernel.fxp_scan"),
]


@pytest.mark.parametrize("module,wrapper,name", KERNEL_WRAPPERS)
def test_kernel_wrapper_runs_inside_its_span(module, wrapper, name):
    import importlib
    fn = getattr(importlib.import_module(
        f"sparsernns_tpu_torch.ops.cuda.{module}"), wrapper)

    def call():
        # no arguments: the wrapper's body raises at once, inside the span
        with pytest.raises(TypeError):
            fn()

    _, spans = _traced(call)
    assert _names(spans) == [name]


def test_engine_call_span():
    from sparsernns_tpu_torch.quantize.engine import W8A16Engine

    def call():
        with pytest.raises(AttributeError):
            W8A16Engine.__call__(object(), None)

    _, spans = _traced(call)
    assert _names(spans) == ["engine.call"]


# ------------------------------------------------------------ summary


def _x(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_summarize_trace_union_self_time_and_launches():
    p = trace.PREFIX
    events = [
        _x("fill", "kernel", 0, 1, corr=1),              # before the region
        _x("cudaLaunchKernel", "cuda_runtime", -5, 1, corr=1),
        _x(p + "profile_region", "user_annotation", 10, 100),
        _x(p + "train.forward", "user_annotation", 12, 30),
        _x(p + "istft.upload", "user_annotation", 20, 10),
        _x(p + "train.backward", "user_annotation", 50, 40),
        # launched from another thread while the backward is open
        _x("cudaLaunchKernel", "cuda_runtime", 13, 1, tid=1, corr=2),
        _x("cudaLaunchKernel", "cuda_runtime", 55, 1, tid=2, corr=3),
        _x("cudaLaunchKernel", "cuda_runtime", 60, 1, tid=2, corr=4),
        _x("k_a", "kernel", 15, 10, corr=2),
        _x("k_b", "kernel", 20, 10, corr=3),             # overlaps k_a
        _x("k_b", "kernel", 70, 20, corr=4),
        _x(p + "train.forward", "gpu_user_annotation", 15, 15),
    ]
    out = profiling.summarize_trace(events, top=5)
    assert out["device_events"] == 3
    assert out["device_ms"] == pytest.approx(40e-3)
    # union 15..30 and 70..90 over the region's 100 us
    assert out["device_busy_share"] == pytest.approx(35 / 100)
    assert [k["name"] for k in out["top_kernels"]] == ["k_b", "k_a"]
    assert out["top_kernels"][0]["count"] == 2
    spans = out["spans"]
    assert set(spans) == {"train.forward", "istft.upload", "train.backward"}
    assert spans["train.forward"]["host_ms"] == pytest.approx(30e-3)
    assert spans["train.forward"]["self_ms"] == pytest.approx(20e-3)
    assert spans["istft.upload"]["self_ms"] == pytest.approx(10e-3)
    assert spans["train.forward"]["device_ms"] == pytest.approx(10e-3)
    assert spans["train.backward"]["device_ms"] == pytest.approx(30e-3)
    assert spans["istft.upload"]["device_ms"] == 0.0


def test_summarize_trace_needs_the_region_span():
    with pytest.raises(ValueError):
        profiling.summarize_trace([_x("k", "kernel", 0, 1)])


def test_launch_ledger_counts_reads_and_resets():
    """``count`` adds to a name; ``launch_counts`` returns a copy, in which
    a name never counted reads 0; ``reset=True`` zeroes the ledger after
    the copy."""
    trace.launch_counts(reset=True)
    trace.count("diag_scan")
    trace.count("diag_scan_passes", 3)
    counts = trace.launch_counts()
    assert counts == {"diag_scan": 1, "diag_scan_passes": 3}
    assert counts["fused_s5"] == 0
    counts["diag_scan"] += 5
    assert trace.launch_counts(reset=True)["diag_scan"] == 1
    assert trace.launch_counts() == {}


def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("launched,holds", [
    ({"layer_tail_train": 3, "layer_tail_hist": 3, "layer_tail_bwd": 3},
     True),
    # an expected launch that never came
    ({"layer_tail_train": 3, "layer_tail_hist": 3}, False),
    # one launch short
    ({"layer_tail_train": 3, "layer_tail_hist": 3, "layer_tail_bwd": 2},
     False),
    # a launch not expected
    ({"layer_tail_train": 3, "layer_tail_hist": 3, "layer_tail_bwd": 3,
      "diag_scan": 1}, False)])
def test_smoke_launch_check_holds_both_ways(launched, holds):
    """``chip_smoke.py`` reads the ledger with ``kernel_launches`` (K1's
    pass count left out, then the ledger zeroed) and holds a phase's
    launches with ``check_launches``, which fails on a missing launch as on
    an unexpected one."""
    cs = _chip_smoke()
    trace.launch_counts(reset=True)
    for name, n in launched.items():
        trace.count(name, n)
    trace.count("diag_scan_passes", 2)
    counts = cs.kernel_launches()
    assert "diag_scan_passes" not in counts and trace.launch_counts() == {}
    expect = dict.fromkeys(cs.TAIL_KERNELS, 3)
    if holds:
        cs.check_launches("three steps", counts, expect)
    else:
        with pytest.raises(AssertionError):
            cs.check_launches("three steps", counts, expect)
