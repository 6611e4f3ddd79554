"""The device trace of a bounded stretch of a run, and what the metric
readers take from it.

``torch.profiler`` traces the host and the card over the stretch; the
chrome trace it exports (to the run's ``TMPDIR``, deleted once read, a few
MB) gives the device operations (kernels, copies, fills) with their start
and length on the card, the host's launches that made them (linked by
CUPTI's correlation id), the benchmark's own spans
(``torch.profiler.record_function("bench.<name>")``) on the host, and the
program's spans (``sparsernns.<name>``, opened by the program's
``utils/trace.span`` while a profiler records). All times are on one
clock, in seconds.

The program's spans are kept apart (``Trace.program``): the benchmark's
spans alone label idle gaps (:func:`host_span_at`) and feed
:func:`ops_in_spans`, and two traces compare equal where their
operations, benchmark spans, window and steps do. Readers of the
program's spans take them through :func:`span_host_seconds` and
:func:`span_device_seconds`.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import json
import os
import tempfile
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "bench."
#: the prefix of the program's spans (``sparsernns_tpu_torch/utils/trace``)
PROGRAM_PREFIX = "sparsernns."


class Op(NamedTuple):
    name: str
    start: float
    dur: float
    launch: Optional[float]      # host time of the launch that made it


class Span(NamedTuple):
    name: str
    start: float
    end: float


@dataclasses.dataclass(frozen=True)
class Trace:
    ops: List[Op]                # device operations in the window
    spans: List[Span]            # the benchmark's spans
    window: Tuple[float, float]  # the traced stretch on the host clock
    steps: int                   # steps or requests in the stretch
    #: the program's host spans in the window, any thread, by start
    program: List[Span] = dataclasses.field(default_factory=list,
                                            compare=False)


def parse(events: List[dict], steps: int) -> Trace:
    launches: Dict[int, float] = {}
    spans, ops, program = [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e["ts"]) * 1e-6, float(e.get("dur", 0.0)) * 1e-6
        corr = (e.get("args") or {}).get("correlation")
        if cat in ("cuda_runtime", "cuda_driver") and corr is not None:
            launches[corr] = ts
        elif cat == "user_annotation" and e["name"].startswith(SPAN_PREFIX):
            spans.append(Span(e["name"][len(SPAN_PREFIX):], ts, ts + dur))
        elif cat == "user_annotation" and e["name"].startswith(
                PROGRAM_PREFIX):
            program.append(Span(e["name"][len(PROGRAM_PREFIX):], ts,
                                ts + dur))
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            corr = (e.get("args") or {}).get("correlation")
            ops.append(Op(e["name"], float(e["ts"]) * 1e-6,
                          float(e.get("dur", 0.0)) * 1e-6,
                          launches.get(corr)))
    outer = [s for s in spans if s.name == "trace"]
    if not outer:
        raise RuntimeError("the trace holds no bench.trace span")
    w0, w1 = outer[0].start, outer[0].end
    ops = [o for o in ops if o.start >= w0 and o.start + o.dur <= w1]
    ops.sort(key=lambda o: o.start)
    program = sorted((s for s in program if w0 <= s.start <= w1),
                     key=lambda s: s.start)
    return Trace(ops, [s for s in spans if s.name != "trace"], (w0, w1),
                 steps, program)


def record(fn, steps: int) -> Trace:
    """Run ``fn`` (the stretch: ``steps`` steps, each ending on a device
    synchronize) under the profiler inside a ``bench.trace`` span."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # the profiler records no device event for the first kernel of a
        # window: a fill outside the stretch takes that place
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        with record_function(SPAN_PREFIX + "trace"):
            fn()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return parse(events, steps)


def _union(intervals) -> List[Tuple[float, float]]:
    """The union of (start, end) intervals, in order."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def busy_intervals(ops: List[Op]) -> List[Tuple[float, float]]:
    """The union of the operations' intervals, in order."""
    return _union((o.start, o.start + o.dur) for o in ops)


def busy_seconds(tr: Trace) -> float:
    return sum(e - s for s, e in busy_intervals(tr.ops))


def host_span_at(tr: Trace, t: Optional[float]) -> str:
    """The innermost benchmark span the host was in at ``t``."""
    if t is None:
        return "unknown"
    inside = [s for s in tr.spans if s.start <= t <= s.end]
    if not inside:
        return "outside"
    return min(inside, key=lambda s: s.end - s.start).name


def idle_gaps(tr: Trace) -> List[Tuple[str, float]]:
    """Every stretch of the window with no device operation, longest
    first, labelled by the span the host was in when it launched the
    operation that ended the gap (the window's end: "end")."""
    busy = busy_intervals(tr.ops)
    starts = {}
    for o in tr.ops:
        starts.setdefault(o.start, o)
    gaps, t = [], tr.window[0]
    for s, e in busy:
        if s > t:
            gaps.append((host_span_at(tr, starts[s].launch), s - t))
        t = max(t, e)
    if tr.window[1] > t:
        gaps.append(("end", tr.window[1] - t))
    return sorted(gaps, key=lambda g: -g[1])


def device_ops_by_name(tr: Trace) -> List[Tuple[str, float]]:
    total: Dict[str, float] = {}
    for o in tr.ops:
        total[o.name] = total.get(o.name, 0.0) + o.dur
    return sorted(total.items(), key=lambda kv: -kv[1])


def base_name(name: str) -> str:
    """A kernel's function name without return type, namespaces, template
    arguments or parameters:
    ``void (anonymous namespace)::f<4>((anonymous namespace)::Args)``
    and ``ns::f(Args)`` -> ``f``."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0].split("<")[0].strip().split("::")[-1]


def ops_seconds(tr: Trace, pred) -> float:
    """Device seconds of the operations whose base name satisfies
    ``pred``."""
    return sum(o.dur for o in tr.ops if pred(base_name(o.name)))


def _launched_in(tr: Trace, intervals) -> float:
    """Device seconds of the operations launched inside ``intervals``."""
    return sum(o.dur for o in tr.ops if o.launch is not None and any(
        s <= o.launch <= e for s, e in intervals))


def ops_in_spans(tr: Trace, names) -> float:
    """Device seconds of the operations launched inside spans ``names``."""
    return _launched_in(tr, [(s.start, s.end) for s in tr.spans
                             if s.name in names])


Patterns = Union[str, Tuple[str, ...]]


def _program_intervals(tr: Trace, patterns: Patterns
                       ) -> List[Tuple[float, float]]:
    """The union, in order, of the program's spans whose name matches
    ``patterns``: a name (``"train.forward"``) or an ``fnmatch`` pattern
    (``"kernel.*"``, ``"*upload"``), or a tuple of them. Nested or
    overlapping spans, also of other threads, count once."""
    if isinstance(patterns, str):
        patterns = (patterns,)
    return _union((s.start, s.end) for s in tr.program
                  if any(fnmatch.fnmatchcase(s.name, p) for p in patterns))


def span_host_seconds(tr: Trace, patterns: Patterns) -> float:
    """Host seconds the traced stretch spent inside the program's spans
    that match ``patterns`` (:func:`_program_intervals`)."""
    return sum(e - s for s, e in _program_intervals(tr, patterns))


def span_device_seconds(tr: Trace, patterns: Patterns) -> float:
    """Device seconds of the operations launched while a program span that
    matches ``patterns`` was open (by each operation's launch time, from
    any thread: the backward's kernels are launched from autograd's)."""
    return _launched_in(tr, _program_intervals(tr, patterns))


def breakdown(tr: Trace, top: int = 10) -> dict:
    return {"device_ops": [[n[:120], d] for n, d in
                           device_ops_by_name(tr)[:top]],
            "idle_gaps": [[n, d] for n, d in idle_gaps(tr)[:top]]}
