"""The port's spans: named host intervals on the device trace's clock.

``span(name)`` marks a stretch of host work (a train step's backward, an
upload, a kernel wrapper's packing and launch). While a
``torch.profiler`` records, it is a ``record_function`` range named
``sparsernns.<name>``: it lands in the same Kineto trace as the device
operations it launches, on one clock, nested by where it opens. Otherwise
it is a shared no-op context, and its whole cost is one check of the
profiler's state (under a microsecond). There is no switch: the spans
record exactly while a profiler does, and they change no computation.

    with span("train.backward"):
        loss.backward()

    @traced("kernel.layer_tail")
    def layer_tail_cuda(...): ...

``utils/profiling.profile_region`` reads them back by name.
"""

from __future__ import annotations

import contextlib
import functools

from torch.autograd import _profiler_enabled
from torch.profiler import record_function

#: the prefix of every span's name in a trace
PREFIX = "sparsernns."

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that marks ``name`` in the trace while a profiler
    records; a shared no-op context otherwise."""
    if _profiler_enabled():
        return record_function(PREFIX + name)
    return _OFF


def traced(name: str):
    """Decorator: each call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _profiler_enabled():
                return fn(*args, **kwargs)
            with record_function(PREFIX + name):
                return fn(*args, **kwargs)
        return call
    return wrap
