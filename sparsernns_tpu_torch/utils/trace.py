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

The launch ledger counts what the kernel wrappers of ``ops/cuda/`` launch,
process-wide and always on: a wrapper calls ``count(name)`` after each
call it enqueues, and a reader takes ``launch_counts()`` (``reset=True``
zeroes the ledger); a name never counted reads 0. The names: K1's calls
by the way they walk, ``diag_scan``, ``diag_scan_rev``, with the block
requant ``diag_scan_requant``, and the launches they made,
``diag_scan_passes``; K4a / K4b ``fused_s5``, ``fused_s5_engine``,
``fused_s5_engine_carry``, ``fused_s5_qat``; K2 ``layer_tail_train``, K3a
``layer_tail_hist``, K3b ``layer_tail_bwd``; K5a / K5b ``engine_layer``,
``engine_layer_carry``; K6 ``engine_network``; K7 ``block_sparse``;
``qat_scan``; ``fxp_scan``. ``bidir_buffers`` and ``bidir_unfused`` count
the bidirectional mixer's passes by route (``ops/scan.py``).
"""

from __future__ import annotations

import collections
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


_ledger: collections.Counter = collections.Counter()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the ledger's count of ``name``."""
    _ledger[name] += n


def launch_counts(reset: bool = False) -> collections.Counter:
    """A copy of the ledger (a Counter: a missing name reads 0); with
    ``reset`` the ledger is zeroed after the copy."""
    counts = collections.Counter(_ledger)
    if reset:
        _ledger.clear()
    return counts
