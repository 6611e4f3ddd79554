"""Runs of the benchmark's cells on the CPU at small shapes, for the
tests: the harness without its look for a card. The small shapes are the
``TINY`` of the cell's configuration's task (``benchmark/tasks/<task>.py``)."""

import os


def _bench_dir(root=None):
    from benchmark.harness.spec import HERE
    return HERE if root is None else os.path.join(root, "benchmark")


def tiny_sizes(cell, root=None):
    """The ``TINY`` of ``cell``'s task, in the checkout at ``root``."""
    from benchmark.harness import spec
    bench_dir = _bench_dir(root)
    task = spec.cell(cell, bench_dir)["config_data"]["task"]
    return spec.task(task, bench_dir).TINY


def tiny_cell(cell, root=None):
    """``cell``'s files with its task's small shapes laid over them."""
    from benchmark.harness import core, spec
    return core._overlay(spec.cell(cell, _bench_dir(root)),
                         tiny_sizes(cell, root))


def tiny_run(cell, seed=20260101, fault=None, root=None, trace=False,
             seconds=0.2, readings=None):
    """One run of ``cell`` on the CPU at the small shapes."""
    import time

    from benchmark.harness import core
    opts = {"device": "cpu", "sizes": tiny_sizes(cell, root), "fault": fault}
    if root is not None:
        opts["root"] = root
    if readings is not None:
        opts["readings"] = readings
    return core.run_cell(cell, seed, seconds, trace, time.time(), opts)


def tiny_run_isolated(cell, **kw):
    """:func:`tiny_run` in a fresh interpreter: a cell of several ranks
    starts and ends a process group, which a test process keeps no
    second time."""
    import json
    import subprocess
    import sys

    from benchmark.harness.spec import ROOT
    code = ("import json, sys; from benchmark.tests.tiny import tiny_run; "
            f"print(json.dumps(tiny_run({cell!r}, **{kw!r})))")
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    if done.returncode != 0:
        raise RuntimeError(done.stderr[-4000:])
    return json.loads(done.stdout.strip().splitlines()[-1])
