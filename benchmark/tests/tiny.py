"""Runs of the benchmark's cells on the CPU at small shapes, for the
tests: the harness without its look for a card."""

#: small shapes of every cell for the CPU: the recipe's structure at
#: width 16, 8 states, 2 layers; clips of 0.2 s (26 frames); engine block 8
TINY = {"recipe": {"d_model": 16, "ssm_size_base": 16, "blocks": 2,
                   "n_layers": 2},
        "mix": {"clip_seconds": 0.2, "pool_clips": 48, "batch": 4},
        "config": {"norm_stats": {"clips": 4, "frames": 16},
                   "calibration": {"clips": 4, "slices": [[0, 10], [10, 20]]},
                   "engine": {"block_t": 8, "act_dtype": "bfloat16",
                              "route": "auto"}}}


def tiny_run(cell, seed=20260101, fault=None, root=None, trace=False,
             seconds=0.2, readings=None):
    """One run of ``cell`` on the CPU at the small shapes."""
    import time

    from benchmark.harness import core
    opts = {"device": "cpu", "sizes": TINY, "fault": fault}
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
