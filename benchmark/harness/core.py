"""One run of one cell: set-up, the measured window (or, with ``trace``,
a timed stretch and a traced one), the check against the reference, and
the result's line.

Every rank of a cell runs :func:`run_rank`; rank 0 runs in the process
that prints the line, the others in processes it spawns
(:func:`run_cell`), joined by ``torch.distributed`` (NCCL on the cards,
gloo on the CPU) and by a gloo group of their own that agrees, after each
step, on whether the window has closed.
"""

from __future__ import annotations

import dataclasses
import math
import os
import sys
import time
import traceback
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np

from benchmark.harness import spec
from benchmark.harness.faults import Faults

#: seconds of the timed stretch of a traced run (``mfu``, dispatch)
TIMED_SECONDS = 4.0
#: steps the schedule holds (the window wraps around past them)
SCHEDULE_STEPS = 8192
FORBIDDEN = ("jax", "jaxlib", "flax", "sparsernns_tpu")


class Failure(Exception):
    """A run that ends without a result."""


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the benchmark may not load:
    JAX and the JAX package, compared whole."""
    top = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(top & set(FORBIDDEN))


@dataclasses.dataclass
class Ctx:
    """What a rank's entry and the check see of the run: the cell, its
    configuration and mix, and what the configuration's task made for it
    (``benchmark/tasks/<task>.py``)."""

    seed: int
    rank: int
    ranks: int
    device: object
    cell: dict
    config: dict
    mix: dict
    shape: object
    weights: Dict[str, object]
    #: the task's pool, by name (rows first), which ``schedule`` indexes
    data: Dict[str, object]
    schedule: object
    calibration_inputs: list
    faults: Faults
    mesh: object = None


def _overlay(cell: dict, sizes: Optional[dict]) -> dict:
    """The cell with ``sizes`` ({"recipe": {...}, "mix": {...},
    "config": {...}}) laid over its configuration and mix: the tests'
    small shapes. A benchmark run passes none."""
    if not sizes:
        return cell
    cell = dict(cell)
    conf = dict(cell["config_data"])
    if "recipe" in sizes:
        conf["recipe"] = {**conf["recipe"], **sizes["recipe"]}
    conf.update(sizes.get("config", {}))
    cell["config_data"] = conf
    cell["mix"] = {**cell["mix"], **sizes.get("mix", {})}
    return cell


def prepare(cell: dict, seed: int, device, rank: int, ranks: int,
            faults: Faults, mesh=None, bench_dir: str = spec.HERE) -> Ctx:
    """Inputs and weights of the run, made on ``device`` from ``seed`` by
    the configuration's task and the mix's generator, each found by name
    in ``bench_dir``: the same on every rank."""
    import torch

    conf, mix = cell["config_data"], cell["mix"]
    if mix.get("ranks", 1) != ranks:
        raise ValueError(f"mix {cell['traffic']} has {mix.get('ranks', 1)} "
                         f"ranks, the cell {ranks}")
    gen = spec.generator(mix["generator"], bench_dir)
    made = spec.task(conf["task"], bench_dir).prepare(cell, seed, device, gen)
    sched = torch.as_tensor(gen.schedule(mix, seed, SCHEDULE_STEPS),
                            device=device)
    return Ctx(seed, rank, ranks, device, cell, conf, mix, made.shape,
               made.weights, made.data, sched, made.calibration_inputs,
               faults, mesh)


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _window(runner, ctx: Ctx, seconds: float, first: int, agree,
            min_steps: int = 0) -> dict:
    """Closed loop: step after step, each ended by a synchronize, until
    ``seconds`` have passed (and ``min_steps`` ran)."""
    lat, disp = [], []
    i = first
    _sync(ctx.device)
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        runner.step(i % SCHEDULE_STEPS)
        td = time.perf_counter()
        _sync(ctx.device)
        te = time.perf_counter()
        lat.append(te - ts)
        disp.append(td - ts)
        i += 1
        done = te - t0 >= seconds and i - first >= min_steps
        if agree(done):
            break
    return dict(latencies=lat, dispatch=disp, elapsed=te - t0,
                steps=i - first, next=i)


def run_rank(cell_name: str, seed: int, seconds: float, trace: bool,
             rank: int, ranks: int, t_start: float, opts: dict) -> dict:
    """One rank of a run. Returns, on rank 0, the result's line with the
    check's numbers; elsewhere what rank 0 gathers."""
    import torch

    from benchmark.harness import trace as tracing
    device_kind = opts.get("device", "cuda")
    root = opts.get("root", spec.ROOT)
    bench_dir = os.path.join(root, "benchmark")
    cell = _overlay(spec.cell(cell_name, bench_dir), opts.get("sizes"))
    faults = Faults(opts.get("fault"))
    faults.apply_rank(rank)
    mesh = control = None
    if device_kind == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    if ranks > 1:
        import torch.distributed as dist

        from sparsernns_tpu_torch.parallel.mesh import MeshConfig, make_mesh

        mesh = make_mesh(MeshConfig(data=ranks), device=device)
        control = dist.new_group(backend="gloo")

    def agree(done: bool) -> bool:
        if control is None:
            return done
        import torch.distributed as dist
        flag = torch.tensor([int(done)])
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=control)
        return bool(flag.item())

    def gather(obj):
        if control is None:
            return [obj]
        import torch.distributed as dist
        out = [None] * ranks
        dist.all_gather_object(out, obj, group=control)
        return out

    if "readings" in opts:
        return _readings(cell, opts["readings"], bench_dir, device, rank,
                         ranks, mesh, agree, gather)
    ctx = prepare(cell, seed, device, rank, ranks, faults, mesh,
                  bench_dir)
    entry = spec.entry(cell["entry"], bench_dir)
    runner = entry.Runner(ctx)
    runner.setup()
    runner.bad.zero_()
    first, min_steps = runner.first_step, runner.min_steps
    _sync(device)
    setup_s = time.time() - t_start
    if trace:
        timed = _window(runner, ctx, min(seconds, TIMED_SECONDS), first,
                        agree, min_steps)
        n = runner.traced_steps
        start = timed["next"]

        def stretch():
            for i in range(start, start + n):
                runner.step(i % SCHEDULE_STEPS)
                _sync(device)

        if device_kind == "cuda":
            tr = tracing.record(stretch, n)
        else:
            stretch()
            tr = None
        win = timed
    else:
        win = _window(runner, ctx, seconds, first, agree, min_steps)
        timed = tr = None
    mem = (torch.cuda.max_memory_allocated(device) if device_kind == "cuda"
           else 0)
    failed = runner.failed()
    busy = (tracing.busy_seconds(tr), tr.window[1] - tr.window[0]) \
        if tr is not None else None
    gathered = gather((mem, busy, failed))
    runner.release()
    faults.undo()
    numbers = entry.check(runner) if rank == 0 else None
    # each rank's look, once the window has closed and after rank 0's check
    loaded = gather(forbidden_modules())
    if rank != 0:
        return {}
    found = {r: names for r, names in enumerate(loaded) if names}
    if found:
        raise Failure("modules of JAX or the JAX package loaded, by rank: "
                      + "; ".join(f"rank {r}: {names}"
                                  for r, names in found.items()))
    bench = spec.manifest(root)
    section = "per_layer" if trace else "end_to_end"
    # what a metric reader (``benchmark/metrics/<name>.py``) takes
    mctx = SimpleNamespace(
        cell=cell, shape=ctx.shape, ranks=ranks, window=win, timed=timed,
        trace=tr, setup_s=setup_s,
        device_name=(torch.cuda.get_device_name(device)
                     if device_kind == "cuda" else "cpu"))
    metrics = {}
    for m in spec.reported(bench, cell_name, section):
        value = spec.reader(m["name"], bench_dir)(mctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    limits = cell["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = all(math.isfinite(v) and v <= limits[k]
                  for k, v in numbers.items())
    steps = win["steps"] + (runner.traced_steps if trace else 0)
    dev = {"platform": "gpu" if device_kind == "cuda" else "cpu",
           "kind": mctx.device_name, "count": ranks,
           "memory_peak_bytes": max(g[0] for g in gathered)}
    out = {"correct": bool(correct), "attempted": steps,
           "failed": sum(g[2] for g in gathered), "metrics": metrics,
           "device": dev}
    if tr is not None:
        dev["busy_s"] = float(np.mean([g[1][0] for g in gathered]))
        dev["window_s"] = float(np.mean([g[1][1] for g in gathered]))
        out["breakdown"] = tracing.breakdown(tr)
    out["checks"] = checks
    return out


def _readings(cell: dict, how: dict, bench_dir: str, device, rank: int,
              ranks: int, mesh, agree, gather) -> list:
    """The check's numbers of the program, of the control and of planted
    faults, seed after seed in one process, with no measured window (a
    denoise cell runs the requests its check samples): the readings its
    limits are set from (``benchmark/checks/readings.py``)."""
    entry = spec.entry(cell["entry"], bench_dir)
    out = []
    for seed in how["seeds"]:
        row = {"seed": seed}
        for fault in [None] + list(how.get("faults", ())):
            faults = Faults(fault)
            ctx = prepare(cell, seed, device, rank, ranks, faults, mesh,
                          bench_dir)
            runner = entry.Runner(ctx)
            runner.setup()
            if runner.min_steps:
                _window(runner, ctx, 0.0, 0, agree, runner.min_steps)
            _sync(device)
            runner.release()
            faults.undo()
            if rank == 0:
                row["program" if fault is None else fault] = \
                    entry.check(runner)
                if fault is None and getattr(runner, "left_out", None):
                    row["left_out"] = runner.left_out
                if fault is None and how.get("control"):
                    row["control"] = entry.check(runner, "control")
            gather(None)
            del ctx, runner
        out.append(row)
    return out


def _rank_main(rank: int, ranks: int, port: int, args: tuple) -> None:
    """A spawned rank (1 .. ranks - 1)."""
    import torch.distributed as dist
    cell_name, seed, seconds, trace, t_start, opts = args
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(ranks),
                      LOCAL_RANK=str(rank))
    backend = "nccl" if opts.get("device", "cuda") == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=ranks)
    try:
        run_rank(cell_name, seed, seconds, trace, rank, ranks, t_start, opts)
    finally:
        dist.destroy_process_group()


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             t_start: float, opts: Optional[dict] = None) -> dict:
    """Every rank of the cell; returns rank 0's result. Raises
    :class:`Failure` where a rank fails or holds a forbidden module once
    the window has closed (each rank looks in :func:`run_rank`; rank 0
    looks again here, after the metric readers)."""
    opts = dict(opts or {})
    ranks = spec.cell(cell_name, os.path.join(
        opts.get("root", spec.ROOT), "benchmark"))["chips"]
    if ranks == 1:
        out = run_rank(cell_name, seed, seconds, trace, 0, 1, t_start, opts)
    else:
        out = _run_ranks(cell_name, seed, seconds, trace, t_start, opts,
                         ranks)
    found = forbidden_modules()
    if found:
        raise Failure(f"modules of JAX or the JAX package loaded: {found}")
    return out


def _run_ranks(cell_name, seed, seconds, trace, t_start, opts, ranks):
    import multiprocessing as mp
    import socket

    import torch.distributed as dist
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mpc = mp.get_context("spawn")
    args = (cell_name, seed, seconds, trace, t_start, opts)
    procs = [mpc.Process(target=_rank_main, args=(r, ranks, port, args))
             for r in range(1, ranks)]
    for p in procs:
        p.start()
    os.environ.update(RANK="0", WORLD_SIZE=str(ranks), LOCAL_RANK="0")
    backend = "nccl" if opts.get("device", "cuda") == "cuda" else "gloo"
    try:
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:"
                                f"{port}", rank=0, world_size=ranks)
        try:
            out = run_rank(cell_name, seed, seconds, trace, 0, ranks,
                           t_start, opts)
        finally:
            dist.destroy_process_group()
    except BaseException:
        for p in procs:
            p.kill()
        raise
    finally:
        for p in procs:
            p.join(timeout=120)
            if p.is_alive():
                p.kill()
                p.join()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise Failure(f"ranks exited with {bad}")
    return out


def seed_ok(seed: int) -> int:
    if seed < 0:
        raise ValueError("--seed is a whole number >= 0")
    return seed


def describe_failure(exc: BaseException) -> str:
    return "".join(traceback.format_exception(exc))
