"""Run a function on a world of ranks started here: one spawned process a
rank, joined into a process group over ``tcp://127.0.0.1`` with the
caller's backend. A stand-in for ``torchrun`` where one program drives a
small world itself (the tests on the CPU over gloo, the chip check's
ranks that share one card).

``target(rank, world, *args)`` must be a top-level function of a module
that the spawned processes can import; what it returns is pickled back
(tensors with their data).
"""

from __future__ import annotations

import os
import pickle
import queue
import socket
import time
import traceback
from typing import Any, Callable, List, Sequence


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(rank: int, world: int, backend: str, port: int,
            threads: int, target: Callable, args: Sequence, out) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(threads)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    try:
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:"
                                f"{port}", rank=rank, world_size=world)
        try:
            # pickled here, whole: the queue's own pickler would hand CPU
            # tensors over as shared memory, which ends with this process
            out.put((rank, True, pickle.dumps(target(rank, world, *args))))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which raises
        out.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(target: Callable, world: int, args: Sequence = (),
              backend: str = "gloo", timeout: float = 300.0,
              threads: int = 1) -> List[Any]:
    """``target(rank, world, *args)`` on ``world`` spawned ranks; returns
    their results in rank order. Raises ``RuntimeError`` with the
    traceback of a rank that failed, or after ``timeout`` seconds; every
    process is ended before it returns."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_worker, daemon=True,
                         args=(r, world, backend, port, threads, target,
                               tuple(args), out))
             for r in range(world)]
    for p in procs:
        p.start()
    results: dict = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world:
            try:
                rank, ok, value = out.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    raise RuntimeError(f"ranks {dead} exited without a "
                                       "result") from None
                if time.monotonic() > deadline:
                    raise RuntimeError(f"ranks timed out after {timeout} "
                                       f"s; done: {sorted(results)}"
                                       ) from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            results[rank] = pickle.loads(value)
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world)]
