"""Collectives of the parallel code, and their accounting (counterpart of
``sparsernns_tpu/parallel/comms.py``).

The JAX package reads the bytes each collective moves from the compiled
HLO. The port has no HLO: every collective of the parallel code goes
through the functions here, and each records its kind (the HLO names:
``all-reduce``, ``all-gather``, ``reduce-scatter``), the bytes of its
result and one count into every active :class:`CollectiveCounter`.
:func:`collective_bytes` runs a function under a counter and returns the
JAX package's dict
``{"per_op_bytes", "per_op_counts", "total_bytes"}``.

A gather or a reduce-scatter runs as itself on NCCL. On another backend
(gloo, whose CUDA tensors take all-reduce and broadcast only) a gather is
an all-reduce of a zero-filled buffer with one slot per rank, and a
reduce-scatter an all-reduce of the whole buffer of which each rank keeps
its slot: both exact. Either way the record is the operation's own kind
and result, as the HLO would show it.

The differentiable forms are autograd functions with a stated backward:

- :class:`AllReduceSum`: the sum over the group, whose backward is the sum
  of the gradients over the group;
- :class:`GatherReplicated`: every rank's tensor, stacked, for a consumer
  that every rank of the group runs alike (the whole weight of a
  tensor-parallel forward, the whole clip of the loss). Each rank then
  holds the whole gradient already, and summing it over the group
  (``torch.distributed.nn.functional.all_gather``'s backward) would make
  it the group's size times too large: the backward keeps this rank's
  slot and exchanges nothing.

The sequence-parallel carry combine (``seqscan.CarryCombine``), whose use
of the gathered pairs differs per rank, pairs :func:`all_gather` with
:func:`reduce_scatter` itself.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

#: the counters that record, innermost last (module-level so that the
#: autograd engine's device threads record into them too)
_ACTIVE: list = []


class CollectiveCounter:
    """Bytes and counts of the collectives issued while it is active (a
    context manager; counters nest, and each records everything issued
    inside it)."""

    def __init__(self):
        self.per_op_bytes: Dict[str, int] = {}
        self.per_op_counts: Dict[str, int] = {}

    def __enter__(self) -> "CollectiveCounter":
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.remove(self)

    def add(self, kind: str, nbytes: int) -> None:
        self.per_op_bytes[kind] = self.per_op_bytes.get(kind, 0) + nbytes
        self.per_op_counts[kind] = self.per_op_counts.get(kind, 0) + 1

    def result(self) -> Dict[str, Any]:
        return {"per_op_bytes": dict(self.per_op_bytes),
                "per_op_counts": dict(self.per_op_counts),
                "total_bytes": sum(self.per_op_bytes.values())}


def _record(kind: str, t: torch.Tensor) -> None:
    nbytes = t.numel() * t.element_size()
    for counter in _ACTIVE:
        counter.add(kind, nbytes)


def collective_bytes(fn: Callable, *args, **kw) -> Dict[str, Any]:
    """Run ``fn(*args, **kw)`` and account the collectives it issued."""
    with CollectiveCounter() as counter:
        fn(*args, **kw)
    return counter.result()


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _nccl(group) -> bool:
    return dist.get_backend(group) == "nccl"


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (nothing where it is None)."""
    if group is None:
        return t
    _record("all-reduce", t)
    dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` (of one shape on all), stacked in group-rank
    order: (n, *t.shape)."""
    n = group_size(group)
    if group is None:
        return t[None]
    t = t.contiguous()
    if _nccl(group):
        out = t.new_empty((n,) + tuple(t.shape))
        dist.all_gather_into_tensor(out, t, group=group)
    else:
        out = t.new_zeros((n,) + tuple(t.shape))
        out[group_rank(group)] = t
        dist.all_reduce(out, group=group)
    _record("all-gather", out)
    return out


def reduce_scatter(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` (n, ...) summed over the group; this rank keeps slot
    ``group_rank``."""
    if group is None:
        return t[0]
    t = t.contiguous()
    if _nccl(group):
        out = t.new_empty(t.shape[1:])
        dist.reduce_scatter_tensor(out, t, group=group)
    else:
        whole = t.clone()
        dist.all_reduce(whole, group=group)
        out = whole[group_rank(group)]
    _record("reduce-scatter", out)
    return out


def barrier(group=None) -> None:
    if dist.is_initialized():
        dist.barrier(group=group)


class AllReduceSum(torch.autograd.Function):
    """Differentiable sum over ``group``."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce(t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.group), None


class GatherReplicated(torch.autograd.Function):
    """Differentiable gather, (n, *t.shape), for a consumer that every rank
    of the group runs alike: the backward is this rank's slot of the
    gradient, and exchanges nothing."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.rank = group_rank(group)
        return all_gather(t, group)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank], None


def gather_cat(t: torch.Tensor, group, dim: int,
               length: Optional[int] = None) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in group-rank order,
    differentiable (:class:`GatherReplicated`: for a consumer that every
    rank runs alike). With ``length`` the ranks' parts may be
    shorter along ``dim`` than the first rank's (time chunks of the padded
    split, the last ones short): each part is zero-padded to
    ``ceil(length / n)`` for the exchange and the result cut to
    ``length``."""
    n = group_size(group)
    if n == 1:
        return t
    dim = dim % t.dim()
    part = t.shape[dim] if length is None else -(-length // n)
    if t.shape[dim] < part:
        pad = [0, 0] * (t.dim() - dim - 1) + [0, part - t.shape[dim]]
        t = torch.nn.functional.pad(t, pad)
    stacked = GatherReplicated.apply(t, group)     # (n, ..., part, ...)
    out = torch.cat(stacked.unbind(0), dim=dim)
    if length is not None:
        out = out.narrow(dim, 0, length)
    return out


def scaling_efficiency_model(compute_bytes: float, collective_total: float,
                             hbm_gbps: float = 3350.0,
                             nvlink_gbps: float = 450.0,
                             network_gbps: float = 50.0,
                             over: str = "nvlink") -> Dict[str, float]:
    """First-order scaling-efficiency estimate: per-card step time is
    compute (memory-bound) plus the exposed collective time over the given
    fabric. Efficiency = t_compute / (t_compute + t_comm), the share of
    linear scaling kept (no overlap assumed: a lower bound). The default
    rates are the H100 SXM data sheet's: HBM3 3.35 TB/s, NVLink 900 GB/s
    both ways (450 each way), and one 400 Gb/s network port (50 GB/s)
    between hosts."""
    speed = {"nvlink": nvlink_gbps, "network": network_gbps}[over] * 1e9
    t_compute = compute_bytes / (hbm_gbps * 1e9)
    t_comm = collective_total / speed
    eff = t_compute / (t_compute + t_comm) if t_compute > 0 else 0.0
    return {"t_compute_s": t_compute, "t_comm_s": t_comm,
            "efficiency": eff}
