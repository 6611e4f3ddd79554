"""The device mesh over ``torch.distributed`` (counterpart of
``sparsernns_tpu/parallel/mesh.py``).

The JAX package runs one controller over ``jax.devices()``; here each rank
is a process of its own (``torchrun``, or any launcher that sets the
process group up) on one device, and the mesh is a (data, model, seq)
grid of the world's ranks, row-major as the JAX package reshapes its
devices: rank = (d * model + m) * seq + s. Axes:

  data  -- data parallelism over the batch rows
  model -- tensor parallelism over the SSM state dim P
  seq   -- sequence parallelism over the scan's time axis

Every rank holds one process group per axis (the ranks that differ only
along it) and one over (data, seq) together, the ranks that see other
rows or other frames of the same parameters. A group of one rank is
None: nothing is exchanged along that axis.

The backend is the caller's: ``"nccl"`` on the card, ``"gloo"`` on the
CPU (or on CUDA tensors where the caller chooses it, for all-reduce and
broadcast). Nothing here picks one, and nothing moves a tensor to another
device for a collective.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
from typing import Dict, Sequence, Tuple, Union

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
AXES = (DATA_AXIS, MODEL_AXIS, SEQ_AXIS)

#: the axis sets a rank keeps a process group for
_GROUP_AXES = ((DATA_AXIS,), (MODEL_AXIS,), (SEQ_AXIS,),
               (DATA_AXIS, SEQ_AXIS))


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data: int = -1   # -1: infer (all remaining ranks)
    model: int = 1
    seq: int = 1


def maybe_initialize_distributed(backend: str) -> bool:
    """Start the default process group from the launcher's environment
    (``torchrun`` sets ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
    ``MASTER_PORT``) with ``backend``, when those are set and no group is
    running. Returns whether a process group runs afterwards."""
    if dist.is_initialized():
        return True
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    dist.init_process_group(backend=backend)
    return True


@dataclasses.dataclass
class Mesh:
    """This rank's view of the (data, model, seq) grid."""

    shape: Dict[str, int]
    rank: int
    coords: Dict[str, int]
    device: torch.device
    groups: Dict[Tuple[str, ...], object]

    def size(self, axes: Union[str, Sequence[str]]) -> int:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        n = 1
        for a in axes:
            n *= self.shape[a]
        return n

    def index(self, axes: Union[str, Sequence[str]]) -> int:
        """This rank's position along ``axes`` (row-major over several)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, axes: Union[str, Sequence[str]]):
        """The process group of the ranks that differ from this one only
        along ``axes``; None where that is this rank alone."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return self.groups.get(axes)


def _rank_of(coords: Dict[str, int], shape: Dict[str, int]) -> int:
    return ((coords[DATA_AXIS] * shape[MODEL_AXIS] + coords[MODEL_AXIS])
            * shape[SEQ_AXIS] + coords[SEQ_AXIS])


def _device(device) -> torch.device:
    """``"cuda"``: the card of ``LOCAL_RANK`` (0 without it); ``"cpu"``;
    or a ``torch.device`` as it is."""
    if isinstance(device, torch.device):
        return device
    if device == "cuda":
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return torch.device(device)


def make_mesh(cfg: MeshConfig = MeshConfig(), device="cuda") -> Mesh:
    """The mesh of ``cfg`` over the world of the default process group (a
    world of one rank where none runs). Raises ``ValueError`` where
    data * model * seq is not the world size. Every rank of the world must
    call it, in the same order as any other group creation: it creates the
    process groups of every axis.

    ``device`` is where this rank computes: ``"cuda"`` for
    ``cuda:{LOCAL_RANK}``, ``"cpu"``, or a ``torch.device`` (two ranks may
    share one card, over a backend that allows it). A CUDA device becomes
    this process's current device."""
    running = dist.is_initialized()
    world = dist.get_world_size() if running else 1
    rank = dist.get_rank() if running else 0
    model, seq = cfg.model, cfg.seq
    data = cfg.data if cfg.data > 0 else world // (model * seq)
    if data * model * seq != world or min(data, model, seq) < 1:
        raise ValueError(f"mesh {data}x{model}x{seq} != {world} ranks")
    dev = _device(device)
    if dev.type == "cuda":
        # the kernels launch on the current device's stream, and NCCL
        # binds a group to the current device
        torch.cuda.set_device(dev)
    shape = {DATA_AXIS: data, MODEL_AXIS: model, SEQ_AXIS: seq}
    coords = {DATA_AXIS: rank // (model * seq),
              MODEL_AXIS: (rank // seq) % model, SEQ_AXIS: rank % seq}
    groups = {}
    for axes in _GROUP_AXES:
        if all(shape[a] == 1 for a in axes):
            continue
        fixed = [a for a in AXES if a not in axes]
        # every coset along ``axes``, created on every rank in one order
        for outer in itertools.product(*(range(shape[a]) for a in fixed)):
            members = []
            for inner in itertools.product(*(range(shape[a]) for a in axes)):
                c = dict(zip(fixed, outer))
                c.update(zip(axes, inner))
                members.append(_rank_of(c, shape))
            handle = dist.new_group(sorted(members))
            if rank in members:
                groups[axes] = handle
    return Mesh(shape=shape, rank=rank, coords=coords, device=dev,
                groups=groups)


def local_data_shard_info(mesh: Mesh) -> Tuple[int, int]:
    """(number of data ranks, this rank's data index): the shard of the
    dataset this rank loads. Ranks that differ only along model or seq
    load the same rows."""
    return mesh.shape[DATA_AXIS], mesh.coords[DATA_AXIS]
