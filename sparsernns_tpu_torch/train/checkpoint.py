"""Checkpoints of a training run over ``torch.save`` / ``torch.load``
(counterpart of ``sparsernns_tpu/train/checkpoint.py``
``CheckpointManager`` and ``ArtifactStore``).

One file per saved step, ``ckpt_<step>.pt``, holding the model's
``state_dict`` (parameters and BatchNorm running statistics), the
optimizer's ``state_dict`` (moments, schedules, live learning rates), the
count of optimizer steps, the dropout generator's state (on a mesh every
rank's), the pruning masks
(None without pruning) and a metadata dict. The format is the port's own;
:func:`~sparsernns_tpu_torch.weights.from_flax` and ``to_flax`` remain the
bridge to the JAX package's checkpoints. Files are written whole under a
temporary name and renamed, and read with ``weights_only=True`` (tensors
and plain containers only).

:class:`ArtifactStore` keeps the conversion pipeline's artifacts (frozen
parameters and statistics, activation dumps, finetuned parameters) in the
same way: one file per named item, ``<name>.pt``, holding a nested dict of
numpy arrays or tensors. The JAX package writes orbax items there, which
the port does not read.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from sparsernns_tpu_torch.train.state import TrainState

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")
_SCHEDULE_KEYS = ("schedule", "total_steps", "warmup_steps", "lr_min", "clip")


class CheckpointManager:
    """Keeps the latest ``max_to_keep`` checkpoints of ``directory``."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}.pt")

    def all_steps(self) -> List[int]:
        found = (_NAME.match(f) for f in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState,
             metadata: Optional[Dict[str, Any]] = None) -> None:
        """On a mesh (``state.mesh``) every rank calls it: the P-sharded
        parameters, masks and moments are gathered whole, so are the
        ranks' generator states (``generators``, in rank order; rank 0's
        is ``generator`` as on one device), rank 0 writes and the others
        wait, so the file restores into a run on one device."""
        from sparsernns_tpu_torch.parallel.comms import barrier
        from sparsernns_tpu_torch.parallel.sharding import (
            whole_model, whole_optimizer_state)
        gen = state.generator
        mesh = state.mesh
        optimizer = whole_optimizer_state(state)
        gens = (None if mesh is None or gen is None
                else _gather_generator_states(gen, mesh.device))
        with whole_model(state):
            payload = {
                "model": state.model.state_dict(),
                "optimizer": optimizer,
                "step": int(state.step),
                "generator": None if gen is None else gen.get_state(),
                "generators": gens,
                "masks": state.masks,
                "metadata": dict(metadata or {}),
            }
            if mesh is None or mesh.rank == 0:
                _save_whole(payload, self._path(step))
                for old in self.all_steps()[:-self.max_to_keep]:
                    os.remove(self._path(old))
        if mesh is not None:
            barrier()

    def _load(self, state: TrainState, step: Optional[int]):
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        device = next(state.model.parameters()).device
        return torch.load(self._path(step), map_location=device,
                          weights_only=True)

    def restore(self, state: TrainState, step: Optional[int] = None,
                mesh=None) -> Tuple[TrainState, Optional[Dict[str, Any]]]:
        """Load checkpoint ``step`` (default: the latest) into ``state``, in
        place. Returns (state, metadata); (state, None) when the directory
        holds no checkpoint. On a ``mesh`` (the state still whole) each
        rank takes its own generator state where the checkpoint holds one
        per rank of a world of this size; else the saved one, which a data
        rank other than the first reseeds from that state, the step and its
        data index, so that the data ranks draw other masks."""
        payload = self._load(state, step)
        if payload is None:
            return state, None
        _restore_model(state, payload)
        # the shape of the schedule belongs to the run's configuration (a
        # resumed run may have more epochs); moments and the live learning
        # rates come from the checkpoint
        keep = [{k: g[k] for k in _SCHEDULE_KEYS if k in g}
                for g in state.optimizer.param_groups]
        state.optimizer.load_state_dict(payload["optimizer"])
        for group, fields in zip(state.optimizer.param_groups, keep):
            group.update(fields)
        state.step = int(payload["step"])
        if state.generator is not None and payload["generator"] is not None:
            _restore_generator(state.generator, payload, mesh)
        return state, payload["metadata"]

    def restore_params_only(self, state: TrainState,
                            step: Optional[int] = None) -> TrainState:
        """Restore the parameters, BatchNorm statistics and masks and leave
        the optimizer, the step count and the generator as they are: a
        fresh optimizer on trained weights."""
        payload = self._load(state, step)
        if payload is not None:
            _restore_model(state, payload)
        return state


def _gather_generator_states(gen: torch.Generator,
                             device: torch.device) -> torch.Tensor:
    """Every rank's generator state (a byte tensor, of one size on all
    ranks), stacked in rank order, on the host for the file. The gather
    runs on the mesh's device, as the backend takes it."""
    import torch.distributed as dist

    from sparsernns_tpu_torch.parallel import comms
    mine = gen.get_state().to(device=device, dtype=torch.int32)
    group = dist.group.WORLD if dist.get_world_size() > 1 else None
    return comms.all_gather(mine, group).to(torch.uint8).cpu()


def _restore_generator(gen: torch.Generator, payload: Dict[str, Any],
                       mesh) -> None:
    """This rank's generator state from the checkpoint
    (:meth:`CheckpointManager.restore`)."""
    from sparsernns_tpu_torch.parallel.mesh import AXES, DATA_AXIS
    if mesh is None:
        gen.set_state(payload["generator"].cpu())
        return
    gens = payload.get("generators")
    if gens is not None and gens.shape[0] == mesh.size(AXES):
        # a copy: ``set_state`` reads a view from its storage's start
        gen.set_state(gens[mesh.rank].cpu().clone())
        return
    gen.set_state(payload["generator"].cpu())
    data_index = mesh.coords[DATA_AXIS]
    if data_index > 0:
        saved = payload["generator"].cpu().numpy().astype(np.uint32)
        gen.manual_seed(int(np.random.SeedSequence(
            [int(payload["step"]), data_index, *saved.tolist()]
        ).generate_state(1)[0]))


def _restore_model(state: TrainState, payload: Dict[str, Any]) -> None:
    """The model's tensors and, where both the run and the checkpoint have
    them, the masks, in place (the dict object stays, so an eval step that
    holds it sees the restored masks). A checkpoint without masks leaves the
    run's as they are."""
    state.model.load_state_dict(payload["model"])
    saved = payload.get("masks")
    if state.masks is not None and saved is not None:
        for key, mask in saved.items():
            state.masks[key] = mask


def _save_whole(payload: Any, path: str) -> None:
    """``torch.save`` under a temporary name, then renamed over ``path``:
    a reader never sees half a file."""
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _to_tensors(tree: Any) -> Any:
    """Nested dicts with numpy leaves -> the same with tensor leaves
    (``weights_only`` loading takes tensors and plain containers; numpy
    arrays of any dtype go through ``torch.from_numpy`` unchanged)."""
    if isinstance(tree, dict):
        return {k: _to_tensors(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) or np.isscalar(tree):
        return {"__numpy__": torch.from_numpy(np.array(tree))}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    raise TypeError(f"artifact leaf of type {type(tree).__name__}: nested "
                    "dicts of numpy arrays or tensors only")


def _from_tensors(tree: Any) -> Any:
    if isinstance(tree, dict):
        if set(tree) == {"__numpy__"}:
            return tree["__numpy__"].numpy()
        return {k: _from_tensors(v) for k, v in tree.items()}
    return tree


class ArtifactStore:
    """Named conversion artifacts under ``directory`` (the pipeline's
    ``<checkpoint_dir>/conversion``): nested dicts whose leaves are numpy
    arrays or tensors, each item one ``<name>.pt`` file. A numpy leaf loads
    back as a numpy array of the same dtype and shape, a tensor leaf as a
    CPU tensor."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, f"{name}.pt")

    def save(self, name: str, tree: Dict[str, Any]) -> None:
        os.makedirs(self.directory, exist_ok=True)
        _save_whole(_to_tensors(tree), self._path(name))

    def load(self, name: str) -> Dict[str, Any]:
        return _from_tensors(torch.load(self._path(name), map_location="cpu",
                                        weights_only=True))

    def exists(self, name: str) -> bool:
        return os.path.exists(self._path(name))
