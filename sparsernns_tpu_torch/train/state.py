"""TrainState: what one training run carries from step to step (counterpart
of ``sparsernns_tpu/train/state.py``).

The JAX state is an immutable pytree of parameters, optimizer state, batch
statistics and pruning masks; here the model and the optimizer own their
tensors and are updated in place, so the state holds references: the model
(parameters and BatchNorm running statistics), the optimizer (moments and
schedules), the count of optimizer steps taken, the generator that the
dropout masks are drawn from, and with pruning the pruner and its masks
(``train/pruning.py``: a dict keyed by the JAX leaf paths, updated in
place), else None. ``mesh`` is the device mesh of a parallel run
(``parallel/sharding.shard_train_state`` records it), else None.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from sparsernns_tpu_torch.train.pruning import MagnitudePruner, Masks


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    generator: Optional[torch.Generator] = None
    masks: Optional[Masks] = None
    pruner: Optional[MagnitudePruner] = None
    mesh: Optional[Any] = None


def count_params(model: torch.nn.Module) -> int:
    """Number of trainable scalars."""
    return sum(p.numel() for p in model.parameters() if p.requires_grad)
