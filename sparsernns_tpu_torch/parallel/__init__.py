"""The device mesh over ``torch.distributed`` (counterpart of
``sparsernns_tpu/parallel``): one process per rank, a (data, model, seq)
grid of ranks with a process group per axis (``mesh.py``); every
collective through counted functions (``comms.py``); the parameter and
batch layout of tensor, data and sequence parallelism (``sharding.py``);
the sequence-parallel scan (``seqscan.py``); and the data-, sequence-,
tensor- and pipeline-parallel serving of the engine (``sp_engine.py``,
``pp_engine.py``)."""

from sparsernns_tpu_torch.parallel.mesh import (Mesh, MeshConfig,
                                                local_data_shard_info,
                                                make_mesh,
                                                maybe_initialize_distributed)
from sparsernns_tpu_torch.parallel.sharding import (param_sharding,
                                                    shard_batch,
                                                    shard_train_state)

__all__ = [
    "Mesh", "MeshConfig", "make_mesh", "local_data_shard_info",
    "maybe_initialize_distributed", "param_sharding", "shard_batch",
    "shard_train_state",
]
