"""Parallelism (counterpart: sopro_tpu/parallel): data-parallel training over
processes, one per card (`data`: `init_process_group`, `shard_batch`,
`make_train_step`), the device mesh that serving and batch synthesis split
their rows over (`mesh`: `make_mesh`, `replicas`) with JAX's sharding rules
(`param_shardings`, `batch_sharding`, `replicated`), and the (dp, tp)
training layout on a mesh driven by one process (`tensor`:
`shard_train_state`, its `make_train_step`)."""

from sopro_tpu_torch.parallel.data import (
    all_reduce_grads, global_norm, init_process_group, make_train_step, shard_batch,
)
from sopro_tpu_torch.parallel.mesh import (
    Mesh, batch_sharding, make_mesh, param_pspec, param_shardings, replicas, replicated, row_blocks,
)
from sopro_tpu_torch.parallel.tensor import ShardedModel, shard_train_state

__all__ = [
    "Mesh", "make_mesh", "replicas", "row_blocks",
    "param_pspec", "param_shardings", "batch_sharding", "replicated",
    "ShardedModel", "shard_train_state",
    "init_process_group", "shard_batch", "global_norm", "all_reduce_grads", "make_train_step",
]
