"""Parallelism (counterpart: sopro_tpu/parallel): data-parallel training over
processes, one per card (`data`: `init_process_group`, `shard_batch`,
`make_train_step`), and the device mesh that serving and batch synthesis
split their rows over (`mesh`: `make_mesh`, `replicas`)."""

from sopro_tpu_torch.parallel.data import (
    all_reduce_grads, global_norm, init_process_group, make_train_step, shard_batch,
)
from sopro_tpu_torch.parallel.mesh import Mesh, make_mesh, replicas, row_blocks

__all__ = [
    "Mesh", "make_mesh", "replicas", "row_blocks",
    "init_process_group", "shard_batch", "global_norm", "all_reduce_grads", "make_train_step",
]
