"""Data parallelism for training over several processes, one per card
(counterpart: sopro_tpu/parallel/mesh.py with train.shard_train_state).

The JAX package shards the batch over a mesh's `dp` axis and lets GSPMD
insert the collectives, so its loss over a sharded batch is the global
masked mean. Here each process holds the whole model and its rows of the
batch (`shard_batch`); the step divides each loss term by its count summed
over every rank, and sums the gradients with one all-reduce, so every rank
takes the step of the global batch, whatever number of valid frames each
rank's rows hold. (An average of per-rank means, as DDP's gradient
averaging gives, is another loss whenever the ranks' counts differ.)

JAX's `tp` axis is a layout of the same numerics; the 135M-parameter model
fits whole on one card, and it is not ported.

    dev = init_process_group(rank, world, "tcp://localhost:29500")   # or "env://" under torchrun
    model = SoproTTS.from_random(device=dev).engine.model            # the same weights on every rank
    opt = train.make_optimizer(model)
    step = make_train_step(model, opt)
    metrics = step(shard_batch(batch, rank, world).to(dev))
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

from sopro_tpu_torch import train as T
from sopro_tpu_torch.models.sopro import SoproModel

_METRICS = ("loss", "ar_loss", "nar_loss")


def init_process_group(rank: int, world_size: int, init_method: str = "env://",
                       device="cuda") -> torch.device:
    """Join the process group as `rank` of `world_size` and return this
    rank's device: `cuda:<rank mod cards>` over NCCL, or the CPU over gloo
    when the caller asks for device="cpu"."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' requested but no CUDA device is available")
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"unsupported device {dev}")
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size)
    return dev


def shard_batch(batch: T.TrainBatch, rank: int, world_size: int) -> T.TrainBatch:
    """Rank `rank`'s rows of `batch`: the contiguous block of B / world_size
    rows the JAX package's `dp` sharding gives that device."""
    b = int(batch.frames.shape[0])
    if b % world_size:
        raise ValueError(f"batch of {b} rows does not split over {world_size} ranks")
    n = b // world_size
    return T.TrainBatch(*(x[rank * n:(rank + 1) * n] for x in batch))


def global_norm(batch: T.TrainBatch) -> T.LossNorm:
    """The loss counts of `batch` summed over every rank."""
    counts = torch.stack(list(T.loss_norm(batch)))
    dist.all_reduce(counts)
    return T.LossNorm(*counts)


def all_reduce_grads(params) -> None:
    """Sum every parameter's gradient over the ranks, in one all-reduce."""
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat)
    offset = 0
    for p in params:
        n = p.grad.numel()
        p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
        offset += n


def make_train_step(model: SoproModel, optimizer: torch.optim.Optimizer):
    """-> step(local_batch) -> metrics of the global batch: `train`'s step
    over this rank's rows, with the loss normalised by the global counts
    and the gradients summed over the ranks before the optimizer step."""

    def step(local_batch: T.TrainBatch) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad(set_to_none=False)
        loss, metrics = T.loss_fn(model, local_batch, global_norm(local_batch))
        loss.backward()
        all_reduce_grads(T.fill_missing_grads(optimizer))
        optimizer.step()
        model.weights_changed()
        values = torch.stack([metrics[k].detach() for k in _METRICS])
        dist.all_reduce(values)
        return dict(zip(_METRICS, values))

    return step
