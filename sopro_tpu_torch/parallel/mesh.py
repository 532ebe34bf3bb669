"""The device mesh for serving and batch synthesis over several cards
(counterpart: sopro_tpu/parallel/mesh.py `make_mesh`).

A `Mesh` is a [dp, tp] grid of torch devices under JAX's axis names. A
batch's rows split over `dp` in the contiguous blocks of JAX's `P("dp")`
row sharding (`row_blocks`). Inside a dp group the parameters are
replicated over `tp`, as the JAX batcher and batch plan replicate them, so
each dp group runs as one ordinary single-card engine on its rows, on the
group's first device (`replicas`). JAX's `param_shardings` rules, the `tp`
layout of training, are not ported: the port trains data-parallel over
processes (`parallel.data`).

    mesh = make_mesh(4, dp=4, tp=1)                    # cuda:0 .. cuda:3
    tts.synthesize_batch(texts, ref=ref, mesh=mesh)
    ContinuousBatcher(tts, slots=8, mesh=mesh)
    make_mesh(2, devices=[torch.device("cpu")] * 2)   # two shards on one device
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

AXES = ("dp", "tp")


@dataclass(frozen=True, eq=False)
class Mesh:
    """`devices`: a [dp, tp] object array of torch.device; one device may
    appear more than once (shards that share a card, or the CPU)."""

    devices: np.ndarray

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(AXES, (int(n) for n in self.devices.shape)))


def make_mesh(
    n_devices: Optional[int] = None,
    *,
    dp: Optional[int] = None,
    tp: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Mesh over the first n of `devices` (default: every CUDA card) with
    axes ("dp", "tp"), JAX's defaults: tp=2 when n is even and > 2, else 1;
    dp = n // tp. Raises ValueError for more devices than there are or
    dp * tp != n, and RuntimeError without a card when `devices` is not
    given."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device; pass devices= (e.g. [torch.device('cpu')] * n)"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(
            f"make_mesh: need {n} devices, have {len(devices)} ({devices[0].type}). "
            "For an N-shard mesh on one device pass devices=[device] * N."
        )
    if tp is None:
        tp = 2 if (n % 2 == 0 and n > 2) else 1
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp = {dp}*{tp} != {n}")
    grid = np.empty((dp, tp), dtype=object)
    for i, d in enumerate(devices[:n]):
        grid[i // tp, i % tp] = d
    return Mesh(grid)


def row_blocks(rows: int, dp: int) -> List[Tuple[int, int]]:
    """[lo, hi) of each dp shard's rows: shard g holds rows
    [g * rows/dp, (g+1) * rows/dp), the blocks of a `P("dp")` row sharding.
    Raises ValueError when dp does not divide `rows`."""
    if rows % dp:
        raise ValueError(f"{rows} rows do not split over dp={dp}")
    n = rows // dp
    return [(g * n, (g + 1) * n) for g in range(dp)]


def replicas(engine, mesh: Mesh) -> list:
    """One Engine per dp group, on the group's first device
    (`Engine.replica`: the engine itself on its own device, else a copy of
    its model and codec built there once)."""
    return [engine.replica(mesh.devices[g, 0]) for g in range(mesh.shape["dp"])]
