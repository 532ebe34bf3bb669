"""The device mesh for serving and batch synthesis over several cards
(counterpart: sopro_tpu/parallel/mesh.py `make_mesh`).

A `Mesh` is a [dp, tp] grid of torch devices under JAX's axis names. A
batch's rows split over `dp` in the contiguous blocks of JAX's `P("dp")`
row sharding (`row_blocks`). For serving and batch synthesis the parameters
are replicated over `tp` inside a dp group, as the JAX batcher and batch
plan replicate them, so each dp group runs as one ordinary single-card
engine on its rows, on the group's first device (`replicas`).

Training's `tp` layout follows JAX's rules (`_RULES`, `param_pspec`,
`param_shardings`): a spec is a tuple of axis names or None per dimension,
as a `PartitionSpec` reads, matched against the "/"-joined paths of the
JAX-layout tree (`weights.sopro_tree`). `parallel/tensor.py` lays a model
out by them and runs the sharded train step.

    mesh = make_mesh(4, dp=4, tp=1)                    # cuda:0 .. cuda:3
    tts.synthesize_batch(texts, ref=ref, mesh=mesh)
    ContinuousBatcher(tts, slots=8, mesh=mesh)
    make_mesh(2, devices=[torch.device("cpu")] * 2)   # two shards on one device
    param_shardings(mesh, weights.sopro_tree(model))  # {"ar": {"head": {"w": ("tp", None), ...
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

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


Spec = Tuple[Optional[str], ...]

# Matched against "/"-joined tree paths: the FIRST rule that matches and whose
# axes divide the leaf's dimensions wins (a rule that does not divide falls
# through, so a pattern may appear twice with a fallback layout); no rule:
# replicated. Layouts: linear w [in, out], embeddings [rows, D]. Copied from
# the JAX package's `parallel/mesh.py`.
_RULES: Tuple[Tuple[str, Spec], ...] = (
    # FFN / GLU expansions: the wide hidden axis
    (r".*/ff1/w$", (None, "tp")),
    (r".*/ff1/b$", ("tp",)),
    (r".*/ff2/w$", ("tp", None)),
    (r".*/glu/pro/w$", (None, "tp")),
    (r".*/glu/pro/b$", ("tp",)),
    # AR head: the vocab axis; the flagship vocab (2049) is odd, so the input axis
    (r".*ar/head/w$", (None, "tp")),
    (r".*ar/head/w$", ("tp", None)),
    (r".*ar/head/b$", ("tp",)),
    # NAR per-codebook heads: the codebook-vocab axis
    (r".*heads/./\d+/w$", (None, "tp")),
    (r".*heads/./\d+/b$", ("tp",)),
    # embedding tables: rows (vocab), else the d_model axis (the fused codebook
    # table has 65537 rows at full width)
    (r".*(cb_embed|text_enc/embed|token2sv/emb)/emb$", ("tp", None)),
    (r".*(cb_embed|text_enc/embed|token2sv/emb)/emb$", (None, "tp")),
    # Mimi transformer MLPs
    (r".*/fc1/w$", (None, "tp")),
    (r".*/fc2/w$", ("tp", None)),
    # Mimi dequantisation tables: the codebook-entry rows
    (r".*quantizer/(dec_)?embed$", (None, "tp", None)),
)


def param_pspec(path: str, shape: Sequence[int], mesh: Mesh) -> Spec:
    """The spec of the leaf at `path` ("/"-joined) of shape `shape` under
    `mesh`: the first rule that matches and whose axes divide the leaf's
    dimensions, else () (replicated)."""
    sizes = mesh.shape
    for pat, spec in _RULES:
        if re.match(pat, path):
            axes = spec + (None,) * (len(shape) - len(spec))
            if all(ax is None or int(d) % sizes[ax] == 0 for d, ax in zip(shape, axes)):
                return spec
    return ()


def param_shardings(mesh: Mesh, tree: Any) -> Any:
    """The spec of every leaf of a parameter tree (dicts / lists of arrays
    or tensors, None kept) under `mesh`, in the tree's layout."""
    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, path + (str(k),)) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [walk(v, path + (str(i),)) for i, v in enumerate(t)]
        if t is None:
            return None
        return param_pspec("/".join(path), tuple(t.shape), mesh)
    return walk(tree, ())


def batch_sharding(mesh: Mesh) -> Spec:
    """Batch arrays split their leading axis over dp (`row_blocks`)."""
    return ("dp",)


def replicated(mesh: Mesh) -> Spec:
    return ()
