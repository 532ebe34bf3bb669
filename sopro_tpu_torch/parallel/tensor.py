"""The (dp, tp) layout of training on a mesh (counterpart:
sopro_tpu/train.py `shard_train_state`, `restore_train_checkpoint(mesh=)`
and the `param_shardings` rules of sopro_tpu/parallel/mesh.py).

One process drives every device of the mesh, as JAX's single controller
does. `shard_train_state` lays a `SoproModel` out by the rules
(`parallel.mesh.param_pspec`): each tp shard of a sharded leaf is its own
`nn.Parameter` on `mesh.devices[0, t]`, a replicated leaf one `nn.Parameter`
on `mesh.devices[0, 0]`. These are the master copies. In the step, dp group
g reads them onto its devices `mesh.devices[g, :]` (`.to()`, a no-op on the
same device) and runs `train.loss_fn` on its rows (`row_blocks` order), with
the loss terms divided by the counts of the whole batch. Autograd carries
each group's gradients back through the moves, so the masters' gradients are
the sums over the groups; one AdamW step then updates the masters. The
optimizer's moments are kept per parameter, hence per shard: each is the
slice of the whole leaf's moment (AdamW is elementwise).

Inside a dp group the wide products compute on their shards (`ops/tp.py`):
the SSMLite FFN (ff1 column-parallel, ff2 row-parallel, one sum), the GLU
(column-parallel, each shard holding its block of both halves, so the gate
is formed per shard), the NAR heads (vocab-parallel, with a vocab-parallel
cross-entropy), the AR head (vocab-parallel where the rules split its
vocab, else row-parallel on d_model with the partial logits summed), and
the embedding lookups (row-split tables: each shard's rows, summed;
column-split: concatenated). Everything else is replicated and runs on the
group's first device: the norms, the depthwise convs, the attention
projections, the speaker and stage adapters, the NAR `pre` projection and
the sampler-free loss arithmetic.

A GLU leaf whose halves do not split over tp is replicated (the JAX rules
only ask that the whole width divides). A mesh of CUDA devices runs every
shard on its card or raises; nothing moves to the CPU. Training refuses a
bfloat16 model, as `train.make_train_step` does. With `parallel.data`'s
process group, each process drives its own mesh on its rows and the step
sums counts and gradients over the processes: processes x an in-process
(dp, tp) mesh.

    mesh = make_mesh(2, dp=1, tp=2, devices=[torch.device("cuda", 0)] * 2)
    state, opt = shard_train_state(mesh, model, train.make_optimizer(model))
    step = make_train_step(state, opt)
    metrics = step(batch)                        # the whole batch, any device
    train.save_train_checkpoint(path, state, opt, step=1)   # the unsharded file format
    state.to_model(model)                        # the trained weights back, for serving
"""

from __future__ import annotations

import inspect
import re
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from sopro_tpu_torch import train as T
from sopro_tpu_torch.models.base import tree_map
from sopro_tpu_torch.models.sopro import _SUBMODULES, SoproModel
from sopro_tpu_torch.models.speaker import speaker_film, token2sv
from sopro_tpu_torch.models.text import text_encoder
from sopro_tpu_torch.ops.tp import Shards
from sopro_tpu_torch.parallel.data import _METRICS, all_reduce_grads, global_norm
from sopro_tpu_torch.parallel.mesh import Mesh, param_pspec, row_blocks

_GLU = re.compile(r".*/glu/pro/[wb]$")


@dataclass(frozen=True)
class LeafLayout:
    """Where one leaf lives: its `SoproModel` parameter name, its "/"-joined
    tree path, its shape, its spec under the mesh, the axis it is split on
    (None: replicated) and whether it is a GLU projection (each shard then
    holds its block of both halves, [a_t | b_t])."""

    name: str
    path: str
    shape: Tuple[int, ...]
    spec: tuple
    dim: Optional[int]
    halves: bool

    def split(self, full: torch.Tensor, tp: int) -> List[torch.Tensor]:
        """The whole leaf (or a tensor of its shape) -> its parts: tp of
        them, or the leaf itself where it is replicated."""
        if self.dim is None:
            return [full]
        if self.halves:
            a, b = torch.chunk(full, 2, dim=-1)
            return [torch.cat([x, y], dim=-1)
                    for x, y in zip(torch.chunk(a, tp, dim=-1), torch.chunk(b, tp, dim=-1))]
        return [p.clone() for p in torch.chunk(full, tp, dim=self.dim)]

    def join(self, parts: List[torch.Tensor]) -> torch.Tensor:
        """The inverse of `split`, a new tensor (parts: the masters, their
        gradients or moments)."""
        if self.dim is None:
            return parts[0].clone()
        if self.halves:
            n = int(parts[0].shape[-1]) // 2
            return torch.cat([torch.cat([p[..., :n] for p in parts], dim=-1),
                              torch.cat([p[..., n:] for p in parts], dim=-1)], dim=-1)
        return torch.cat(parts, dim=self.dim)


def _path_tree(model: SoproModel) -> Tuple[dict, List[Tuple[str, str]]]:
    """-> (the model's parameter tree, the layout `weights.sopro_tree`
    gives, with each leaf replaced by its "/"-joined path; (parameter name,
    path) of every leaf in `model.named_parameters()` order)."""
    paths: Dict[str, str] = {}

    def walk(t, prefix, path):
        if isinstance(t, dict):
            return {k: walk(v, prefix, path + (str(k),)) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [walk(v, prefix, path + (str(i),)) for i, v in enumerate(t)]
        if t is None:
            return None
        paths[f"{prefix}.{t}"] = "/".join(path)
        return paths[f"{prefix}.{t}"]

    tree = {k: walk(v, "shared", (k,)) for k, v in model.shared._skeleton.items()}
    for name in _SUBMODULES:
        tree[name] = walk(getattr(model, name)._skeleton, name, (name,))
    return tree, [(n, paths[n]) for n, _ in model.named_parameters()]


def leaf_layout(name: str, path: str, shape, mesh: Mesh) -> LeafLayout:
    spec = param_pspec(path, shape, mesh)
    dim = next((i for i, ax in enumerate(spec) if ax == "tp"), None)
    halves = bool(_GLU.match(path))
    if dim is not None and halves and (int(shape[-1]) // 2) % mesh.shape["tp"]:
        dim = None
    return LeafLayout(name, path, tuple(int(d) for d in shape), spec, dim, halves)


def _check_mesh(mesh: Mesh) -> None:
    """Raise unless the mesh is all CUDA devices that exist, or all CPU."""
    kinds = {d.type for d in mesh.devices.flat}
    if len(kinds) != 1 or kinds - {"cuda", "cpu"}:
        raise ValueError(f"a training mesh is all CUDA or all CPU devices, not {sorted(kinds)}")
    if "cuda" in kinds:
        if not torch.cuda.is_available():
            raise RuntimeError("the mesh names CUDA devices but no CUDA device is available")
        n = torch.cuda.device_count()
        missing = sorted({str(d) for d in mesh.devices.flat if (d.index or 0) >= n})
        if missing:
            raise RuntimeError(f"the mesh names {missing}; {n} CUDA device(s) are present")


class _Group:
    """A dp group's view of the state: the interface `train.loss_fn` reads
    of a `SoproModel`, over a tree whose sharded leaves are `Shards`."""

    def __init__(self, tree, cfg):
        self.cfg, self.tree = cfg, tree
        self.shared = SimpleNamespace(p={k: v for k, v in tree.items() if k not in _SUBMODULES})
        self.ar = SimpleNamespace(p=tree["ar"])
        self.nar = SimpleNamespace(p=tree["nar"])

    def text_enc(self, text_ids, mask):
        return text_encoder(self.tree["text_enc"], self.cfg, text_ids, mask)

    def token2sv(self, tokens_btq, mask=None):
        return token2sv(self.tree["token2sv"], tokens_btq, self.cfg.codebook_size, mask=mask)

    def spk_film(self, base_btd, spk_bd, strength=1.0):
        return speaker_film(self.tree["spk_film"], base_btd, spk_bd, strength)


def _moment(lay: LeafLayout, v) -> bool:
    """True for a per-element optimizer tensor of a sharded leaf (a moment),
    False for a scalar such as AdamW's step count."""
    return lay.dim is not None and torch.is_tensor(v) and v.dim() > 0


class ShardedModel(nn.Module):
    """A `SoproModel`'s parameters laid out on a (dp, tp) mesh (module
    docstring). `layouts` lists every leaf in the model's parameter order,
    `leaves[path]` its master parameters (tp parts, or one)."""

    def __init__(self, mesh: Mesh, model: SoproModel):
        super().__init__()
        self.mesh, self.cfg = mesh, model.cfg
        tp = mesh.shape["tp"]
        params = dict(model.named_parameters())
        self.layouts: List[LeafLayout] = []
        self.leaves: Dict[str, List[nn.Parameter]] = {}
        self._skeleton, names = _path_tree(model)
        for name, path in names:
            full = params[name].detach()
            lay = leaf_layout(name, path, full.shape, mesh)
            key = name.replace(".", "__")
            self.leaves[path] = []
            for t, x in enumerate(lay.split(full, tp)):
                p = nn.Parameter(x.to(mesh.devices[0, t], copy=True).contiguous())
                self.register_parameter(key if lay.dim is None else f"{key}__tp{t}", p)
                self.leaves[path].append(p)
            self.layouts.append(lay)

    def group(self, g: int) -> _Group:
        """dp group g's view: replicated leaves on its first device, sharded
        leaves as `Shards` on its devices, all read from the masters."""
        devs = self.mesh.devices[g]
        dims = {lay.path: lay.dim for lay in self.layouts}

        def leaf(path):
            ps = self.leaves[path]
            if dims[path] is None:
                return ps[0].to(devs[0])
            return Shards([p.to(devs[t]) for t, p in enumerate(ps)], dims[path])

        return _Group(tree_map(leaf, self._skeleton), self.cfg)

    @torch.no_grad()
    def full_leaves(self, device="cpu") -> Dict[str, torch.Tensor]:
        """{parameter name: the whole leaf on `device`}."""
        return {lay.name: lay.join([p.detach().to(device) for p in self.leaves[lay.path]])
                for lay in self.layouts}

    @torch.no_grad()
    def to_model(self, model: SoproModel) -> SoproModel:
        """The whole leaves written into `model` (a `SoproModel` of the same
        config), then `weights_changed()`, so it serves the trained
        weights."""
        params = dict(model.named_parameters())
        for name, t in self.full_leaves(model.device()).items():
            params[name].copy_(t)
        model.weights_changed()
        return model

    # -- checkpoints: the file format of an unsharded state -------------------

    def train_state_dict(self, optimizer: torch.optim.Optimizer) -> Dict:
        """{"model", "optimizer"} as an unsharded `SoproModel` and its
        optimizer would give them: the whole leaves by parameter name, and
        the optimizer state per whole parameter (index in the model's
        parameter order; each moment joined from its shards)."""
        groups = optimizer.state_dict()["param_groups"]
        if len(groups) != 1:
            raise ValueError("a sharded state's optimizer has one parameter group")
        state = {}
        with torch.no_grad():
            for i, lay in enumerate(self.layouts):
                parts = self.leaves[lay.path]
                sts = [optimizer.state.get(p) for p in parts]
                if not sts[0]:
                    continue
                state[i] = {k: (lay.join([s[k].detach().cpu() for s in sts])
                                if _moment(lay, v) else v.detach().cpu().clone())
                            for k, v in sts[0].items()}
        group = dict(groups[0], params=list(range(len(self.layouts))))
        return {"model": self.full_leaves("cpu"),
                "optimizer": {"state": state, "param_groups": [group]}}

    def load_train_state_dict(self, sd: Dict, optimizer: Optional[torch.optim.Optimizer]) -> None:
        """Read a state in the format of `train_state_dict` (or of an
        unsharded `SoproModel`'s checkpoint) into this layout: each whole
        leaf and moment split over the shards. The optimizer state's
        indices follow the saved model's parameter order."""
        tp = self.mesh.shape["tp"]
        with torch.no_grad():
            for lay in self.layouts:
                for p, x in zip(self.leaves[lay.path], lay.split(sd["model"][lay.name], tp)):
                    p.copy_(x)
        if optimizer is not None:
            self.load_optimizer_state(sd["optimizer"], optimizer, names=list(sd["model"]))

    def load_optimizer_state(self, osd: Dict, optimizer: torch.optim.Optimizer,
                             names: Optional[List[str]] = None) -> None:
        """An optimizer state dict of the whole parameters (one group,
        indexed in the order of `names`, default this state's own) into
        `optimizer` over this state's parameters."""
        if len(osd["param_groups"]) != 1:
            raise ValueError("a sharded state's optimizer has one parameter group")
        own = [p for g in optimizer.param_groups for p in g["params"]]
        index = {id(p): j for j, p in enumerate(own)}
        by_name = {lay.name: lay for lay in self.layouts}
        order = names if names is not None else [lay.name for lay in self.layouts]
        tp = self.mesh.shape["tp"]
        state = {}
        for i, st in osd["state"].items():
            lay = by_name[order[i]]
            if not st:
                continue
            split = {k: (lay.split(v, tp) if _moment(lay, v) else None) for k, v in st.items()}
            for t, p in enumerate(self.leaves[lay.path]):
                state[index[id(p)]] = {k: (v.clone() if split[k] is None else split[k][t])
                                       for k, v in st.items()}
        group = dict(osd["param_groups"][0], params=list(range(len(own))))
        optimizer.load_state_dict({"state": state, "param_groups": [group]})


def shard_train_state(
    mesh: Mesh, model: SoproModel, optimizer: torch.optim.Optimizer,
) -> Tuple[ShardedModel, torch.optim.Optimizer]:
    """-> (state, optimizer): `model`'s weights laid out on `mesh`, and an
    optimizer of `optimizer`'s class and hyperparameters over the state's
    parameters, holding `optimizer`'s moments split as the parameters are.
    Raises ValueError for a bfloat16 model, RuntimeError for a CUDA mesh
    without its cards."""
    T.require_float32(model, "shard_train_state")
    _check_mesh(mesh)
    state = ShardedModel(mesh, model)
    accepted = inspect.signature(type(optimizer).__init__).parameters
    opt = type(optimizer)(state.parameters(),
                          **{k: v for k, v in optimizer.defaults.items() if k in accepted})
    state.load_optimizer_state(optimizer.state_dict(), opt)
    return state, opt


def _place_batch(mesh: Mesh, batch: T.TrainBatch) -> List[T.TrainBatch]:
    """Each dp group's rows (`row_blocks`, the blocks of `batch_sharding`)
    on the group's first device."""
    blocks = row_blocks(int(batch.frames.shape[0]), mesh.shape["dp"])
    return [T.TrainBatch(*(x[lo:hi] for x in batch)).to(mesh.devices[g, 0])
            for g, (lo, hi) in enumerate(blocks)]


def _processes() -> bool:
    """True inside a process group of more than one process
    (`parallel.data.init_process_group`)."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def loss_fn(state: ShardedModel, batch: T.TrainBatch, norm: Optional[T.LossNorm] = None):
    """-> (loss, {"loss", "ar_loss", "nar_loss"}) of the batch, on the
    mesh's first device: each dp group's `train.loss_fn` on its rows with
    the counts `norm` (default: the whole batch's), summed."""
    norm = norm if norm is not None else T.loss_norm(batch)
    first = state.mesh.devices[0, 0]
    total = None
    for g, rows in enumerate(_place_batch(state.mesh, batch)):
        home = state.mesh.devices[g, 0]
        _, m = T.loss_fn(state.group(g), rows, T.LossNorm(*(c.to(home) for c in norm)))
        m = {k: v.to(first) for k, v in m.items()}
        total = m if total is None else {k: total[k] + m[k] for k in total}
    return total["loss"], total


def _all_reduce_grads(params) -> None:
    """Sum the gradients over the processes: one all-reduce per device."""
    by_device: Dict[torch.device, list] = {}
    for p in params:
        by_device.setdefault(p.device, []).append(p)
    for group in by_device.values():
        all_reduce_grads(group)


def make_train_step(state: ShardedModel, optimizer: torch.optim.Optimizer):
    """-> step(batch) -> metrics of the whole batch (detached scalars on the
    mesh's first device): one forward and backward over every dp group, one
    optimizer step of the masters. Equal to `train.make_train_step` on the
    whole batch up to the order of the sums.

    Inside a process group (`parallel.data`), each process drives its own
    mesh and passes its rows (`shard_batch`): the counts and the gradients
    are summed over the processes, as `parallel.data.make_train_step` sums
    them, so processes x the mesh's dp groups split one global batch."""

    def step(batch: T.TrainBatch) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad(set_to_none=False)
        procs = _processes()
        loss, metrics = loss_fn(state, batch, global_norm(batch) if procs else None)
        loss.backward()
        params = T.fill_missing_grads(optimizer)
        if procs:
            _all_reduce_grads(params)
        optimizer.step()
        values = torch.stack([metrics[k].detach() for k in _METRICS])
        if procs:
            dist.all_reduce(values)
        return dict(zip(_METRICS, values))

    return step
