"""Training (counterpart: sopro_tpu/train.py): the teacher-forced losses of
the AR generator and the NAR refiner with the whole conditioning in the
graph, an AdamW step, and training checkpoints.

The objective is the JAX package's: next-frame cross-entropy on RVQ
codebook 1 with an EOS target at each row's end for the AR stack, and
per-stage cross-entropy on codebooks 2..Q for the NAR refiner conditioned on
the ground-truth earlier codebooks; loss = AR + mean over the stages. No
dropout is applied (the JAX `loss_fn` applies none). Log-softmax runs in
float32.

    model = tts.engine.model                      # a SoproModel
    opt = make_optimizer(model, lr=3e-4)
    step = make_train_step(model, opt)
    metrics = step(batch)                         # batch: TrainBatch on the model's device

Training runs none of the port's kernels: the forward is plain PyTorch (the
JAX training graph reaches no Pallas kernel either). After each step the
model's kernel-side caches are dropped (`SoproModel.weights_changed`), so
serving from the same model decodes with the new weights. Data parallelism
over several processes is `parallel/data.py`; the (dp, tp) layout on a
mesh of devices driven by one process is `parallel/tensor.py`, whose
sharded leaves the loss reads through `ops/tp.py`.
"""

from __future__ import annotations

import os
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from sopro_tpu_torch.models import generator as G
from sopro_tpu_torch.models import nar as N
from sopro_tpu_torch.models import sopro as M
from sopro_tpu_torch.ops import tp
from sopro_tpu_torch.ops.embeddings import cb_sum_embed_subset


class TrainBatch(NamedTuple):
    text_ids: torch.Tensor  # [B, L] int
    text_mask: torch.Tensor  # [B, L] bool
    ref_tokens: torch.Tensor  # [B, Tr, Q] int
    ref_mask: torch.Tensor  # [B, Tr] bool
    frames: torch.Tensor  # [B, S, Q] int: ground-truth codec tokens
    frame_mask: torch.Tensor  # [B, S] bool

    def to(self, device) -> "TrainBatch":
        return TrainBatch(*(x.to(device) for x in self))


class LossNorm(NamedTuple):
    """The counts the loss terms are divided by: valid AR targets (frames
    plus EOS positions) and valid frames (a NAR stage of H heads divides by
    H times it). Data parallelism passes the counts summed over every rank,
    so each rank's loss is its share of the global masked mean."""

    ar: torch.Tensor  # scalar float
    frames: torch.Tensor  # scalar float


def _eos_positions(frame_mask: torch.Tensor) -> torch.Tensor:
    """[B, S] bool: the first padded position of each row (none for a row
    that fills S)."""
    lengths = frame_mask.sum(dim=1)
    pos = torch.arange(frame_mask.shape[1], device=frame_mask.device)
    return pos[None, :] == lengths[:, None]


def loss_norm(batch: TrainBatch) -> LossNorm:
    """The local counts of `batch`."""
    ar_mask = batch.frame_mask | _eos_positions(batch.frame_mask)
    return LossNorm(ar=ar_mask.sum().float(), frames=batch.frame_mask.sum().float())


def _masked_ce(
    logits: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor, count: torch.Tensor
) -> torch.Tensor:
    """sum of the masked NLL (log-softmax in float32) / max(count, 1);
    logits split on the vocab axis (`ops.tp.Shards`) take `tp.nll`."""
    if isinstance(logits, tp.Shards):
        nll = tp.nll(logits, targets)
    else:
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    return torch.sum(nll * mask.float()) / torch.clamp(count, min=1.0)


def loss_fn(
    model: M.SoproModel, batch: TrainBatch, norm: Optional[LossNorm] = None
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """-> (loss, {"loss", "ar_loss", "nar_loss"}); the loss terms are divided
    by `norm` (default: this batch's own counts)."""
    cfg = model.cfg
    spec = M.cb_spec(cfg)
    b, s, _ = batch.frames.shape
    norm = norm if norm is not None else loss_norm(batch)
    shared = model.shared.p

    ref = M.prepare_reference(model, batch.ref_tokens, mask=batch.ref_mask)
    prep = M.prepare_conditioning(
        model, batch.text_ids, batch.text_mask, ref,
        max_frames=s - 1, style_strength=float(cfg.style_strength),
    )
    cond = prep["cond_ar"]  # [B, S, D]

    # AR: BOS then the shifted codebook-1 tokens in; codebook 1 plus EOS out
    rvq1 = batch.frames[..., 0].long()
    bos = torch.full((b, 1), spec.bos_id, dtype=torch.long, device=rvq1.device)
    prev = torch.cat([bos, rvq1[:, :-1]], dim=1)
    x = cond + tp.take_rows(shared["cb_embed"]["emb"], prev)
    ar_logits = G.ar_forward(
        model.ar.p, cfg, x, prep["txt_seq"], batch.text_mask, frame_mask=batch.frame_mask
    )  # [B, S, V+1]
    eos_pos = _eos_positions(batch.frame_mask)
    targets = torch.where(eos_pos, torch.full_like(rvq1, cfg.eos_id), rvq1)
    ar_loss = _masked_ce(ar_logits, targets, batch.frame_mask | eos_pos, norm.ar)

    # NAR: each stage on the ground-truth earlier codebooks
    stage_idx = cfg.stage_indices()
    stage_losses = []
    prev_cbs = [0]
    for stage in cfg.stage_order():
        idxs = list(stage_idx[stage])
        prev_emb = cb_sum_embed_subset(
            shared["cb_embed"], spec, batch.frames[..., prev_cbs], prev_cbs,
            cb_weights=shared["nar_prev_cb_weights"],
        )
        logits = N.nar_forward_stage(
            model.nar.p, cfg, stage, cond, prev_emb, mask=batch.frame_mask
        )  # [B, S, H, V]
        tgt = batch.frames[..., idxs]
        mask = batch.frame_mask[..., None].expand(tgt.shape)
        stage_losses.append(_masked_ce(logits, tgt, mask, norm.frames * len(idxs)))
        prev_cbs = prev_cbs + idxs

    nar_loss = sum(stage_losses) / max(len(stage_losses), 1)
    loss = ar_loss + nar_loss
    return loss, {"loss": loss, "ar_loss": ar_loss, "nar_loss": nar_loss}


def make_optimizer(
    model: M.SoproModel, lr: float = 3e-4, weight_decay: float = 0.01
) -> torch.optim.AdamW:
    """AdamW over every leaf of the Sopro model with optax.adamw's defaults
    (b1 0.9, b2 0.999, eps 1e-8, decoupled decay on every leaf)."""
    return torch.optim.AdamW(
        model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay
    )


def require_float32(model: torch.nn.Module, what: str) -> None:
    """Raise ValueError unless every parameter is float32: the JAX training
    graph has no dtype policy."""
    low = sorted({str(p.dtype) for p in model.parameters() if p.dtype != torch.float32})
    if low:
        raise ValueError(f"{what}: the model has {low} parameters; training runs in "
                         "float32 only (the JAX training graph has no dtype policy)")


def fill_missing_grads(optimizer: torch.optim.Optimizer) -> List[torch.Tensor]:
    """Give every parameter that got no gradient a zero one, and return the
    optimizer's parameters: torch's AdamW skips a parameter whose `.grad` is
    None, where optax still decays the leaf and advances its moments."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return params


def make_train_step(model: M.SoproModel, optimizer: torch.optim.Optimizer):
    """-> step(batch) -> metrics (detached scalars): one forward and
    backward over `batch`, one optimizer step, then the model's kernel-side
    caches are dropped. The model must be float32: the JAX training graph
    has no dtype policy (a model an Engine cast to bfloat16 raises
    ValueError)."""
    require_float32(model, "make_train_step")

    def step(batch: TrainBatch) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad(set_to_none=False)
        loss, metrics = loss_fn(model, batch)
        loss.backward()
        fill_missing_grads(optimizer)
        optimizer.step()
        model.weights_changed()
        return {k: v.detach() for k, v in metrics.items()}

    return step


def save_train_checkpoint(path: str, model, optimizer: torch.optim.Optimizer, step: int = 0) -> None:
    """Write the whole training state (parameters, AdamW moments and step
    counts, the step number) to one file with `torch.save`. `model` is a
    `SoproModel` or a sharded state (`parallel.tensor.ShardedModel`), which
    writes the same format: its whole leaves, and the optimizer state per
    whole parameter. The inference export stays `SoproTTS.save_pretrained`
    (reference-layout safetensors)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    if isinstance(model, M.SoproModel):
        state = {"model": model.state_dict(), "optimizer": optimizer.state_dict()}
    else:
        state = model.train_state_dict(optimizer)
    torch.save(dict(state, step=int(step)), path)


def restore_train_checkpoint(path: str, model, optimizer: torch.optim.Optimizer, device=None,
                             mesh=None):
    """Load a state written by `save_train_checkpoint`, in whatever layout
    it was trained, and return the step number.

    - `model` a `SoproModel` (and its optimizer, built as for a fresh run):
      the tensors are mapped onto `device` (default: the model's), so a
      state saved on one device resumes on another; the model's kernel-side
      caches are dropped.
    - `model` a sharded state (`parallel.tensor.ShardedModel`) and its
      optimizer: each leaf and moment is split into the state's layout.
    - `model` a `SoproModel` and `mesh`: the state is restored straight into
      `mesh`'s layout (`model` and `optimizer` give only the structure and
      hyperparameters) and (state, optimizer, step) is returned."""
    if mesh is not None:
        from sopro_tpu_torch.parallel.tensor import shard_train_state

        state, opt = shard_train_state(mesh, model, optimizer)
        return state, opt, restore_train_checkpoint(path, state, opt)
    if not isinstance(model, M.SoproModel):
        saved = torch.load(path, map_location="cpu", weights_only=True)
        model.load_train_state_dict(saved, optimizer)
        return int(saved["step"])
    device = torch.device(device) if device is not None else model.device()
    state = torch.load(path, map_location=device, weights_only=True)
    model.load_state_dict(state["model"])
    optimizer.load_state_dict(state["optimizer"])
    model.weights_changed()
    return int(state["step"])
