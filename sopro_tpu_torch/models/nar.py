"""Non-autoregressive single-pass refiner (counterpart:
sopro_tpu/models/nar.py): one shared non-causal dilated-conv trunk per
refinement stage, conditioned by a stage FiLM adapter and a softmax mix of
the conditioning sequence and the summed embeddings of previously decoded
codebooks; per-codebook heads with head-id offsets, greedy argmax.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from sopro_tpu_torch.config import SoproTTSConfig
from sopro_tpu_torch.models.base import ParamModule
from sopro_tpu_torch.ops.blocks import gelu, linear, rmsnorm, ssmlite
from sopro_tpu_torch.ops.embeddings import CodebookEmbeddingSpec, cb_sum_embed_subset
from sopro_tpu_torch.ops.nar_heads import nar_heads_argmax, pack_nar_heads

Params = Dict


def _stage_adapter(p: Params, x: torch.Tensor, stage_vec: torch.Tensor) -> torch.Tensor:
    """FiLM from the stage embedding."""
    g, b = torch.chunk(linear(p["mlp2"], gelu(linear(p["mlp1"], stage_vec))), 2, dim=-1)
    x = rmsnorm(p["norm"], x)
    return x * (1 + torch.tanh(g))[None, None, :] + torch.tanh(b)[None, None, :]


def _stage_hidden(
    p: Params,
    cfg: SoproTTSConfig,
    stage: str,
    cond: torch.Tensor,
    prev_emb: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    head_tail: Optional[int] = None,
) -> torch.Tensor:
    """One stage's trunk -> pre-head hidden z [B, T', head_dim]; with
    `head_tail` only the last `head_tail` frames (the trunk still runs the
    whole window: its convs are non-causal)."""
    sid = cfg.stage_order().index(stage)
    w = torch.softmax(p["mix"][stage].float(), dim=0).to(cond.dtype)
    x = w[0] * cond + w[1] * prev_emb
    x = _stage_adapter(p["adapter"], x, p["stage_emb"]["emb"][sid])
    dils = cfg.nar_dilations()
    for i, bp in enumerate(p["blocks"]):
        x = ssmlite(bp, x, kernel_size=cfg.nar_kernel_size, dilation=dils[i],
                    causal=False, mask=mask)
    if head_tail is not None:
        x = x[:, -int(head_tail):]
    return linear(p["pre"], rmsnorm(p["norm"], x))


def _head_weights(p: Params, stage: str):
    """(hid [H, hd], w_stack [H, hd, V], b_stack [H, V]) of one stage."""
    hid = p["head_id_emb"][stage]["emb"].contiguous()
    w_stack = torch.stack([hp["w"] for hp in p["heads"][stage]]).contiguous()
    b_stack = torch.stack([hp["b"] for hp in p["heads"][stage]]).contiguous()
    return hid, w_stack, b_stack


def _stage_head_stacks(p: Params, stage: str):
    """(hid, w_stack, b_stack, packed): `packed` is K2's TF32 hi/lo split of
    the weights on CUDA (pack_nar_heads), None on the CPU."""
    hid, w_stack, b_stack = _head_weights(p, stage)
    packed = pack_nar_heads(w_stack) if w_stack.is_cuda else None
    return hid, w_stack, b_stack, packed


def nar_forward_stage(
    p: Params,
    cfg: SoproTTSConfig,
    stage: str,
    cond: torch.Tensor,
    prev_emb: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    head_tail: Optional[int] = None,
) -> torch.Tensor:
    """One refinement stage -> logits [B, T', n_heads, codebook_size]
    (training; T' = `head_tail` or T). The head product is a plain einsum,
    as in the JAX package."""
    z = _stage_hidden(p, cfg, stage, cond, prev_emb, mask, head_tail)
    hid, w_stack, b_stack = _head_weights(p, stage)
    zh = z[:, :, None, :] + hid[None, None, :, :]
    return torch.einsum("bthd,hdv->bthv", zh, w_stack) + b_stack[None, None]


def nar_stage_preds(
    p: Params,
    cfg: SoproTTSConfig,
    stage: str,
    cond: torch.Tensor,
    prev_emb: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    stacks=None,
    head_tail: Optional[int] = None,
) -> torch.Tensor:
    """One stage's greedy tokens [B, T', H] int32 (kernel K2 on CUDA)."""
    z = _stage_hidden(p, cfg, stage, cond, prev_emb, mask, head_tail).contiguous()
    return nar_heads_argmax(z, *(stacks if stacks is not None else _stage_head_stacks(p, stage)))


def nar_refine(
    p: Params,
    cb_embed_params: Params,
    cb_spec: CodebookEmbeddingSpec,
    nar_prev_cb_weights: torch.Tensor,
    cfg: SoproTTSConfig,
    cond_seq: torch.Tensor,
    rvq1_bt: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    stacks: Optional[Dict[str, tuple]] = None,
    head_tail: Optional[int] = None,
) -> torch.Tensor:
    """Fill codebooks 2..Q given codebook-1 tokens: one pass per stage.
    cond_seq [B, T, D]; rvq1_bt [B, T] -> tokens [B, T, Q] int32.

    `head_tail`: only the last stage's heads run, and only on the last
    `head_tail` frames; the earlier stages still refine the whole window
    (their ids feed the next stage's trunk). Outside the tail the last
    stage's codebooks stay 0: callers use only tokens[:, -head_tail:]."""
    b, t, _ = cond_seq.shape
    stage_idx = cfg.stage_indices()
    stages = cfg.stage_order()
    out = torch.zeros((b, t, int(cfg.num_codebooks)), dtype=torch.int32, device=cond_seq.device)
    out[:, :, 0] = rvq1_bt.to(torch.int32)
    prev_tokens = rvq1_bt[..., None].to(torch.int32)
    prev_cbs: List[int] = [0]
    for stage in stages:
        idxs = stage_idx[stage]
        tail = head_tail if stage == stages[-1] else None
        prev_emb = cb_sum_embed_subset(
            cb_embed_params, cb_spec, prev_tokens, prev_cbs, cb_weights=nar_prev_cb_weights
        )
        preds = nar_stage_preds(
            p, cfg, stage, cond_seq, prev_emb, mask=mask,
            stacks=None if stacks is None else stacks[stage], head_tail=tail,
        )
        out[:, t - preds.shape[1]:, idxs] = preds
        if stage != stages[-1]:
            prev_tokens = torch.cat([prev_tokens, preds], dim=-1)
            prev_cbs = prev_cbs + list(idxs)
    return out


class NARRefiner(ParamModule):
    """NAR parameters; head stacks are built once per device and set of
    weights."""

    def __init__(self, tree: Params, cfg: SoproTTSConfig):
        super().__init__(tree)
        self.cfg = cfg
        self.weights_changed()

    def weights_changed(self) -> None:
        """Drop the head stacks (and K2's packs): the next call rebuilds
        them from the current parameters."""
        self._stacks = None

    def _apply(self, fn, *args, **kwargs):
        self.weights_changed()
        return super()._apply(fn, *args, **kwargs)

    @torch.no_grad()
    def head_stacks(self) -> Dict[str, tuple]:
        if self._stacks is None:
            self._stacks = {s: _stage_head_stacks(self.p, s) for s in self.cfg.stage_order()}
        return self._stacks
