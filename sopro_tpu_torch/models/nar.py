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
from sopro_tpu_torch.ops.nar_heads import nar_heads_argmax

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
) -> torch.Tensor:
    """One stage's trunk -> pre-head hidden z [B, T, head_dim]."""
    sid = cfg.stage_order().index(stage)
    w = torch.softmax(p["mix"][stage].float(), dim=0).to(cond.dtype)
    x = w[0] * cond + w[1] * prev_emb
    x = _stage_adapter(p["adapter"], x, p["stage_emb"]["emb"][sid])
    dils = cfg.nar_dilations()
    for i, bp in enumerate(p["blocks"]):
        x = ssmlite(bp, x, kernel_size=cfg.nar_kernel_size, dilation=dils[i],
                    causal=False, mask=mask)
    return linear(p["pre"], rmsnorm(p["norm"], x))


def _stage_head_stacks(p: Params, stage: str):
    hid = p["head_id_emb"][stage]["emb"].contiguous()  # [H, hd]
    w_stack = torch.stack([hp["w"] for hp in p["heads"][stage]]).contiguous()  # [H, hd, V]
    b_stack = torch.stack([hp["b"] for hp in p["heads"][stage]]).contiguous()  # [H, V]
    return hid, w_stack, b_stack


def nar_stage_preds(
    p: Params,
    cfg: SoproTTSConfig,
    stage: str,
    cond: torch.Tensor,
    prev_emb: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    stacks=None,
) -> torch.Tensor:
    """One stage's greedy tokens [B, T, H] int32 (kernel K2 on CUDA)."""
    z = _stage_hidden(p, cfg, stage, cond, prev_emb, mask).contiguous()
    hid, w_stack, b_stack = stacks if stacks is not None else _stage_head_stacks(p, stage)
    return nar_heads_argmax(z, hid, w_stack, b_stack)


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
) -> torch.Tensor:
    """Fill codebooks 2..Q given codebook-1 tokens: one pass per stage.
    cond_seq [B, T, D]; rvq1_bt [B, T] -> tokens [B, T, Q] int32."""
    b, t, _ = cond_seq.shape
    stage_idx = cfg.stage_indices()
    out = torch.zeros((b, t, int(cfg.num_codebooks)), dtype=torch.int32, device=cond_seq.device)
    out[:, :, 0] = rvq1_bt.to(torch.int32)
    prev_tokens = rvq1_bt[..., None].to(torch.int32)
    prev_cbs: List[int] = [0]
    for stage in cfg.stage_order():
        idxs = stage_idx[stage]
        prev_emb = cb_sum_embed_subset(
            cb_embed_params, cb_spec, prev_tokens, prev_cbs, cb_weights=nar_prev_cb_weights
        )
        preds = nar_stage_preds(
            p, cfg, stage, cond_seq, prev_emb, mask=mask,
            stacks=None if stacks is None else stacks[stage],
        )
        out[:, :, idxs] = preds
        prev_tokens = torch.cat([prev_tokens, preds], dim=-1)
        prev_cbs = prev_cbs + list(idxs)
    return out


class NARRefiner(ParamModule):
    """NAR parameters; head stacks are built once per device."""

    def __init__(self, tree: Params, cfg: SoproTTSConfig):
        super().__init__(tree)
        self.cfg = cfg
        self._stacks = None

    def _apply(self, fn, *args, **kwargs):
        self._stacks = None
        return super()._apply(fn, *args, **kwargs)

    def head_stacks(self) -> Dict[str, tuple]:
        if self._stacks is None:
            self._stacks = {s: _stage_head_stacks(self.p, s) for s in self.cfg.stage_order()}
        return self._stacks
