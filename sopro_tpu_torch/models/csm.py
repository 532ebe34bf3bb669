"""CSM (Sesame's Conversational Speech Model, `model_type: csm`): a
Llama-style backbone over a summed multi-codebook frame embedding, and a
smaller depth decoder run once per codebook inside every frame.

Equations (transformers' `models/csm/modeling_csm.py`, Sesame's `models.py`):

- Frame embedding. A position is a text token or an audio frame of
  `num_codebooks` codes. Its input is the masked sum of the text embedding
  of its text column and the embeddings of its codes, codebook k's code c at
  row k * vocab_size + c of one audio table.
- Both transformers: pre-RMSNorm decoder layers, grouped-query attention
  with RoPE (rotate-half layout, llama3-scaled frequencies where the config
  says so), causal over a static KV cache, and a SwiGLU MLP; a final RMSNorm.
- Backbone: one position per frame; `lm_head` on its last hidden state gives
  codebook 0's logits.
- Depth decoder, per frame, its cache started afresh: position 0 is the
  backbone's last hidden state, position p >= 1 the embedding of codebook
  p - 1's code (the backbone's audio table, tied), all projected from the
  backbone's width by `inputs_embeds_projector`; the hidden state at
  position p gives codebook p's logits through `codebooks_head[p - 1]`.

Parameters are one tree, linears in torch's [out, in] layout with q/k/v
and gate/up each stacked into one matrix: `text_embed` [Vt, D],
`audio_embed` [Q * V, D], `lm_head` [V, D], `backbone` and `depth`
(`layers`, `norm`; the depth decoder's `proj` [d, D]), `heads` [Q - 1, d,
V]. `hub.csm_params_from_flat` converts transformers' names into it.
`CsmModel` holds the heads as rows, [Q - 1, V, d]: a logit's weights
contiguous, as kernel K6 (`ops/csm_depth.py`) streams them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from sopro_tpu_torch.models.base import ParamModule
from sopro_tpu_torch.ops.rope import rope_cos_sin, rotary

# Sesame's `llama3_2_1B` / `llama3_2_100M` (torchtune's Llama3ScaledRoPE as
# `models.py` builds them). transformers' CsmConfig defaults to no scaling.
LLAMA3_2_ROPE = {"rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
                 "high_freq_factor": 4.0, "original_max_position_embeddings": 8192}


@dataclass(frozen=True)
class TransformerConfig:
    hidden_size: int
    intermediate_size: int
    num_hidden_layers: int
    num_attention_heads: int
    num_key_value_heads: int
    head_dim: int
    max_position_embeddings: int
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    rope_scaling: Optional[Dict] = field(default_factory=lambda: dict(LLAMA3_2_ROPE))

    @classmethod
    def from_dict(cls, d: Dict) -> "TransformerConfig":
        """From a transformers config dict (`head_dim` defaults to hidden /
        heads, as there)."""
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in names}
        if kw.get("head_dim") is None:
            kw["head_dim"] = int(d["hidden_size"]) // int(d["num_attention_heads"])
        return cls(**kw)


BACKBONE = TransformerConfig(2048, 8192, 16, 32, 8, 64, 2048)
DEPTH = TransformerConfig(1024, 8192, 4, 8, 2, 128, 33)


@dataclass(frozen=True)
class CsmConfig:
    """CSM-1B's widths by default (transformers' `CsmConfig` and
    `CsmDepthDecoderConfig` defaults, with Sesame's RoPE scaling)."""

    backbone: TransformerConfig = BACKBONE
    depth: TransformerConfig = DEPTH
    num_codebooks: int = 32
    vocab_size: int = 2051
    text_vocab_size: int = 128256
    codebook_eos_token_id: int = 0

    @classmethod
    def from_dict(cls, d: Dict) -> "CsmConfig":
        """From transformers' CSM config.json: the backbone's keys at the top
        level, the depth decoder's under `depth_decoder_config`."""
        top = {f.name for f in dataclasses.fields(cls)} - {"backbone", "depth"}
        return cls(backbone=TransformerConfig.from_dict(d),
                   depth=TransformerConfig.from_dict(d["depth_decoder_config"]),
                   **{k: v for k, v in d.items() if k in top})


class KVCache:
    """A transformer's keys and values, preallocated for `length` positions:
    `k`, `v` [layers, kv heads, length, head_dim]. `filled` (a host int) is
    the number of positions written; the next forward writes after them and
    attends to them, and `reset()` starts the cache afresh."""

    def __init__(self, cfg: TransformerConfig, length: int, device, dtype=torch.float32):
        shape = (cfg.num_hidden_layers, cfg.num_key_value_heads, int(length), cfg.head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=device)
        self.v = torch.zeros(shape, dtype=dtype, device=device)
        self.filled = 0

    @property
    def length(self) -> int:
        return int(self.k.shape[2])

    def reset(self) -> None:
        self.filled = 0


class Rope:
    """cos and sin [max positions, head_dim] of one transformer."""

    def __init__(self, cfg: TransformerConfig, device):
        pos = torch.arange(cfg.max_position_embeddings, device=device)
        self.cos, self.sin = rope_cos_sin(pos, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)

    def __call__(self, x: torch.Tensor, pos: int) -> torch.Tensor:
        """x [T, heads, hd] at positions pos..pos+T-1."""
        t = x.shape[0]
        return rotary(x, self.cos[pos: pos + t, None], self.sin[pos: pos + t, None])

    def at(self, x: torch.Tensor, where: torch.Tensor) -> torch.Tensor:
        """x [1, heads, hd] at the position held on the device in where [1]."""
        return rotary(x, self.cos[where][:, None], self.sin[where][:, None])


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: int) -> torch.Tensor:
    """q [T, H, hd] at positions pos..pos+T-1 over the cache's keys and
    values [KVH, pos+T, hd] -> [T, H * hd]. Query head h reads kv head
    h // (H / KVH). One position: the group's queries are rows of one
    attention over their kv head, with no mask."""
    t, h, hd = q.shape
    kvh = k.shape[0]
    if t == 1:
        out = F.scaled_dot_product_attention(q.view(1, kvh, h // kvh, hd), k[None], v[None])
        return out.reshape(1, h * hd)
    g = h // kvh
    k, v = k.repeat_interleave(g, dim=0), v.repeat_interleave(g, dim=0)
    if pos == 0:
        out = F.scaled_dot_product_attention(q.transpose(0, 1), k, v, is_causal=True)
    else:
        s = k.shape[1]
        mask = torch.arange(s, device=q.device)[None, :] <= pos + torch.arange(t, device=q.device)[:, None]
        out = F.scaled_dot_product_attention(q.transpose(0, 1), k, v, attn_mask=mask)
    return out.transpose(0, 1).reshape(t, h * hd)


def _attend_at(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """q [1, H, hd] over the keys and values [KVH, n, hd] of the cache's
    first n positions, `bias` [1, n] added to the scores (-inf past the
    query's position) -> [1, H * hd]. Batched products and a softmax: with
    SDPA's float32 kernel in their place Moshi's temporal step took 12.29
    ms at 512 keys (11.07 with these) and 20.59 ms at 3,000 (12.17) on an
    H100."""
    _, h, hd = q.shape
    kvh = k.shape[0]
    s = torch.baddbmm(bias, q.view(kvh, h // kvh, hd), k.transpose(1, 2), alpha=hd ** -0.5)
    return torch.bmm(torch.softmax(s, -1), v).reshape(1, h * hd)


def decoder(p: Dict[str, Any], cfg: TransformerConfig, rope: Optional[Rope], x: torch.Tensor,
            cache: KVCache, weight_set: Optional[int] = None,
            at: Optional[Tuple[torch.Tensor, int]] = None) -> torch.Tensor:
    """The decoder layers and the final norm over x [T, hidden] at the
    cache's next T positions; writes their keys and values and advances
    the cache. `rope` None: no positional rotation. `weight_set` k: each
    layer's matrices are stacks [sets, out, in] and this pass takes set k
    (the norms are shared). A tree with no "norm" ends without one.
    `at` (where, n): x is one position, at the position held on the device
    in where [1], attending to the cache's first n positions up to it; the
    cache's `filled` is neither read nor advanced, so that one CUDA graph
    serves every position below n."""
    pos, t = cache.filled, x.shape[0]
    if at is None and pos + t > cache.length:
        raise ValueError(f"{pos + t} positions past the cache's {cache.length}")
    h_, kvh, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    qk_w, eps = (h_ + kvh) * hd, cfg.rms_norm_eps
    w = (lambda a: a) if weight_set is None else (lambda a: a[weight_set])
    if at is not None:
        where, n = at
        ar = torch.arange(n, device=x.device)
        bias = torch.zeros((1, n), dtype=x.dtype, device=x.device).masked_fill_(ar > where, float("-inf"))
    for i, lp in enumerate(p["layers"]):
        h = F.rms_norm(x, (x.shape[-1],), lp["ln1"], eps)
        qkv = h @ w(lp["qkv"]).t()
        qk = qkv[:, :qk_w].view(t, h_ + kvh, hd)
        if at is not None:
            if rope is not None:
                qk = rope.at(qk, where)
            cache.k[i].index_copy_(1, where, qk[:, h_:].transpose(0, 1))
            cache.v[i].index_copy_(1, where, qkv[:, qk_w:].view(1, kvh, hd).transpose(0, 1))
            a = _attend_at(qk[:, :h_], cache.k[i, :, :n], cache.v[i, :, :n], bias)
        else:
            if rope is not None:
                qk = rope(qk, pos)
            cache.k[i, :, pos: pos + t] = qk[:, h_:].transpose(0, 1)
            cache.v[i, :, pos: pos + t] = qkv[:, qk_w:].view(t, kvh, hd).transpose(0, 1)
            a = _attend(qk[:, :h_], cache.k[i, :, : pos + t], cache.v[i, :, : pos + t], pos)
        x = torch.addmm(x, a, w(lp["o"]).t())
        gu = F.rms_norm(x, (x.shape[-1],), lp["ln2"], eps) @ w(lp["gate_up"]).t()
        f = gu.shape[-1] // 2
        x = torch.addmm(x, F.silu(gu[:, :f]) * gu[:, f:], w(lp["down"]).t())
    if at is None:
        cache.filled = pos + t
    return x if p.get("norm") is None else F.rms_norm(x, (x.shape[-1],), p["norm"], eps)


class CsmModel(ParamModule):
    """CSM's parameters (the tree of the module docstring, the heads as
    rows) with the two transformers' RoPE tables; inference only."""

    def __init__(self, tree: Dict[str, Any], cfg: CsmConfig):
        super().__init__(dict(tree, heads=tree["heads"].transpose(1, 2).contiguous()), trainable=False)
        self.cfg = cfg
        self._ropes: Optional[List[Rope]] = None

    def _apply(self, fn, *args, **kwargs):
        self._ropes = None
        return super()._apply(fn, *args, **kwargs)

    def device(self) -> torch.device:
        return self.param_device()

    def ropes(self) -> List[Rope]:
        """The backbone's and the depth decoder's tables (built once per
        device)."""
        if self._ropes is None:
            dev = self.device()
            self._ropes = [Rope(self.cfg.backbone, dev), Rope(self.cfg.depth, dev)]
        return self._ropes

    def offsets(self) -> torch.Tensor:
        """[Q]: codebook k's first row in the audio table."""
        return torch.arange(self.cfg.num_codebooks, device=self.device()) * self.cfg.vocab_size

    def embed_prompt(self, tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """tokens, mask [S, Q + 1] (codes in the first Q columns, the text id
        in the last) -> [S, D]: the masked sum of the Q code embeddings and
        the text embedding, in that order."""
        q = self.cfg.num_codebooks
        audio = self.p["audio_embed"][tokens[:, :q] + self.offsets()]
        text = self.p["text_embed"][tokens[:, q]]
        e = torch.cat([audio, text[:, None]], dim=1)
        return (e * mask[..., None].to(e.dtype)).sum(dim=1)

    def embed_frame(self, codes: torch.Tensor) -> torch.Tensor:
        """One frame's codes [Q] -> [1, D]."""
        return self.p["audio_embed"][codes + self.offsets()].sum(dim=0, keepdim=True)

    def backbone(self, x: torch.Tensor, cache: KVCache) -> torch.Tensor:
        return decoder(self.p["backbone"], self.cfg.backbone, self.ropes()[0], x, cache)

    def codebook0_logits(self, h: torch.Tensor) -> torch.Tensor:
        return h @ self.p["lm_head"].t()

    def depth_input(self, codebook: int, code: torch.Tensor) -> torch.Tensor:
        """The audio table's row of codebook `codebook`'s code [1] -> [1, D]."""
        v = self.cfg.vocab_size
        return F.embedding(code, self.p["audio_embed"][codebook * v: (codebook + 1) * v])

    def depth(self, x: torch.Tensor, cache: KVCache) -> torch.Tensor:
        """x [T, D] at the depth cache's next T positions -> the last
        position's hidden state [1, d]."""
        h = decoder(self.p["depth"], self.cfg.depth, self.ropes()[1], x @ self.p["depth"]["proj"].t(),
                    cache)
        return h[-1:]

    def codebook_logits(self, codebook: int, h: torch.Tensor) -> torch.Tensor:
        """Codebook `codebook` (>= 1)'s logits from the depth decoder's hidden
        state at its position."""
        return h @ self.p["heads"][codebook - 1].t()

