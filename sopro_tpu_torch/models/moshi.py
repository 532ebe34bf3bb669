"""Moshi (Kyutai's full-duplex speech-text model, `model_type: moshi`): a
7B temporal transformer (Helium) over a summed 17-stream frame embedding,
an inner-monologue text head, and a depth transformer ("depformer") run
once per codebook of Moshi's own audio stream inside every frame, with a
separate weight set for each of those steps.

Equations (transformers' `models/moshi/modeling_moshi.py`, Kyutai's
`moshi/models/lm.py`):

- Streams. A position holds 17 tokens: the text token, Moshi's 8 Mimi
  codebooks and the user's 8. Codebooks 1..7 of each audio stream lag
  codebook 0 by one position (the acoustic delay, transformers'
  `build_delay_pattern_mask`): position p holds text and codebook 0 of
  frame p - 1 and codebooks 1..7 of frame p - 2. Position 0 is all initial
  tokens (text id `text_vocab_size`, audio id `audio_vocab_size`), and so
  are codebooks 1..7 at position 1.
- Frame embedding: the sum of the 16 audio embeddings (one table of
  `audio_vocab_size + 1` rows per codebook, Moshi's 8 then the user's 8)
  and the text embedding (`text_vocab_size + 1` rows).
- Temporal transformer: pre-RMSNorm decoder layers, multi-head attention
  with RoPE (rotate-half layout, theta 10,000, no scaling), causal over a
  KV cache of the published context, a gated SiLU MLP (`fc1` into two
  halves, `silu(first) * second`, `fc2`), a final RMSNorm. The hidden
  state at position p predicts position p + 1's text token through
  `lm_head`.
- Depformer, per position, its cache started afresh: step k (0..7) reads
  the text token just sampled (k = 0, `depth_text_embed`) or Moshi's
  codebook k - 1 just sampled (`depth_audio_embed[k - 1]`), plus
  `depth_proj[k]` of the temporal hidden state, through decoder layers
  with no RoPE and no final norm whose q, k, v, o, fc1 and fc2 are weight
  set k (the norms are shared), and `heads[k]` gives codebook k's logits.

Parameters are one tree, linears in torch's [out, in] layout, q/k/v
stacked into one matrix: `text_embed` [Vt + 1, D], `audio_embed` [2Q, Va
+ 1, D], `temporal` (`layers`, `norm`), `lm_head` [Vt, D], `depth`
(`layers`, each matrix a stack [Q, out, in]; no `norm`),
`depth_text_embed` [Vt + 1, d], `depth_audio_embed` [Q - 1, Va + 1, d],
`depth_proj` [Q, d, D], `heads` [Q, Va, d]. `hub.moshi_params_from_flat`
converts transformers' names into it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from sopro_tpu_torch.models.base import ParamModule
from sopro_tpu_torch.models.csm import KVCache, Rope, TransformerConfig, decoder

# transformers' MoshiConfig / MoshiDepthConfig defaults (Kyutai's moshiko)
HELIUM = TransformerConfig(4096, 11264, 32, 32, 32, 128, 3000, rms_norm_eps=1e-8,
                           rope_theta=10000.0, rope_scaling=None)
DEPFORMER = TransformerConfig(1024, 2816, 6, 16, 16, 64, 8, rms_norm_eps=1e-8,
                              rope_theta=10000.0, rope_scaling=None)


def _transformer_config(d: Dict, positions: Optional[int] = None) -> TransformerConfig:
    """A transformers Moshi config dict -> the shared decoder's widths
    (`ffn_dim` is `fc1`'s output, both halves)."""
    heads = int(d["num_attention_heads"])
    return TransformerConfig(
        hidden_size=int(d["hidden_size"]), intermediate_size=int(d["ffn_dim"]) // 2,
        num_hidden_layers=int(d["num_hidden_layers"]), num_attention_heads=heads,
        num_key_value_heads=int(d.get("num_key_value_heads") or heads),
        head_dim=int(d.get("head_dim") or int(d["hidden_size"]) // heads),
        max_position_embeddings=int(positions or d["max_position_embeddings"]),
        rms_norm_eps=float(d["rms_norm_eps"]), rope_theta=float(d.get("rope_theta", 10000.0)),
        rope_scaling=None)


@dataclass(frozen=True)
class MoshiConfig:
    """moshiko's widths by default. `depth.max_position_embeddings` is the
    depformer's cache: one frame's `num_codebooks` steps."""

    temporal: TransformerConfig = HELIUM
    depth: TransformerConfig = DEPFORMER
    num_codebooks: int = 8
    audio_vocab_size: int = 2048
    text_vocab_size: int = 32000

    @classmethod
    def from_dict(cls, d: Dict) -> "MoshiConfig":
        """From transformers' Moshi config.json: the temporal transformer's
        keys at the top level, the depformer's under `depth_decoder_config`."""
        q = int(d.get("num_codebooks", 8))
        return cls(temporal=_transformer_config(d),
                   depth=_transformer_config(d["depth_decoder_config"], positions=q),
                   num_codebooks=q, audio_vocab_size=int(d.get("audio_vocab_size") or 2048),
                   text_vocab_size=int(d["vocab_size"]))


class MoshiModel(ParamModule):
    """Moshi's parameters (the tree of the module docstring) with the
    temporal transformer's RoPE table; inference only."""

    def __init__(self, tree: Dict[str, Any], cfg: MoshiConfig):
        super().__init__(tree, trainable=False)
        self.cfg = cfg
        self._rope: Optional[Rope] = None

    def _apply(self, fn, *args, **kwargs):
        self._rope = None
        return super()._apply(fn, *args, **kwargs)

    def device(self) -> torch.device:
        return self.param_device()

    def rope(self) -> Rope:
        if self._rope is None:
            self._rope = Rope(self.cfg.temporal, self.device())
        return self._rope

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [T, 17] (text, Moshi's codebooks, the user's) -> [T, D]:
        the 16 audio embeddings summed, then the text embedding added."""
        q2 = 2 * self.cfg.num_codebooks
        audio = self.p["audio_embed"][torch.arange(q2, device=tokens.device), tokens[:, 1:]]
        return audio.sum(dim=1) + self.p["text_embed"][tokens[:, 0]]

    def temporal(self, x: torch.Tensor, cache: KVCache,
                 at: Optional[Tuple[torch.Tensor, int]] = None) -> torch.Tensor:
        """x [T, D] at the cache's next T positions, or one position at
        `at` (`models/csm.py` `decoder`) -> [T, D]."""
        return decoder(self.p["temporal"], self.cfg.temporal, self.rope(), x, cache, at=at)

    def text_logits(self, h: torch.Tensor) -> torch.Tensor:
        return h @ self.p["lm_head"].t()

    def depth_projections(self, h: torch.Tensor) -> torch.Tensor:
        """The temporal hidden state h [1, D] through every step's input
        projection -> [Q, d]."""
        return (self.p["depth_proj"] @ h[0]).contiguous()

    def depth_input(self, k: int, token: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
        """Step k's input [1, d]: the text token (k = 0) or codebook k - 1's
        code, token [1], embedded, plus its projection `proj` [1, d]."""
        table = self.p["depth_text_embed"] if k == 0 else self.p["depth_audio_embed"][k - 1]
        return F.embedding(token, table) + proj

    def depth_step(self, k: int, x: torch.Tensor, cache: KVCache) -> torch.Tensor:
        """x [1, d] at the depformer cache's next position through weight set
        k -> [1, d] (no final norm)."""
        return decoder(self.p["depth"], self.cfg.depth, None, x, cache, weight_set=k)

    def audio_logits(self, k: int, y: torch.Tensor) -> torch.Tensor:
        return y @ self.p["heads"][k].t()
