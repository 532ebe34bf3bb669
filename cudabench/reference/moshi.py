"""Moshi (Kyutai's moshiko) as plain PyTorch, from transformers'
`MoshiForConditionalGeneration` names.

Written against transformers' `models/moshi/modeling_moshi.py` and
Kyutai's `moshi/models/lm.py`:

- the streams: per position the text token, Moshi's 8 codebooks and the
  user's 8, codebooks 1..7 of each audio stream one position behind
  codebook 0 (`build_delay_pattern_mask`), position 0 and codebooks 1..7 at
  position 1 the initial tokens (text id `vocab_size`, audio id
  `audio_vocab_size`); `positions` lays frames out so;
- the frame embedding: the 16 audio tables (`embed_tokens.{i}`, Moshi's 8
  then the user's 8) summed, then the text table
  (`decoder.model.embed_tokens`) added;
- the temporal transformer: RMSNorm (float32, eps), multi-head attention
  with RoPE in the rotate-half layout (theta `rope_theta`, no scaling), a
  causal mask, softmax in float32, the gated MLP (`fc1` split in halves,
  `fc2(silu(first) * second)`), a final RMSNorm, `decoder.lm_head` for the
  next position's text logits;
- the depformer, per position: positions 0..7 with no RoPE and no final
  norm, every matrix of position k (q, k, v, o, fc1, fc2, the input
  projection, the head) weight set k of its `MoshiFlexibleLinear` stack;
  position 0's input the text token just decided (`text_embed_tokens`),
  position k's codebook k - 1's code (`embed_tokens[k - 1]`), each plus
  `input_projections[k]` of the temporal hidden state; `lm_heads[k]` gives
  codebook k's logits.

Departures: no KV cache. The temporal transformer runs its full causal
forward over a call's positions, and the depformer, for codebook k, its
full forward over positions 0..k; calls run as one batch, each row
right-padded to the longest and masked past its own length. Sampling is
top-k (the logits at or above the k-th largest, temperature first) with
Gumbel-max on the program's keyed Threefry bits in place of Kyutai's
multinomial draw (`cudabench.reference.sampler.threefry`,
`cudabench.reference.csm.sample`; the keys as `sopro_tpu_torch`'s
`moshi_engine` documents them). transformers' init draws the depformer's
stacks N(0, 1); the benchmark's weights take `initializer_range` for every
matrix (`cudabench/families/moshi.py`).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from cudabench.reference.precision import Precision
from cudabench.reference.sampler import threefry


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def positions(text: torch.Tensor, moshi: torch.Tensor, user: torch.Tensor, init_text: int,
              init_audio: int) -> torch.Tensor:
    """Frames 0..T-1 (text [T], Moshi's and the user's codes [T, Q]) -> the
    tokens [T + 1, 1 + 2Q] of positions 0..T: position p the text and
    codebook 0 of frame p - 1, codebooks 1..Q-1 of frame p - 2."""
    t, q = moshi.shape
    out = torch.full((t + 1, 1 + 2 * q), init_audio, dtype=torch.int64, device=text.device)
    out[0, 0] = init_text
    out[1:, 0] = text
    for col, codes in ((1, moshi), (1 + q, user)):
        out[1:, col] = codes[:, 0]
        out[2:, col + 1: col + q] = codes[:-1, 1:]
    return out


class Moshi:
    """The model over a flat state dict (transformers' names, tensors on the
    device) and the configuration's `moshi` dict."""

    def __init__(self, sd: Dict[str, torch.Tensor], cfg: Dict, prec: Precision):
        self.sd = {k: prec.weight(v) for k, v in sd.items()}
        self.prec = prec
        self.q = int(cfg["num_codebooks"])
        self.vt, self.va = int(cfg["vocab_size"]), int(cfg["audio_vocab_size"])
        self.d, self.dc = cfg, cfg["depth_decoder_config"]

    def lin(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return self.prec.act(x) @ self.sd[name].t()

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [..., 1 + 2Q] -> [..., hidden]."""
        audio = sum(self.sd[f"embed_tokens.{i}.weight"][tokens[..., 1 + i]] for i in range(2 * self.q))
        return audio + self.sd["decoder.model.embed_tokens.weight"][tokens[..., 0]]

    def temporal(self, x: torch.Tensor, lengths: Optional[Sequence[int]] = None) -> torch.Tensor:
        """x [B, S, hidden] at positions 0..S-1 -> the final norm's output;
        row b's positions from `lengths[b]` on are padding no position
        attends to."""
        c = self.d
        b_, s = x.shape[:2]
        h = int(c["num_attention_heads"])
        hd = int(c.get("head_dim") or int(c["hidden_size"]) // h)
        eps = float(c["rms_norm_eps"])
        inv = 1.0 / (float(c["rope_theta"]) ** (torch.arange(0, hd, 2, device=x.device).float() / hd))
        ang = torch.arange(s, device=x.device).float()[:, None] * inv[None]
        ang = torch.cat([ang, ang], -1)
        cos, sin = ang.cos(), ang.sin()
        rot = lambda z: torch.cat([-z[..., hd // 2:], z[..., : hd // 2]], -1)
        allowed = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()[None, None]
        if lengths is not None:
            valid = torch.arange(s, device=x.device)[None] < torch.tensor(lengths, device=x.device)[:, None]
            allowed = allowed & valid[:, None, None, :]
        heads = lambda z: z.view(b_, s, h, hd).transpose(1, 2)
        for i in range(int(c["num_hidden_layers"])):
            p = f"decoder.model.layers.{i}"
            a = rms(x, self.sd[f"{p}.input_layernorm.weight"], eps)
            q, k, v = (heads(self.lin(f"{p}.self_attn.{n}_proj.linear.weight", a)) for n in "qkv")
            q, k = q * cos + rot(q) * sin, k * cos + rot(k) * sin
            w = (self.prec.act(q) @ self.prec.act(k).transpose(-1, -2)) * hd ** -0.5
            w = torch.softmax(w.masked_fill(~allowed, float("-inf")), -1, dtype=torch.float32)
            o = (self.prec.act(w) @ self.prec.act(v)).transpose(1, 2).reshape(b_, s, h * hd)
            x = x + self.lin(f"{p}.self_attn.o_proj.linear.weight", o)
            a = self.lin(f"{p}.mlp.fc1.weight", rms(x, self.sd[f"{p}.post_attention_layernorm.weight"], eps))
            f = a.shape[-1] // 2
            x = x + self.lin(f"{p}.mlp.fc2.weight", F.silu(a[..., :f]) * a[..., f:])
        return rms(x, self.sd["decoder.model.norm.weight"], eps)

    def text_logits(self, h: torch.Tensor) -> torch.Tensor:
        return self.lin("decoder.lm_head.weight", h)

    def _stack(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """x [N, P, in] through weight set p at position p of the stack
        `name` [Q, out, in] -> [N, P, out]."""
        return torch.einsum("npi,poi->npo", self.prec.act(x), self.sd[name][: x.shape[1]])

    def depth_logits(self, h: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """The depformer's full forward over positions 0..P-1 after the
        temporal hidden states h [N, hidden]: tokens [N, P] (the text token,
        then codebooks 0..P-2) -> codebook P-1's logits [N, Va]."""
        c, pre = self.dc, "depth_decoder"
        n, p_ = tokens.shape
        h_ = int(c["num_attention_heads"])
        hd = int(c.get("head_dim") or int(c["hidden_size"]) // h_)
        eps = float(c["rms_norm_eps"])
        emb = [self.sd[f"{pre}.text_embed_tokens.weight"][tokens[:, 0]]]
        emb += [self.sd[f"{pre}.embed_tokens.{k - 1}.weight"][tokens[:, k]] for k in range(1, p_)]
        x = torch.stack(emb, 1) + self._stack(f"{pre}.input_projections.weight",
                                              h[:, None].expand(n, p_, h.shape[-1]))
        causal = torch.ones(p_, p_, dtype=torch.bool, device=x.device).tril()
        heads = lambda z: z.view(n, p_, h_, hd).transpose(1, 2)
        for i in range(int(c["num_hidden_layers"])):
            p = f"{pre}.layers.{i}"
            a = rms(x, self.sd[f"{p}.input_layernorm.weight"], eps)
            q, k, v = (heads(self._stack(f"{p}.self_attn.{m}_proj.linear.weight", a)) for m in "qkv")
            w = (self.prec.act(q) @ self.prec.act(k).transpose(-1, -2)) * hd ** -0.5
            w = torch.softmax(w.masked_fill(~causal, float("-inf")), -1, dtype=torch.float32)
            o = (self.prec.act(w) @ self.prec.act(v)).transpose(1, 2).reshape(n, p_, h_ * hd)
            x = x + self._stack(f"{p}.self_attn.o_proj.linear.weight", o)
            a = self._stack(f"{p}.mlp.fc1.weight", rms(x, self.sd[f"{p}.post_attention_layernorm.weight"], eps))
            f = a.shape[-1] // 2
            x = x + self._stack(f"{p}.mlp.fc2.weight", F.silu(a[..., :f]) * a[..., f:])
        return self.prec.act(x[:, -1]) @ self.sd[f"{pre}.lm_heads.weight"][p_ - 1].t()


def call_noise(seed: int, steps: int, first: int, decisions: int, v: int, device) -> torch.Tensor:
    """[steps, decisions, v] Gumbel noise of decisions first..first +
    decisions - 1 of steps 0..steps-1: the call's key (0, 0) under (0,
    seed), step g's (0, g) under it, decision d's (0, d) under that (d = 0
    the text token, 1 + k codebook k), vocab id u's uniform the block at
    (u, 0) under the decision's key."""
    z = torch.zeros((), dtype=torch.int64, device=device)
    s = torch.tensor(int(seed) & 0xFFFFFFFF, dtype=torch.int64, device=device)
    k = threefry(z, s, z, z)
    k = threefry(k[0], k[1], z, torch.arange(steps, device=device))
    d = torch.arange(first, first + decisions, device=device)
    k = threefry(k[0][:, None], k[1][:, None], z, d[None])
    bits, _ = threefry(k[0][..., None], k[1][..., None], torch.arange(v, device=device), 0)
    u = ((bits >> 9).to(torch.int32).float() + 0.5) * (2.0 ** -23)
    return -torch.log(-torch.log(u))
