"""CSM (Sesame's Conversational Speech Model) as plain PyTorch, from
transformers' `CsmForConditionalGeneration` names.

Written against transformers' `models/csm/modeling_csm.py` and Sesame's
`models.py` / `generator.py`:

- the frame embedding: per position, the masked sum of the 32 codebooks'
  code embeddings (codebook k's code c at row k * vocab_size + c of the
  backbone's audio table) and the text embedding, in that order (Sesame's
  `_embed_tokens` and the mask product);
- both transformers: RMSNorm (float32, eps), grouped-query attention with
  each kv head repeated for its query heads (`repeat_kv`), RoPE in the
  rotate-half layout with llama3-scaled frequencies (`_compute_llama3_parameters`),
  a causal mask, softmax in float32, SwiGLU (`down(silu(gate) * up)`), a
  final RMSNorm;
- codebook 0 from `lm_head` on the backbone's last hidden state; codebook i
  from `codebooks_head[i - 1]` on the depth decoder's hidden state at
  position i, over positions 0 (the backbone's last hidden state) and 1..i
  (codebooks 0..i-1's embeddings from the tied audio table), each projected
  by `inputs_embeds_projector`.

Departures: no KV cache. Every frame runs the backbone's full forward over
the whole sequence so far, and every codebook the depth decoder's full
forward over its positions; calls decoded together run as one batch, each
row right-padded to the longest and masked past its own length. Sampling is Sesame's `sample_topk` (temperature,
then the logits at or above the k-th largest) with Gumbel-max on the
program's keyed Threefry bits in place of the multinomial draw
(`cudabench.reference.sampler.threefry`; the keys as `sopro_tpu_torch`'s
`csm_engine` documents them).

Each decision also gives its score gap (best less runner-up, on the
Gumbel-perturbed scores) with the runner-up, and its top-k edge: the gap
between the k-th and (k+1)-th values, and the token drawn when those two
swap or both stay in, where it differs. The check follows either where it
lies within rounding.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from cudabench.reference.precision import Precision
from cudabench.reference.sampler import threefry


def inv_freq(hd: int, theta: float, scaling: Optional[Dict], device) -> torch.Tensor:
    base = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.int64, device=device).float() / hd))
    if not scaling:
        return base
    factor, old = float(scaling["factor"]), float(scaling["original_max_position_embeddings"])
    low, high = float(scaling["low_freq_factor"]), float(scaling["high_freq_factor"])
    wavelen = 2 * math.pi / base
    out = torch.where(wavelen > old / low, base / factor, base)
    smooth = (old / wavelen - low) / (high - low)
    smoothed = (1 - smooth) * out / factor + smooth * out
    medium = ~(wavelen < old / high) * ~(wavelen > old / low)
    return torch.where(medium, smoothed, out)


class Transformer:
    """One of CSM's two transformers over `sd` (names under `prefix`), with
    the widths of its config dict."""

    def __init__(self, sd: Dict[str, torch.Tensor], prefix: str, cfg: Dict, prec: Precision):
        self.sd, self.prefix, self.prec = sd, prefix, prec
        self.n = int(cfg["num_hidden_layers"])
        self.h, self.kvh = int(cfg["num_attention_heads"]), int(cfg["num_key_value_heads"])
        self.hd = int(cfg.get("head_dim") or int(cfg["hidden_size"]) // self.h)
        self.eps = float(cfg["rms_norm_eps"])
        dev = next(iter(sd.values())).device
        self.inv = inv_freq(self.hd, float(cfg["rope_theta"]), cfg.get("rope_scaling"), dev)

    def lin(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return self.prec.act(x) @ self.sd[f"{self.prefix}.{name}.weight"].t()

    def norm(self, name: str, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        return self.sd[f"{self.prefix}.{name}.weight"] * (
            x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps))

    def __call__(self, x: torch.Tensor, lengths: Optional[Sequence[int]] = None) -> torch.Tensor:
        """x [B, S, hidden] at positions 0..S-1 -> the final norm's output;
        row b's positions from `lengths[b]` on are padding no position
        attends to."""
        b_, s, h, kvh, hd = x.shape[0], x.shape[1], self.h, self.kvh, self.hd
        ang = torch.arange(s, device=x.device).float()[:, None] * self.inv[None]
        ang = torch.cat([ang, ang], -1)
        cos, sin = ang.cos(), ang.sin()
        rot = lambda z: torch.cat([-z[..., hd // 2:], z[..., : hd // 2]], -1)
        allowed = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()[None, None]
        if lengths is not None:
            valid = torch.arange(s, device=x.device)[None] < torch.tensor(lengths, device=x.device)[:, None]
            allowed = allowed & valid[:, None, None, :]
        heads = lambda z, n: z.view(b_, s, n, hd).transpose(1, 2)
        for i in range(self.n):
            p = f"layers.{i}"
            a = self.norm(f"{p}.input_layernorm", x)
            q = heads(self.lin(f"{p}.self_attn.q_proj", a), h)
            k = heads(self.lin(f"{p}.self_attn.k_proj", a), kvh)
            v = heads(self.lin(f"{p}.self_attn.v_proj", a), kvh)
            q, k = q * cos + rot(q) * sin, k * cos + rot(k) * sin
            k, v = (z[:, :, None].expand(b_, kvh, h // kvh, s, hd).reshape(b_, h, s, hd)
                    for z in (k, v))
            w = (self.prec.act(q) @ self.prec.act(k).transpose(-1, -2)) * hd ** -0.5
            w = torch.softmax(w.masked_fill(~allowed, float("-inf")), -1, dtype=torch.float32)
            o = (self.prec.act(w) @ self.prec.act(v)).transpose(1, 2).reshape(b_, s, h * hd)
            x = x + self.lin(f"{p}.self_attn.o_proj", o)
            a = self.norm(f"{p}.post_attention_layernorm", x)
            x = x + self.lin(f"{p}.mlp.down_proj",
                             F.silu(self.lin(f"{p}.mlp.gate_proj", a)) * self.lin(f"{p}.mlp.up_proj", a))
        return self.norm("norm", x)


class Csm:
    """The model over a flat state dict (transformers' names, tensors on the
    device) and the configuration's `csm` dict."""

    def __init__(self, sd: Dict[str, torch.Tensor], cfg: Dict, prec: Precision):
        self.sd = {k: prec.weight(v) for k, v in sd.items()}
        self.prec = prec
        self.q, self.v = int(cfg["num_codebooks"]), int(cfg["vocab_size"])
        self.eos = int(cfg["codebook_eos_token_id"])
        self.audio = self.sd["backbone_model.embed_tokens.embed_audio_tokens.weight"]
        self.backbone = Transformer(self.sd, "backbone_model", cfg, prec)
        self.depth = Transformer(self.sd, "depth_decoder.model", cfg["depth_decoder_config"], prec)

    def embed(self, tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """tokens, mask [S, Q + 1] (codes, then the text id) -> [S, hidden]."""
        off = torch.arange(self.q, device=tokens.device) * self.v
        e = torch.cat([self.audio[tokens[:, : self.q] + off],
                       self.sd["embed_text_tokens.weight"][tokens[:, self.q]][:, None]], 1)
        return (e * mask[..., None]).sum(1)

    def code_embed(self, codebook: int, code: torch.Tensor) -> torch.Tensor:
        return self.audio[code + codebook * self.v]

    def codebook0(self, x: torch.Tensor, lengths: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
        """The backbone over x [B, S, hidden], row b's first `lengths[b]`
        positions -> (each row's last hidden state [B, hidden], codebook 0's
        logits [B, V])."""
        at = torch.tensor(lengths, device=x.device) - 1
        h = self.backbone(x, lengths)[torch.arange(x.shape[0], device=x.device), at]
        return h, self.prec.act(h) @ self.sd["lm_head.weight"].t()

    def codebook(self, i: int, inputs: torch.Tensor) -> torch.Tensor:
        """Codebook i's logits [B, V] from the depth decoder over inputs [B,
        i + 1, backbone hidden] (positions 0..i)."""
        proj = self.sd["depth_decoder.model.inputs_embeds_projector.weight"]
        h = self.depth(self.prec.act(inputs) @ proj.t())[:, -1]
        return self.prec.act(h) @ self.sd["depth_decoder.codebooks_head.weight"][i - 1]


def frame_noise(seeds: Sequence[int], frame: int, q: int, v: int, device) -> torch.Tensor:
    """[B, Q, V] Gumbel noise of frame `frame`'s decisions, one row a seed:
    the call's key (0, 0) under (0, seed), the frame's (0, frame) under it,
    codebook i's (0, i) under that, vocab id u's uniform the block at (u, 0)."""
    z = torch.zeros((), dtype=torch.int64, device=device)
    s = torch.tensor([int(x) & 0xFFFFFFFF for x in seeds], dtype=torch.int64, device=device)
    k = threefry(z, s, z, z)
    k = threefry(k[0], k[1], z, frame)
    i = torch.arange(q, device=device)[None]
    k = threefry(k[0][:, None], k[1][:, None], z, i)
    bits, _ = threefry(k[0][..., None], k[1][..., None], torch.arange(v, device=device), 0)
    u = ((bits >> 9).to(torch.int32).float() + 0.5) * (2.0 ** -23)
    return -torch.log(-torch.log(u))


def sample(logits: torch.Tensor, noise: torch.Tensor, temperature: float,
           top_k: int) -> Tuple[torch.Tensor, ...]:
    """logits, noise [B, V] -> (token, score gap, runner-up, edge margin (inf:
    none), the token across the edge), each [B]."""
    b, v = logits.shape
    x = torch.nan_to_num(logits.float(), nan=-1e9, posinf=1e9, neginf=-1e9) / temperature
    k = min(int(top_k), v)
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    keep = x >= vals[:, k - 1: k]
    noisy = x + noise
    ids = torch.arange(v, device=x.device).expand(b, v)
    first = lambda sc: torch.where(sc == sc.amax(-1, keepdim=True), ids, v).amin(-1)
    score = torch.where(keep, noisy, float("-inf"))
    tok = first(score)
    top2, i2 = torch.topk(score, 2, -1)
    second = torch.where(i2[:, 0] == tok, i2[:, 1], i2[:, 0])
    gap = top2[:, 0] - top2[:, 1]
    margin = torch.full((b,), float("inf"), device=x.device)
    other = tok
    if k < v:
        # ranks k and k+1 swapped, or both in (a tie at the k-th value)
        kth, nxt = ids == idx[:, k - 1: k], ids == idx[:, k: k + 1]
        edge = vals[:, k - 1] - vals[:, k]
        for kept in ((keep & ~kth) | nxt, keep | nxt):
            alt = first(torch.where(kept, noisy, float("-inf")))
            better = (alt != tok) & (edge < margin)
            margin = torch.where(better, edge, margin)
            other = torch.where(better, alt, other)
    return tok, gap, second, margin, other
