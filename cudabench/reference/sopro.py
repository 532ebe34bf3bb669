"""Sopro v1.5 as plain PyTorch, from its published checkpoint names.

Written against samuel-vitorino/sopro (`src/sopro/nn/*`, `model.py`): the
text encoder, Token2SV, the speaker FiLM, the reference encoder and its
gated cross-attention, the AR generator (causal dilated SSMLite blocks, a
text cross-attention after every second block, a head over codebook_size + 1
ids) and the NAR refiner (one non-causal trunk per stage, a stage FiLM, the
mix of conditioning and earlier codebooks, greedy heads with head-id
offsets). It reads the flat state dict the harness made (torch layouts,
published names) and nothing of the program under test.

Precision (`Precision`): every weight is rounded once to the configuration's
compute dtype; every product rounds its inputs to that dtype and accumulates
in float32; the residual streams, norms, softmaxes and the sampler are
float32. In float32 that is the plain float32 model (TF32 is off unless a
control turns it on). No input is padded: each session runs at its own
lengths.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from cudabench.reference import sampler as S
from cudabench.reference.precision import Precision

TEXT_HEADS = 4


def sinusoid(d: int, n: int) -> torch.Tensor:
    pos = np.arange(n, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float32) * (-math.log(10000.0) / d))
    pe = np.zeros((n, d), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return torch.from_numpy(pe)


class Sopro:
    """The model over a flat state dict `sd` (name -> tensor on the device)
    and the published widths `cfg` (the configuration file's dict)."""

    def __init__(self, sd: Dict[str, torch.Tensor], cfg: Dict, prec: Precision):
        self.sd = {k: prec.weight(v) for k, v in sd.items()}
        self.cfg = cfg
        self.prec = prec
        self.d = int(cfg["d_model"])
        self.q = int(cfg["num_codebooks"])
        self.v = int(cfg["codebook_size"])
        dev = next(iter(self.sd.values())).device
        self.text_pos = sinusoid(self.d, int(cfg["max_text_len"]) + 8).to(dev)
        self.frame_pos = sinusoid(self.d, int(cfg["pos_emb_max"]) + 8).to(dev)
        n = int(cfg["n_layers_ar"])
        self.ar_dils = [int(cfg["ar_dilation_cycle"][i % len(cfg["ar_dilation_cycle"])])
                        for i in range(n)]
        self.ar_xattn = [(i + 1) % int(cfg["ar_text_attn_freq"]) == 0 for i in range(n)]
        m = int(cfg["n_layers_nar"])
        self.nar_dils = [int(cfg["nar_dilation_cycle"][i % len(cfg["nar_dilation_cycle"])])
                         for i in range(m)]
        self.stages = {}
        for s in ("B", "C", "D", "E"):
            lo, hi = cfg[f"stage_{s}"]
            idx = [i for i in range(int(lo) - 1, int(hi)) if 1 <= i < self.q]
            if idx:
                self.stages[s] = idx
        self.rf_nar = 1 + (int(cfg["nar_kernel_size"]) - 1) * sum(self.nar_dils)

    # -- primitives ------------------------------------------------------

    def w(self, name: str) -> torch.Tensor:
        return self.sd[name]

    def linear(self, name: str, x: torch.Tensor) -> torch.Tensor:
        y = self.prec.act(x) @ self.w(f"{name}.weight").t()
        b = self.sd.get(f"{name}.bias")
        return y if b is None else y + b

    def rms(self, name: str, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * self.w(f"{name}.weight")

    def ln(self, name: str, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + eps) * self.w(f"{name}.weight") + self.w(f"{name}.bias")

    def dwconv(self, name: str, x: torch.Tensor, k: int, dil: int, causal: bool) -> torch.Tensor:
        """Depthwise conv over [B, T, D], same length (causal: all padding
        on the left; else the odd sample on the right)."""
        total = (k - 1) * dil
        left = total if causal else total // 2
        xt = F.pad(self.prec.act(x).transpose(1, 2), (left, total - left))
        y = F.conv1d(xt, self.w(f"{name}.weight"), self.sd.get(f"{name}.bias"), dilation=dil,
                     groups=x.shape[-1])
        return y.transpose(1, 2)

    def ssmlite(self, name: str, x: torch.Tensor, k: int, dil: int, causal: bool,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        a, b = self.linear(f"{name}.glu.pro", self.rms(f"{name}.norm", x)).chunk(2, -1)
        h = a * torch.sigmoid(b)
        if mask is not None:
            h = h * mask[..., None]
        x = x + self.dwconv(f"{name}.dw.dw", h, k, dil, causal)
        h = self.rms(f"{name}.ff.0", x)
        return x + self.linear(f"{name}.ff.3", F.gelu(self.linear(f"{name}.ff.1", h)))

    @staticmethod
    def heads(x: torch.Tensor, n: int) -> torch.Tensor:
        b, t, d = x.shape
        return x.reshape(b, t, n, d // n).transpose(1, 2)

    def kv(self, name: str, ctx: torch.Tensor, n: int):
        c = self.rms(f"{name}.nkv", ctx)
        return (self.heads(self.linear(f"{name}.k_proj", c), n),
                self.heads(self.linear(f"{name}.v_proj", c), n))

    def attend(self, q, k, v) -> torch.Tensor:
        """Softmax attention over every key (no input is padded)."""
        a = torch.softmax((self.prec.act(q) @ self.prec.act(k).transpose(-1, -2))
                          / math.sqrt(q.shape[-1]), dim=-1)
        o = self.prec.act(a) @ self.prec.act(v)
        b, h, t, hd = o.shape
        return o.transpose(1, 2).reshape(b, t, h * hd)

    # -- conditioning ----------------------------------------------------

    def text(self, ids: torch.Tensor):
        """ids [1, L] -> (sequence [1, L, D], pooled [1, D])."""
        x = self.w("text_enc.embed.emb.weight")[ids.long()] + self.text_pos[: ids.shape[1]]
        for i in range(int(self.cfg["n_layers_text"])):
            x = self.ssmlite(f"text_enc.layers.{i}", x, 7, 1, False)
        x = self.rms("text_enc.norm", x)
        return x, x.mean(1)

    def token2sv(self, ref: torch.Tensor) -> torch.Tensor:
        """ref [1, T, Q] -> unit speaker vector [1, sv]."""
        q = torch.arange(self.q, device=ref.device)
        raw = self.w("token2sv.emb.weight")[q * self.v + ref.long()]  # [1, T, Q, 192]
        wq = torch.softmax(self.w("token2sv.cb_weights"), 0)
        x = (raw * wq[:, None]).sum(2)
        h = F.gelu(self.dwconv("token2sv.enc.0.dw", x, 7, 1, False))
        h = F.gelu(self.dwconv("token2sv.enc.3.dw", h, 7, 1, False))
        a = self.linear("token2sv.pool.attn.2", torch.tanh(self.linear("token2sv.pool.attn.0", h)))
        wt = torch.softmax(a[..., 0], dim=1)[..., None]
        mu = (h * wt).sum(1)
        std = torch.sqrt(((h - mu[:, None]) ** 2 * wt).sum(1).clamp(min=1e-6))
        e = self.linear("token2sv.proj", torch.cat([mu, std], -1))
        return e / e.norm(dim=-1, keepdim=True).clamp(min=1e-6)

    def cb_sum(self, tokens: torch.Tensor, cbs: Sequence[int], weights: torch.Tensor) -> torch.Tensor:
        """Softmax(weights[cbs])-weighted sum of codebook embeddings, summed
        codebook by codebook. tokens [B, T, K]."""
        table = self.w("cb_embed.emb.weight")
        idx = torch.as_tensor(list(cbs), device=tokens.device)
        wk = torch.softmax(weights[idx], 0)
        out = table[idx[0] * self.v + tokens[..., 0].long()] * wk[0]
        for j in range(1, len(cbs)):
            out = out + table[idx[j] * self.v + tokens[..., j].long()] * wk[j]
        return out

    def reference(self, ref_tokens: torch.Tensor) -> Dict:
        """A reference voice [T, Q] -> its speaker vector and cross-attention KV."""
        ref = ref_tokens[None]
        x = self.cb_sum(ref, range(self.q), self.w("ref_cb_weights"))
        for i in range(int(self.cfg["ref_enc_layers"])):
            x = self.ssmlite(f"ref_enc_blocks.{i}", x, 7, 1, False)
        seq = self.rms("ref_enc_norm", x)
        n = int(self.cfg["ref_xattn_heads"])
        return {"sv": self.token2sv(ref),
                "kv": [self.kv(f"ref_xattn.blocks.{i}", seq, n)
                       for i in range(int(self.cfg["ref_xattn_layers"]))]}

    def conditioning(self, ids: torch.Tensor, ref: Dict, frames: int, strength: float):
        """-> (per-frame conditioning [1, frames, D], the AR's text KV)."""
        seq, pool = self.text(ids)
        x = pool[:, None] + self.frame_pos[:frames][None]
        film = self.linear("spk_film.mlp.2", F.gelu(self.linear("spk_film.mlp.0", ref["sv"])))
        g, b = film.chunk(2, -1)
        s = float(strength)
        x = self.ln("spk_film.norm", x) * (1 + s * torch.tanh(g)[:, None]) + s * torch.tanh(b)[:, None]
        n = int(self.cfg["ref_xattn_heads"])
        gmax = float(self.cfg["ref_xattn_gmax"])
        for i, (k, v) in enumerate(ref["kv"]):
            name = f"ref_xattn.blocks.{i}"
            a = self.attend(self.heads(self.linear(f"{name}.q_proj", self.rms(f"{name}.nq", x)), n), k, v)
            rms = lambda z: torch.sqrt((z * z).mean(-1, keepdim=True) + 1e-6)
            a = self.linear(f"{name}.out_proj", a * torch.clamp(rms(x) / rms(a), 0.0, 10.0))
            x = x + gmax * torch.tanh(self.w(f"{name}.gate")) * a
        cond = self.rms("cond_norm", x)
        text_kv = [self.kv(f"ar.x_attns.{i}", seq, TEXT_HEADS) if self.ar_xattn[i] else None
                   for i in range(len(self.ar_dils))]
        return cond, text_kv

    # -- AR decode -------------------------------------------------------

    def ar_step(self, x: torch.Tensor, bufs: List[torch.Tensor], kvs: List) -> torch.Tensor:
        """One step of every row: x [B, D]; bufs[i] [B, (k-1)*dil+1, D]
        oldest-first (updated in place); kvs[i] per row lists of (k, v)."""
        k = int(self.cfg["ar_kernel"])
        h = x
        for i, dil in enumerate(self.ar_dils):
            name = f"ar.blocks.{i}"
            a, b = self.linear(f"{name}.glu.pro", self.rms(f"{name}.norm", h)).chunk(2, -1)
            bufs[i] = torch.cat([bufs[i][:, 1:], self.prec.act(a * torch.sigmoid(b))[:, None]], 1)
            taps = bufs[i][:, ::dil]  # [B, k, D], oldest first
            wdw = self.w(f"{name}.dw.dw.weight")[:, 0, :]  # [D, k]
            h = h + torch.einsum("bkd,dk->bd", taps, wdw) + self.w(f"{name}.dw.dw.bias")
            f = self.rms(f"{name}.ff.0", h)
            h = h + self.linear(f"{name}.ff.3", F.gelu(self.linear(f"{name}.ff.1", f)))
            if kvs[i] is not None:
                xn = f"ar.x_attns.{i}"
                q = self.linear(f"{xn}.q_proj", self.rms(f"{xn}.nq", h))  # [B, D]
                outs = []
                for r, (kk, vv) in enumerate(kvs[i]):
                    outs.append(self.attend(self.heads(q[r:r + 1, None], TEXT_HEADS), kk, vv)[:, 0])
                h = h + torch.tanh(self.w(f"{xn}.gate")) * self.linear(f"{xn}.out_proj",
                                                                       torch.cat(outs))
        return self.linear("ar.head", self.rms("ar.norm", h))

    def ar_decode(self, conds: List[torch.Tensor], text_kvs: List, seeds: Sequence[int],
                  steps: Sequence[int], top_p: Sequence[float], temp: Sequence[float],
                  rec_top_p: Sequence[float], rec_temp: Sequence[float],
                  force: Optional[Sequence[Dict[int, int]]] = None):
        """Decode every row for its own number of `steps` (all rows run
        max(steps) steps; a row's tokens past its own are not used);
        `force[r]` ({step: token}) sets row r's token at those steps.
        -> (tokens [B, T] int64, score gaps [B, T], runner-up ids [B, T],
        edge margins [B, T], the ids drawn across those edges [B, T], first
        EOS step [B] or T)."""
        dev = conds[0].device
        n = max(int(s) for s in steps)
        b = len(conds)
        cond = torch.cat([c[:, :n] for c in conds])  # [B, n, D]
        k = int(self.cfg["ar_kernel"])
        bufs = [torch.zeros((b, (k - 1) * dil + 1, self.d), device=dev) for dil in self.ar_dils]
        kvs = [None if text_kvs[0][i] is None else [kv[i] for kv in text_kvs]
               for i in range(len(self.ar_dils))]
        table = self.w("cb_embed.emb.weight")
        bos = table[self.q * self.v]
        key = S.session_keys(seeds, dev)
        hist = torch.full((b, S.HIST), -1, dtype=torch.int64, device=dev)
        streak = torch.zeros(b, dtype=torch.int64, device=dev)
        last = torch.zeros(b, dtype=torch.int64, device=dev)
        f32 = lambda v: torch.tensor([float(x) for x in v], device=dev)
        tp, tm, rtp, rtm = f32(top_p), f32(temp), f32(rec_top_p), f32(rec_temp)
        toks = torch.zeros((b, n), dtype=torch.int64, device=dev)
        gaps = torch.zeros((b, n), device=dev)
        seconds = torch.zeros((b, n), dtype=torch.int64, device=dev)
        margins = torch.zeros((b, n), device=dev)
        others = torch.zeros((b, n), dtype=torch.int64, device=dev)
        forced = torch.full((b, n), -1, dtype=torch.int64)
        for r, fr in enumerate(force or []):
            for t, tk in fr.items():
                if t < n:
                    forced[r, t] = int(tk)
        forced = forced.to(dev)
        eos = int(self.v)
        for t in range(n):
            prev = bos.expand(b, -1) if t == 0 else table[last]
            tt = torch.full((b,), t, device=dev)
            rec = S.recovering(hist, tt, streak)
            logits = self.ar_step(cond[:, t] + prev, bufs, kvs)
            key, sub = S.split(key)
            tok, gap, second, margin, other = S.sample(logits, hist, sub, torch.where(rec, rtp, tp),
                                                       torch.where(rec, rtm, tm))
            tok = torch.where(forced[:, t] >= 0, forced[:, t], tok)
            streak = torch.where((tok == last) & (tt > 0), streak + 1, torch.zeros_like(streak))
            last = tok
            hist = torch.cat([hist[:, 1:], tok[:, None]], 1)
            toks[:, t], gaps[:, t], seconds[:, t] = tok, gap, second
            margins[:, t], others[:, t] = margin, other
        is_eos = toks == eos
        first_eos = torch.where(is_eos.any(1), is_eos.float().argmax(1),
                                torch.full((b,), n, device=dev)).long()
        return toks, gaps, seconds, margins, others, first_eos

    # -- NAR refine ------------------------------------------------------

    def nar(self, cond: torch.Tensor, rvq: torch.Tensor, mask: torch.Tensor, tail: int,
            force: Optional[torch.Tensor] = None):
        """Windows cond [N, w, D], codebook-1 ids [N, w], mask [N, w] ->
        (codes of the last `tail` frames [N, tail, Q], and per window
        position [N, w] the smallest top-2 logit gap over the heads that
        predict there, that head's codebook and its runner-up id).
        `force` [N, w, Q] (-1: none) sets a head's id at a position, for
        every stage after it too."""
        nw, w, _ = cond.shape
        dev = cond.device
        out = torch.zeros((nw, tail, self.q), dtype=torch.int64, device=dev)
        out[:, :, 0] = rvq[:, w - tail:]
        gap = torch.full((nw, w), float("inf"), device=dev)
        gap_cb = torch.zeros((nw, w), dtype=torch.int64, device=dev)
        second = torch.zeros((nw, w), dtype=torch.int64, device=dev)
        prev, cbs = rvq[..., None], [0]
        maskf = mask.float()
        order = list(self.stages)
        for sid, s in enumerate(order):
            pe = self.cb_sum(prev, cbs, self.w("nar_prev_cb_weights"))
            mix = torch.softmax(self.w(f"nar.mix.{s}"), 0)
            x = mix[0] * cond + mix[1] * pe
            sv = self.w("nar.stage_emb.weight")[sid]
            g, b = self.linear("nar.adapter.mlp.2",
                               F.gelu(self.linear("nar.adapter.mlp.0", sv))).chunk(2, -1)
            x = self.rms("nar.adapter.norm", x) * (1 + torch.tanh(g)) + torch.tanh(b)
            for i, dil in enumerate(self.nar_dils):
                x = self.ssmlite(f"nar.blocks.{i}", x, int(self.cfg["nar_kernel_size"]), dil,
                                 False, maskf)
            last = s == order[-1]
            lo = w - tail if last else 0
            if last:
                x = x[:, lo:]
            z = self.linear("nar.pre", self.rms("nar.norm", x))
            preds = []
            for h, cb in enumerate(self.stages[s]):
                zh = z + self.w(f"nar.head_id_emb.{s}.weight")[h]
                lg = self.linear(f"nar.heads.{s}.{h}", zh)
                top2, idx2 = torch.topk(lg, 2, dim=-1)
                pred = lg.argmax(-1)
                if force is not None:
                    fc = force[:, lo:, cb]
                    pred = torch.where(fc >= 0, fc, pred)
                preds.append(pred)
                g = top2[..., 0] - top2[..., 1]
                smaller = g < gap[:, lo:]
                gap[:, lo:] = torch.where(smaller, g, gap[:, lo:])
                gap_cb[:, lo:] = torch.where(smaller, cb, gap_cb[:, lo:])
                runner = torch.where(idx2[..., 0] == pred, idx2[..., 1], idx2[..., 0])
                second[:, lo:] = torch.where(smaller, runner, second[:, lo:])
                out[:, :, cb] = pred[:, -tail:]
            if not last:
                prev = torch.cat([prev, torch.stack(preds, -1)], -1)
                cbs = cbs + self.stages[s]
        return out, (gap, gap_cb, second)
