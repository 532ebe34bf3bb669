"""Tensor-parallel primitives: the products and lookups of a leaf split over
the `tp` devices of one dp group (the layout of `parallel/tensor.py`).

A `Shards` stands in a parameter tree where a whole leaf would: `parts[t]`
lives on the group's t-th device and holds its block of the leaf along
`dim`. The ops that read sharded leaves dispatch on it (`ops/blocks.py`
`linear`, `glu` and the SSMLite FFN, the embedding lookups, the NAR heads,
`train._masked_ce`), so the model's functions run unchanged on a dp group's
tree. Each product runs on its shard's device; what comes back to the
group's first device (`home`) is a concat of activations or a sum of
partial products, in shard order. No op here puts a whole sharded leaf on
one device.

- column-parallel linear (w split on its output axis): the output stays
  split, a `Shards` of activations;
- row-parallel linear (w split on its input axis): the input is split to
  match (or already is), the partial products are summed at home;
- GLU: column-parallel with each shard holding its block of both halves
  (`[a_t | b_t]`), so a * sigmoid(b) is computed per shard and concatenated;
- FFN: ff1 column-parallel, GELU per shard, ff2 row-parallel, one sum;
- embeddings: a row-split table looks up its own rows (zero elsewhere) and
  the shards sum, a column-split table's lookups concatenate;
- cross-entropy over vocab-split logits: the max and the sum of exponents
  reduced over the shards, the target's logit from the shard that owns it.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F


class Shards:
    """A tensor split along `dim` into `parts` (one per tp device, in shard
    order); `device` is the first part's (the group's home)."""

    def __init__(self, parts: Sequence[torch.Tensor], dim: int):
        self.parts: List[torch.Tensor] = list(parts)
        self.dim = dim % self.parts[0].ndim

    @property
    def device(self) -> torch.device:
        return self.parts[0].device

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    def map(self, fn) -> "Shards":
        return Shards([fn(p) for p in self.parts], self.dim)


def _sum_home(terms, home) -> torch.Tensor:
    out = None
    for y in terms:
        y = y.to(home)
        out = y if out is None else out + y
    return out


def _bias_part(b, t: int, lo: int, hi: int, dev) -> torch.Tensor:
    return b.parts[t] if isinstance(b, Shards) else b[lo:hi].to(dev)


def linear(p, x):
    """x @ w (+ b) with w a `Shards`: split on its output axis (dim 1), the
    result is a `Shards` of the output's last axis; split on its input axis
    (dim 0), the partial products summed at x's home (+ b)."""
    w, b = p["w"], p.get("b")
    if w.dim == 1:
        parts, lo = [], 0
        for t, wt in enumerate(w.parts):
            y = x.to(wt.device) @ wt
            hi = lo + int(wt.shape[1])
            if b is not None:
                y = y + _bias_part(b, t, lo, hi, wt.device)
            parts.append(y)
            lo = hi
        return Shards(parts, -1)
    home = x.device
    xs = x.parts if isinstance(x, Shards) else torch.split(
        x, [int(wt.shape[0]) for wt in w.parts], dim=-1)
    y = _sum_home((xt.to(wt.device) @ wt for xt, wt in zip(xs, w.parts)), home)
    if b is not None:
        y = y + b.to(home)
    return y


def glu(p, x: torch.Tensor) -> torch.Tensor:
    """a * sigmoid(b) of `pro` = {"w", "b"} split on its output axis, each
    shard holding [a_t | b_t] (its block of both halves): the gates per
    shard, concatenated at x's device."""
    y = linear(p, x)
    outs = []
    for yt in y.parts:
        a, g = torch.chunk(yt, 2, dim=-1)
        outs.append((a * torch.sigmoid(g)).to(x.device))
    return torch.cat(outs, dim=-1)


def ffn(p1, p2, h: torch.Tensor) -> torch.Tensor:
    """ff2(gelu(ff1(h))): ff1 split on its output axis, ff2 on its input
    axis; one sum over the shards."""
    return linear(p2, linear(p1, h).map(F.gelu))


def take_rows(table, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] (an embedding lookup, rows [..., D]); a `Shards` table
    split on its rows gives each shard's rows (zero where another shard owns
    the row) summed at home, split on its columns the shards' lookups
    concatenated."""
    if not isinstance(table, Shards):
        return table[idx]
    home = table.device
    if table.dim == 1:
        return torch.cat([p[idx.to(p.device)].to(home) for p in table.parts], dim=-1)
    terms, lo = [], 0
    for p in table.parts:
        n = int(p.shape[0])
        local = idx.to(p.device) - lo
        hit = (local >= 0) & (local < n)
        terms.append(p[local.clamp(0, n - 1)] * hit[..., None].to(p.dtype))
        lo += n
    return _sum_home(terms, home)


def head_logits(zh: torch.Tensor, ws: Sequence[Shards], bs: Sequence) -> Shards:
    """Per-head logits [B, T, H, V] of the NAR heads with every head's w
    [hd, V] split on V: zh [B, T, H, hd] on each shard's device against the
    stacked shard weights, a `Shards` of the last axis."""
    parts, lo = [], 0
    for t in range(len(ws[0].parts)):
        dev = ws[0].parts[t].device
        w = torch.stack([wi.parts[t] for wi in ws])  # [H, hd, V_t]
        hi = lo + int(w.shape[-1])
        b = torch.stack([_bias_part(bi, t, lo, hi, dev) for bi in bs])  # [H, V_t]
        parts.append(torch.einsum("bthd,hdv->bthv", zh.to(dev), w) + b[None, None])
        lo = hi
    return Shards(parts, -1)


def nll(logits: Shards, targets: torch.Tensor) -> torch.Tensor:
    """-log_softmax(logits)[target] in float32 over logits split on the last
    (vocab) axis; [...] at home. The max is a constant of the graph (as in
    any stable log-sum-exp); the target's logit comes from the shard whose
    range holds it."""
    home = logits.device
    parts = [p.float() for p in logits.parts]
    m = torch.stack([p.amax(dim=-1).to(home) for p in parts]).amax(dim=0).detach()
    se = _sum_home((torch.exp(p - m.to(p.device)[..., None]).sum(dim=-1) for p in parts), home)
    terms, lo = [], 0
    for p in parts:
        n = int(p.shape[-1])
        local = targets.long().to(p.device) - lo
        hit = (local >= 0) & (local < n)
        val = torch.gather(p, -1, local.clamp(0, n - 1)[..., None])[..., 0]
        terms.append(val * hit.to(val.dtype))
        lo += n
    return m + torch.log(se) - _sum_home(terms, home)
