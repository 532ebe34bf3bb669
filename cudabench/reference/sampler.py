"""Sopro's AR sampler as plain PyTorch, with its random bits.

Random bits: Threefry-2x32 with 20 rounds (Salmon et al., "Parallel random
numbers: as easy as 1, 2, 3", SC 2011), keyed and split as JAX's
`jax.random` does under `jax_threefry_partitionable`. A session's key is the
block at counters (0, 0) under key (0, seed); each step splits it into the
next key (counters (0, 0)) and a subkey (counters (1, 0)); the subkey's block
at counters (id, 0) gives vocabulary id `id` its uniform, turned into Gumbel
noise. uint32 arithmetic is held in int64 with a 32-bit mask.

The sampler: temperature, a CTRL repetition penalty over the last 50 tokens,
top-k 50 and the nucleus by 26-step threshold bisections snapped to element
values, Gumbel-max over the nucleus; argmax where the nucleus is empty. The
anti-loop rule switches a row to its recovery settings while its history
tail repeats (a cycle of 3 to 16 tokens, or one token 8 times).

`sample` also returns each row's score gap, the best score less the
runner-up's (the Gumbel-perturbed logit for a sampled row, the logit for an
argmax row), and the runner-up's id. A different token than the
reference's can only come from a row whose gap is within rounding, or from
a top-k set or nucleus whose edge is, where the set across that edge draws
another token: a nucleus whose mass without its last token, or with the
next, lies within rounding of top_p, or two tokens at an edge whose values
lie that close (a bisection cannot part them closer than its resolution).
`sample` returns the smallest such margin and the token drawn across it.
The check tries either there to tell a near-tie from a fault.
"""

from __future__ import annotations

from typing import Tuple

import torch

HIST = 50
TOP_K = 50
PENALTY = 1.1
LOOP_STREAK = 8
BISECT = 26
MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry(k0, k1, c0, c1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32, 20 rounds, on int64-held uint32 values (broadcast)."""
    dev = next((t.device for t in (k0, k1, c0, c1) if isinstance(t, torch.Tensor)), None)
    k0, k1, c0, c1 = (torch.as_tensor(v, dtype=torch.int64, device=dev) & MASK32
                      for v in (k0, k1, c0, c1))
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0, x1 = (c0 + ks[0]) & MASK32, (c1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def session_keys(seeds, device) -> torch.Tensor:
    """[B, 2]: each session's first key."""
    s = torch.tensor([int(x) for x in seeds], dtype=torch.int64, device=device)
    a, b = threefry(0, s, 0, 0)
    return torch.stack([a, b], -1)


def split(key: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, 2] -> (next key, subkey)."""
    a = threefry(key[:, 0], key[:, 1], 0, 0)
    b = threefry(key[:, 0], key[:, 1], 1, 0)
    return torch.stack(a, -1), torch.stack(b, -1)


def _uniform(bits: torch.Tensor) -> torch.Tensor:
    return ((bits >> 9).to(torch.int32).float() + 0.5) * (2.0 ** -23)


def recovering(hist: torch.Tensor, t: torch.Tensor, streak: torch.Tensor) -> torch.Tensor:
    """[B] bool: the history tail is a cycle of 3..16 tokens, or one token
    repeated LOOP_STREAK times."""
    h = hist.shape[1]
    out = (t > 0) & (streak >= LOOP_STREAK)
    for n in range(3, 17):
        out |= torch.all(hist[:, h - n:] == hist[:, h - 2 * n: h - n], dim=1) & (t >= 2 * n)
    return out


def _nucleus(xp: torch.Tensor, keep1: torch.Tensor, top_p: torch.Tensor):
    """The nucleus over the top-k set `keep1`: (p [B, V], max [B, 1], keep2
    [B, V])."""
    inf = torch.full_like(xp, float("inf"))
    m = torch.where(keep1, xp, -inf).amax(-1, keepdim=True)
    e = torch.where(keep1, torch.exp(xp - m), torch.zeros_like(xp))
    p = e / e.sum(-1, keepdim=True).clamp(min=1e-30)
    lo = torch.zeros_like(m)
    hi = lo + 1.0
    for _ in range(BISECT):
        mid = 0.5 * (lo + hi)
        over = torch.where(p > mid, p, torch.zeros_like(p)).sum(-1, keepdim=True) > top_p[:, None]
        lo, hi = torch.where(over, mid, lo), torch.where(over, hi, mid)
    c = torch.where(keep1 & (p > lo), p, inf).amin(-1, keepdim=True)
    return p, m, keep1 & ((p >= c) | (xp == m))


def _sorted(key: torch.Tensor, within: torch.Tensor, xp: torch.Tensor):
    """Over the ids of `within` by `key`, largest first: the id at 0-based
    positions [B, 1] (-1: no such position), and the xp gap between the ids
    at two positions."""
    n = within.sum(-1, keepdim=True)
    order = torch.sort(torch.where(within, key, torch.full_like(key, -float("inf"))), -1,
                       descending=True)[1]
    at = lambda j: torch.where((j >= 0) & (j < n), order.gather(1, j.clamp(0, key.shape[1] - 1)),
                               torch.full_like(j, -1))
    gap = lambda i, j: (xp.gather(1, at(i).clamp(min=0)) - xp.gather(1, at(j).clamp(min=0))).abs()
    return at, gap


def sample(logits: torch.Tensor, hist: torch.Tensor, sub: torch.Tensor, top_p: torch.Tensor,
           temp: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """logits [B, V] float32, hist [B, HIST] (-1 empty), subkeys [B, 2],
    top_p / temp [B] -> (token [B] int64, score gap [B] float32, runner-up
    [B] int64, edge margin [B] float32 (inf: none), the token of the set
    across that edge [B] int64)."""
    b, v = logits.shape
    dev = logits.device
    ids = torch.arange(v, device=dev).expand(b, v)
    x = torch.nan_to_num(logits.float(), nan=-1e9, posinf=1e9, neginf=-1e9) / temp[:, None]
    member = torch.zeros((b, v + 1), dtype=torch.bool, device=dev)
    member.scatter_(1, torch.where(hist >= 0, hist, torch.full_like(hist, v)).long(), True)
    member = member[:, :v]
    xp = torch.where(member, torch.where(x < 0, x * PENALTY, x / PENALTY), x)

    lo = xp.amin(-1, keepdim=True) - 1.0
    hi = xp.amax(-1, keepdim=True)
    for _ in range(BISECT):
        mid = 0.5 * (lo + hi)
        over = (xp >= mid).sum(-1, keepdim=True) > TOP_K
        lo, hi = torch.where(over, mid, lo), torch.where(over, hi, mid)
    inf = torch.full_like(xp, float("inf"))
    keep1 = xp >= torch.where(xp >= hi, xp, inf).amin(-1, keepdim=True)
    p, m, keep2 = _nucleus(xp, keep1, top_p)
    degenerate = (~torch.isfinite(m) | (torch.where(keep2, p, torch.zeros_like(p))
                                        .sum(-1, keepdim=True) <= 1e-12))[:, 0]

    bits, _ = threefry(sub[:, 0:1], sub[:, 1:2], ids, 0)
    noisy = xp - torch.log(-torch.log(_uniform(bits)))
    first = lambda sc: torch.where(sc == sc.amax(-1, keepdim=True), ids,
                                   torch.full_like(ids, v)).amin(-1)
    score = torch.where(keep2, noisy, -inf)
    score = torch.where(degenerate[:, None], x, score)
    top2, idx2 = torch.topk(score, 2, dim=-1)
    tok = first(score)
    gap = (top2[:, 0] - top2[:, 1]).float()
    second = torch.where(idx2[:, 0] == tok, idx2[:, 1], idx2[:, 0])

    # The sets across an edge that rounding can move. The nucleus (k tokens
    # by p): less its last, or with the next in, where its mass is within
    # the margin of top_p; with the next in, or its last swapped for the
    # next, where their xp are that close; and where its last two are too
    # close for the bisection to part (their p within 2^-26, so both stayed
    # in though the first k - 1 pass top_p), less either of them. The top-k
    # set (by xp): less its last, or the two swapped, where their xp are
    # that close, and with the next in where it holds fewer than TOP_K
    # because the next two could not be parted; each with its nucleus
    # worked out again.
    one = lambda i: ids == i
    k = keep2.sum(-1, keepdim=True)
    at, xgap = _sorted(p, keep1, xp)
    mass = torch.cumsum(torch.sort(torch.where(keep1, p, torch.zeros_like(p)), -1,
                                   descending=True)[0].double(), -1)
    edge = lambda j: (mass.gather(1, j.clamp(min=0)) - top_p[:, None].double()).abs().float()
    apart = mass.gather(1, (k - 2).clamp(min=0)) > top_p[:, None].double()
    alts = [  # (margin [B, 1], the set across it [B, V], valid [B, 1])
        (torch.where(apart, xgap(k - 2, k - 1), edge(k - 2)), keep2 & ~one(at(k - 1)), k >= 2),
        (xgap(k - 2, k - 1), keep2 & ~one(at(k - 2)), (k >= 3) & apart),
        (torch.minimum(edge(k - 1), xgap(k - 1, k)), keep2 | one(at(k)), at(k) >= 0),
        (xgap(k - 1, k), (keep2 & ~one(at(k - 1))) | one(at(k)), (k >= 2) & (at(k) >= 0)),
    ]
    n1 = keep1.sum(-1, keepdim=True)
    at1, xgap1 = _sorted(xp, torch.ones_like(keep1), xp)
    for m1, k1, valid in (
            (xgap1(n1 - 1, n1), keep1 & ~one(at1(n1 - 1)), (n1 >= 2) & (at1(n1) >= 0)),
            (xgap1(n1 - 1, n1), (keep1 & ~one(at1(n1 - 1))) | one(at1(n1)), at1(n1) >= 0),
            (xgap1(n1, n1 + 1), keep1 | one(at1(n1)), (n1 < TOP_K) & (at1(n1 + 1) >= 0))):
        alts.append((m1, _nucleus(xp, k1, top_p)[2], valid))
    margin = torch.full_like(gap, float("inf"))
    other = tok.clone()
    for mg, kept, valid in alts:
        alt = first(torch.where(kept, noisy, -inf))
        better = valid[:, 0] & ~degenerate & (alt != tok) & (mg[:, 0] < margin)
        margin = torch.where(better, mg[:, 0], margin)
        other = torch.where(better, alt, other)
    return (tok, torch.where(torch.isfinite(gap), gap, torch.full_like(gap, float("inf"))), second,
            margin, other)
