"""On-device sampling with the reference's history heuristics
(counterpart: sopro_tpu/sampling.py).

Random bits come from an explicit Threefry-2x32 stream that is bit-identical
to the JAX package's (and to `jax.random.PRNGKey` / `split` under
`jax_threefry_partitionable`), so one seed gives one token sequence on every
path. uint32 arithmetic is emulated exactly in int64 with `& 0xFFFFFFFF`.

History buffer: [B, HIST_LEN] int32/int64, newest token at index H-1, -1 for
never-written slots.
"""

from __future__ import annotations

from typing import Tuple

import torch

HIST_LEN = 50  # repetition-penalty window
CYCLE_MAX_N = 16  # max cycle length checked
CYCLE_MIN_N = 3
BISECT_ITERS = 26

_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)
THREEFRY_C240 = 0x1BD11BDA
_M32 = 0xFFFFFFFF


def _u32(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M32
    return torch.as_tensor(x, dtype=torch.int64, device=device) & _M32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1) -> Tuple[torch.Tensor, torch.Tensor]:
    """20-round Threefry-2x32 over uint32 values held in int64 tensors
    (broadcastable)."""
    dev = next((t.device for t in (k0, k1, x0, x1) if isinstance(t, torch.Tensor)), None)
    k0, k1, x0, x1 = (_u32(v, dev) for v in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ THREEFRY_C240)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i, rots in enumerate((_ROT_A, _ROT_B, _ROT_A, _ROT_B, _ROT_A)):
        for r in rots:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` key data [2] (int64-held uint32): the high
    word is 0 for every int32 seed, the low word the seed's two's-complement
    bits."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64, device=device)


def split_rows(key: torch.Tensor, num: int) -> torch.Tensor:
    """`jax.random.split(key, num)` under jax_threefry_partitionable (the
    default since JAX 0.5): row i is the Threefry block at counters (0, i).
    key [2] -> [num, 2]."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    a, b = threefry2x32(key[0], key[1], 0, i)
    return torch.stack([a, b], dim=-1)


def split_keys(key: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """key [..., 2] -> (next_key, subkey): Threefry blocks at counters (0,0)
    and (1,0) -- the per-step key chain of the decode loop."""
    k0, k1 = key[..., 0], key[..., 1]
    a0, a1 = threefry2x32(k0, k1, 0, 0)
    b0, b1 = threefry2x32(k0, k1, 1, 0)
    return torch.stack([a0, a1], -1), torch.stack([b0, b1], -1)


def _uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    m = (bits >> 9).to(torch.int32)  # 23-bit mantissa, exact in f32
    return (m.float() + 0.5) * (2.0 ** -23)


def uniform_for_ids(key: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """uniform(0,1) floats as a pure function of (key, id): one Threefry
    block per id at counters (id, 0). key [..., 2]; ids [..., N] -> [..., N]."""
    bits, _ = threefry2x32(key[..., 0:1], key[..., 1:2], ids, 0)
    return _uniform_from_bits(bits)


def sample_full_vocab(
    k0: torch.Tensor,  # [B, 1] subkey halves (split_keys()[1])
    k1: torch.Tensor,
    logits: torch.Tensor,  # [B, V] f32
    member: torch.Tensor,  # [B, V] bool: repetition-penalty membership
    top_p: torch.Tensor,  # [B, 1] f32
    temp: torch.Tensor,  # [B, 1] f32
    *,
    top_k: int = 50,
    repetition_penalty: float = 1.1,
) -> torch.Tensor:
    """The one sampler body, op for op as in the JAX package: temperature,
    CTRL-style repetition penalty, top-k and nucleus by 26-step threshold
    bisections snapped to element values, Gumbel-max with noise keyed by
    vocab id, degenerate fallback to argmax. Returns tok [B, 1] int64."""
    b, v = logits.shape
    iota_v = torch.arange(v, device=logits.device).expand(b, v)
    x = torch.nan_to_num(logits.float(), nan=-1e9, posinf=1e9, neginf=-1e9) / temp
    pen = repetition_penalty
    xp = torch.where(member, torch.where(x < 0.0, x * pen, x / pen), x)

    k = min(int(top_k), v)
    lo = torch.amin(xp, dim=-1, keepdim=True) - 1.0
    hi = torch.amax(xp, dim=-1, keepdim=True)
    for _ in range(BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        over = torch.sum((xp >= mid).to(torch.int32), dim=-1, keepdim=True) > k
        lo, hi = torch.where(over, mid, lo), torch.where(over, hi, mid)
    inf = torch.full_like(xp, float("inf"))
    thr = torch.amin(torch.where(xp >= hi, xp, inf), dim=-1, keepdim=True)
    keep1 = xp >= thr

    m = torch.amax(torch.where(keep1, xp, -inf), dim=-1, keepdim=True)
    e = torch.where(keep1, torch.exp(xp - m), torch.zeros_like(xp))
    z = torch.sum(e, dim=-1, keepdim=True)
    p = e / torch.clamp(z, min=1e-30)
    degenerate = ~torch.isfinite(m)

    lo = torch.zeros((b, 1), dtype=torch.float32, device=logits.device)
    hi = lo + 1.0
    for _ in range(BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        mass = torch.sum(torch.where(p > mid, p, torch.zeros_like(p)), dim=-1, keepdim=True)
        over = mass > top_p
        lo, hi = torch.where(over, mid, lo), torch.where(over, hi, mid)
    c = torch.amin(torch.where(keep1 & (p > lo), p, inf), dim=-1, keepdim=True)
    keep2 = keep1 & ((p >= c) | (xp == m))
    mass2 = torch.sum(torch.where(keep2, p, torch.zeros_like(p)), dim=-1, keepdim=True)
    degenerate = degenerate | (mass2 <= 1e-12)

    bits, _ = threefry2x32(k0, k1, iota_v, 0)
    gum = -torch.log(-torch.log(_uniform_from_bits(bits)))
    score = torch.where(keep2, xp + gum, -inf)
    ms = torch.amax(score, dim=-1, keepdim=True)
    big = torch.full_like(iota_v, v)
    tok_s = torch.amin(torch.where(score == ms, iota_v, big), dim=-1, keepdim=True)
    mg = torch.amax(x, dim=-1, keepdim=True)
    tok_g = torch.amin(torch.where(x == mg, iota_v, big), dim=-1, keepdim=True)
    return torch.where(degenerate, tok_g, tok_s)


def history_member(hist: torch.Tensor, v: int) -> torch.Tensor:
    """[B, H] history -> [B, V] bool: ids present in the valid (>= 0) window."""
    member = torch.zeros((hist.shape[0], v + 1), dtype=torch.bool, device=hist.device)
    ids = torch.where(hist >= 0, hist, torch.full_like(hist, v)).long()
    member.scatter_(1, ids, True)
    return member[:, :v]


def init_history(batch: int, device=None) -> torch.Tensor:
    return torch.full((batch, HIST_LEN), -1, dtype=torch.int32, device=device)


def push_history(hist: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    return torch.cat([hist[:, 1:], tok[:, None].to(hist.dtype)], dim=1)


def repeated_tail(hist: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """True iff the last n tokens exactly repeat the previous n, for any n in
    [3, 16] with at least 2n tokens generated. hist [B, H], t [B]."""
    h = hist.shape[1]
    out = torch.zeros(hist.shape[0], dtype=torch.bool, device=hist.device)
    for n in range(CYCLE_MIN_N, CYCLE_MAX_N + 1):
        eq = torch.all(hist[:, h - n :] == hist[:, h - 2 * n : h - n], dim=1)
        out |= eq & (t.reshape(-1) >= 2 * n)
    return out


def anti_loop_settings(
    hist: torch.Tensor,
    t: torch.Tensor,
    streak: torch.Tensor,
    base: Tuple[torch.Tensor, torch.Tensor],
    recovery: Tuple[torch.Tensor, torch.Tensor],
    loop_streak: int = 8,
    enabled: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (top_p, temperature), with the recovery values when the
    history tail is an exact cycle or one token repeated >= loop_streak
    times."""
    b = hist.shape[0]
    tp0 = torch.as_tensor(base[0], dtype=torch.float32, device=hist.device).expand(b)
    tm0 = torch.as_tensor(base[1], dtype=torch.float32, device=hist.device).expand(b)
    if not enabled:
        return tp0, tm0
    rec = repeated_tail(hist, t) | ((t > 0) & (streak >= loop_streak))
    tp = torch.where(rec, torch.as_tensor(recovery[0], dtype=torch.float32, device=hist.device), tp0)
    tm = torch.where(rec, torch.as_tensor(recovery[1], dtype=torch.float32, device=hist.device), tm0)
    return tp, tm


def update_streak(
    streak: torch.Tensor, last: torch.Tensor, tok: torch.Tensor, t: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """streak counts consecutive repeats of the previous token."""
    same = (tok == last) & (t > 0)
    return torch.where(same, streak + 1, torch.zeros_like(streak)), tok
