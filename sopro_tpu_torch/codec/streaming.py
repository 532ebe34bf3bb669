"""Streaming Mimi decode with explicit, fixed-shape state (counterpart:
sopro_tpu/codec/streaming.py).

Every stage of the decode path is causal, so a chunked decode is exact:
concatenated chunks equal a full decode up to float summation order. The
state is a `MimiStreamState` of tensors:

* a ring KV cache of `sliding_window` slots per transformer layer, with the
  absolute position held in each slot (exact sliding-window attention with
  RoPE at absolute positions);
* a bias-free overlap-add carry for the 12.5 -> 25 Hz upsampler;
* per-conv left-context caches for the SEANet decoder's per-conv route;
* `emb_hist`, the last `required_halo` post-transformer frames: the whole
  left context of the packed route, where the SEANet runs in valid mode over
  [emb_hist ++ chunk] (`codec/vocoder.py::seanet_decode_chunk`, kernel K4 on
  CUDA). It is kept on both routes.

Rows are independent: `mask` freezes rows for a step, `reset_stream_rows`
zeroes rows for reuse.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from sopro_tpu_torch.codec.mimi import (
    _convt_polyphase,
    _convt_polyphase_depthwise,
    _layernorm,
    _merge_heads,
    _split_heads,
    rvq_decode,
)
from sopro_tpu_torch.codec.mimi_config import (
    CONV,
    CONVT,
    ELU,
    RESNET,
    MimiConfig,
    decoder_plan,
    required_halo,
    upsample_spec,
)
from sopro_tpu_torch.ops.rope import rope_cos_sin, rotary

Params = Dict[str, Any]
EMPTY_SLOT = -(10 ** 9)  # kv_pos of a ring slot that holds no key


class MimiStreamState(NamedTuple):
    pos: torch.Tensor  # [B] int32: transformer tokens decoded so far
    kv_k: Tuple[torch.Tensor, ...]  # per layer [B, H, W, hd]
    kv_v: Tuple[torch.Tensor, ...]
    kv_pos: torch.Tensor  # [B, W] int32: absolute position in each slot
    upsample_carry: torch.Tensor  # [B, k-s, hidden]: bias-free partial sums
    conv_caches: Tuple[torch.Tensor, ...]  # per-conv caches, flattened over the plan
    emb_hist: torch.Tensor  # [B, halo, hidden]


# --------------------------------------------------------------------------
# streaming conv primitives
# --------------------------------------------------------------------------


def _conv_cache_len(spec: Dict[str, Any]) -> int:
    return (int(spec["k"]) - 1) * int(spec.get("dilation", 1))


def _conv_valid(p: Params, x: torch.Tensor, spec: Dict[str, Any]) -> torch.Tensor:
    """Unpadded stride-1 conv [B, T, Cin] -> [B, T - (k-1)*dil, Cout]."""
    w = p["w"].permute(2, 1, 0).to(x.dtype)  # [Cout, Cin/g, k]
    y = F.conv1d(x.transpose(1, 2), w, dilation=int(spec.get("dilation", 1)),
                 groups=int(spec.get("groups", 1))).transpose(1, 2)
    return y + p["b"].to(y.dtype) if "b" in p else y


def stream_conv(
    p: Params, x: torch.Tensor, cache: torch.Tensor, spec: Dict[str, Any]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stride-1 causal conv over a chunk [B, n, C] with a left-context cache
    [B, (k-1)*dil, C]; a zero cache is the full path's causal zero pad."""
    ext = torch.cat([cache, x], dim=1)
    y = _conv_valid(p, ext, spec)
    ctx = cache.shape[1]
    return y, (ext[:, ext.shape[1] - ctx:] if ctx > 0 else cache)


def stream_convt(
    p: Params, x: torch.Tensor, carry: torch.Tensor, spec: Dict[str, Any]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal transpose conv over a chunk [B, n, Cin] -> [B, n*s, Cout] with a
    bias-free overlap-add carry [B, k-s, Cout]. For k = 2s (dense or fully
    depthwise) the in-chunk output is the polyphase product and the carry is
    the last frame's previous-frame term w[s-1-r] . x[n-1]; other kernels
    run as a full transpose conv whose tail becomes the carry."""
    k, s = int(spec["k"]), int(spec["stride"])
    groups, cin, cout = int(spec.get("groups", 1)), int(spec["in"]), int(spec["out"])
    n = x.shape[1]
    w = p["w"]
    r = torch.arange(s, device=w.device)
    if groups == 1 and s > 1 and k == 2 * s:
        emit = _convt_polyphase(w, x, s)
        new_carry = torch.einsum("bc,scd->bsd", x[:, -1], w[s - 1 - r].to(x.dtype))
    elif groups == cin == cout and s > 1 and k == 2 * s:
        emit = _convt_polyphase_depthwise(w, x, s)
        new_carry = x[:, -1, None, :] * w[s - 1 - r, 0][None].to(x.dtype)
    else:
        # JAX's lhs-dilated conv with the HIO kernel [k, Cin/g, Cout] is a
        # transpose conv with the taps reversed, laid out [Cin, Cout/g, k]
        wt = w.flip(0).reshape(k, cin // groups, groups, cout // groups)
        wt = wt.permute(2, 1, 3, 0).reshape(cin, cout // groups, k).to(x.dtype)
        raw = F.conv_transpose1d(x.transpose(1, 2), wt, stride=s, groups=groups).transpose(1, 2)
        emit, new_carry = raw[:, : n * s], raw[:, n * s:]
    ov = k - s
    emit = torch.cat([emit[:, :ov] + carry, emit[:, ov:]], dim=1)
    if "b" in p:
        emit = emit + p["b"].to(emit.dtype)
    return emit, new_carry


# --------------------------------------------------------------------------
# state
# --------------------------------------------------------------------------


def _plan_cache_shapes(cfg: MimiConfig) -> List[Tuple[int, int]]:
    """(length, channels) per cache slot, flattened over the decoder plan (a
    residual block has one slot per inner conv)."""
    shapes: List[Tuple[int, int]] = []
    for kind, spec in decoder_plan(cfg):
        if kind == CONV:
            shapes.append((_conv_cache_len(spec), int(spec["in"])))
        elif kind == CONVT:
            shapes.append((int(spec["k"]) - int(spec["stride"]), int(spec["out"])))
        elif kind == RESNET:
            shapes.extend((_conv_cache_len(cs), int(cs["in"])) for cs in spec["convs"])
    return shapes


def init_mimi_stream_state(
    cfg: MimiConfig, batch: int, device, dtype=torch.float32
) -> MimiStreamState:
    w, heads, hd = int(cfg.sliding_window), int(cfg.num_key_value_heads), int(cfg.head_dim)
    us = upsample_spec(cfg)
    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    return MimiStreamState(
        pos=torch.zeros((batch,), dtype=torch.int32, device=device),
        kv_k=tuple(z(batch, heads, w, hd) for _ in range(cfg.num_hidden_layers)),
        kv_v=tuple(z(batch, heads, w, hd) for _ in range(cfg.num_hidden_layers)),
        kv_pos=torch.full((batch, w), EMPTY_SLOT, dtype=torch.int32, device=device),
        upsample_carry=z(batch, int(us["k"]) - int(us["stride"]), int(us["out"])),
        conv_caches=tuple(z(batch, length, ch) for length, ch in _plan_cache_shapes(cfg)),
        emb_hist=z(batch, required_halo(cfg), int(us["out"])),
    )


# --------------------------------------------------------------------------
# streaming transformer
# --------------------------------------------------------------------------


def _stream_transformer(
    p: Params, cfg: MimiConfig, x: torch.Tensor, state: MimiStreamState
) -> Tuple[torch.Tensor, MimiStreamState]:
    """A chunk of m tokens [B, m, H] through every layer with the ring KV
    cache; any m works, including m > sliding_window."""
    b, m, _ = x.shape
    w = int(cfg.sliding_window)
    q_pos = state.pos[:, None] + torch.arange(m, dtype=torch.int32, device=x.device)[None]
    cos, sin = rope_cos_sin(q_pos.reshape(-1), cfg.head_dim, cfg.rope_theta)
    cos = cos.reshape(b, 1, m, -1).to(x.dtype)
    sin = sin.reshape(b, 1, m, -1).to(x.dtype)
    rope = lambda t: rotary(t, cos, sin)  # t [B, H, m, hd]

    # Attend to [ring keys (all older than the chunk) ++ chunk keys]; only the
    # chunk's last min(m, W) keys enter the ring, written after attention.
    tail = max(m - w, 0)
    tail_pos = q_pos[:, tail:]  # [B, mt]
    slots = torch.remainder(tail_pos, w).long()
    kv_pos = state.kv_pos.scatter(1, slots, tail_pos)

    k_pos = torch.cat([state.kv_pos, q_pos], dim=1)  # [B, W+m]
    diff = q_pos[:, :, None] - k_pos[:, None, :]
    zero = torch.zeros(diff.shape, dtype=torch.float32, device=x.device)
    bias = torch.where((diff >= 0) & (diff < w), zero, torch.full_like(zero, float("-inf")))

    scale = 1.0 / math.sqrt(cfg.head_dim)
    new_k, new_v = [], []
    for lp, k_ring, v_ring in zip(p["layers"], state.kv_k, state.kv_v):
        h = _layernorm(lp["ln1"], x, cfg.norm_eps)
        q = rope(_split_heads(h @ lp["q"]["w"], cfg.num_attention_heads))
        k = rope(_split_heads(h @ lp["k"]["w"], cfg.num_key_value_heads))
        v = _split_heads(h @ lp["v"]["w"], cfg.num_key_value_heads)
        k_all = torch.cat([k_ring, k], dim=2)  # [B, H, W+m, hd]
        v_all = torch.cat([v_ring, v], dim=2)
        new_k.append(_ring_write(k_ring, k[:, :, tail:], slots))
        new_v.append(_ring_write(v_ring, v[:, :, tail:], slots))

        logits = torch.matmul(q.float(), k_all.float().transpose(-1, -2)) * scale
        a = torch.softmax(logits + bias[:, None], dim=-1).to(x.dtype)
        a = torch.matmul(a, v_all.to(x.dtype))
        x = x + lp["scale_attn"].to(x.dtype) * (_merge_heads(a) @ lp["o"]["w"])
        h = _layernorm(lp["ln2"], x, cfg.norm_eps)
        h = F.gelu(h @ lp["fc1"]["w"]) @ lp["fc2"]["w"]
        x = x + lp["scale_mlp"].to(x.dtype) * h

    return x, state._replace(
        pos=state.pos + m, kv_k=tuple(new_k), kv_v=tuple(new_v), kv_pos=kv_pos
    )


def _ring_write(ring: torch.Tensor, vals: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """ring [B, H, W, hd] <- vals [B, H, mt, hd] at per-row slots [B, mt]."""
    b, h, mt, hd = vals.shape
    return ring.scatter(2, slots[:, None, :, None].expand(b, h, mt, hd), vals)


# --------------------------------------------------------------------------
# streaming SEANet decoder, per-conv route
# --------------------------------------------------------------------------


def _stream_decoder(
    params: List[Params], cfg: MimiConfig, x: torch.Tensor, caches: Tuple[torch.Tensor, ...]
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    new_caches = list(caches)
    ci = 0
    for p, (kind, spec) in zip(params, decoder_plan(cfg)):
        if kind == CONV:
            x, new_caches[ci] = stream_conv(p, x, caches[ci], spec)
            ci += 1
        elif kind == CONVT:
            x, new_caches[ci] = stream_convt(p, x, caches[ci], spec)
            ci += 1
        elif kind == RESNET:
            h = x
            for cp, cs in zip(p["convs"], spec["convs"]):
                h, new_caches[ci] = stream_conv(cp, F.elu(h), caches[ci], cs)
                ci += 1
            x = x + h
        elif kind == ELU:
            x = F.elu(x)
    return x, tuple(new_caches)


# --------------------------------------------------------------------------
# public entry
# --------------------------------------------------------------------------


def mimi_decode_step(
    p: Params,
    cfg: MimiConfig,
    codes_btq: torch.Tensor,
    state: MimiStreamState,
    mask: Optional[torch.Tensor] = None,
    packed: Optional[Dict[str, Any]] = None,
) -> Tuple[torch.Tensor, MimiStreamState]:
    """Decode a chunk of n frames -> (wav [B, n*hop], new state).

    `packed` (from `codec.vocoder.pack_seanet_decoder`): run the SEANet as
    `seanet_decode_chunk` over [emb_hist ++ chunk] (kernel K4 on CUDA)
    instead of the per-conv route; the samples are the same by the
    valid-region argument, the history rows before the stream's start
    acting as the causal zero padding. The per-conv caches are then left as they were,
    so a stream may switch from the per-conv route to the packed one, not
    back. `mask` [B] bool: rows with False keep their state untouched and
    their output row is meaningless."""
    prev = state
    emb = rvq_decode(p["quantizer"], codes_btq)  # [B, n, H]
    emb, up_carry = stream_convt(p["upsample"], emb, state.upsample_carry, upsample_spec(cfg))
    state = state._replace(upsample_carry=up_carry)
    emb, state = _stream_transformer(p["dec_tf"], cfg, emb, state)  # [B, 2n, H]
    ext = torch.cat([state.emb_hist.to(emb.dtype), emb], dim=1)
    halo = state.emb_hist.shape[1]
    state = state._replace(emb_hist=ext[:, ext.shape[1] - halo:])
    if packed is not None:
        from sopro_tpu_torch.codec.vocoder import seanet_decode_chunk

        # real history rows: the tokens decoded before this chunk, up to halo
        wav = seanet_decode_chunk(packed, cfg, ext.contiguous(), n_hist=prev.pos)
    else:
        wav, conv_caches = _stream_decoder(p["decoder"], cfg, emb, state.conv_caches)
        wav = wav[..., 0]
        state = state._replace(conv_caches=conv_caches)
    if mask is not None:
        def freeze(new, old):
            return torch.where(mask.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)

        state = MimiStreamState(*(
            tuple(map(freeze, new, old)) if isinstance(new, tuple) else freeze(new, old)
            for new, old in zip(state, prev)
        ))
    return wav, state


def reset_stream_rows(state: MimiStreamState, rows: torch.Tensor) -> MimiStreamState:
    """Return the state with the rows where `rows` [B] bool is True set back
    to a fresh stream's (slot recycling when a stream ends)."""
    def z(leaf, fill=0):
        m = rows.reshape((-1,) + (1,) * (leaf.dim() - 1))
        return torch.where(m, torch.full_like(leaf, fill), leaf)

    return MimiStreamState(
        pos=z(state.pos),
        kv_k=tuple(map(z, state.kv_k)),
        kv_v=tuple(map(z, state.kv_v)),
        kv_pos=z(state.kv_pos, EMPTY_SLOT),
        upsample_carry=z(state.upsample_carry),
        conv_caches=tuple(map(z, state.conv_caches)),
        emb_hist=z(state.emb_hist),
    )
