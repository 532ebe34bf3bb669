"""Moshi's operations and bytes, from shapes alone, as `flops.py` counts
them: 2 operations per multiply-add of every matrix product (attention's
two products included; elementwise work, norms and sampling not counted),
bytes of each input read once and each output written once. The Mimi
decode is `flops.py`'s.

A call after a history of H frames is the prefill of positions 0..H, then
steps 0..F: step g > 0 one temporal position attending to H + g + 1 keys,
and each step its text head and its depformer steps (one at step 0, eight
after); then one Mimi decode of F frames.
"""

from __future__ import annotations

from typing import Dict

from cudabench.flops import (ELEM, PEAK_BYTES, PEAK_FLOPS, k3_bound_s, mimi_front,  # noqa: F401
                            seanet_decoder)


def _dims(c: Dict):
    d, h = int(c["hidden_size"]), int(c["num_attention_heads"])
    hd = int(c.get("head_dim") or d // h)
    kvh = int(c.get("num_key_value_heads") or h)
    return d, int(c["ffn_dim"]) // 2, h, kvh, hd, int(c["num_hidden_layers"])


def layer_weights(c: Dict) -> float:
    """Elements of one decoder layer's matrices and norms (one weight set
    of the depformer's)."""
    d, f, h, kvh, hd, _ = _dims(c)
    return d * (h + 2 * kvh) * hd + h * hd * d + 3.0 * d * f + 2 * d


def _layers(c: Dict, positions: int, keys: float) -> float:
    """Operations of the decoder layers over `positions` new positions that
    attend to `keys` keys in all (summed over the positions)."""
    d, f, h, kvh, hd, n = _dims(c)
    dense = 2.0 * positions * (d * (h + 2 * kvh) * hd + h * hd * d + 3.0 * d * f)
    return n * (dense + 4.0 * h * hd * keys)


def prefill(c: Dict, s: int) -> float:
    """The temporal transformer over s positions and the text head on the
    last."""
    return _layers(c, s, s * (s + 1) / 2) + 2.0 * int(c["hidden_size"]) * int(c["vocab_size"])


def temporal_step(c: Dict, ctx: int) -> float:
    """One temporal position attending to `ctx` keys, and the text head."""
    return _layers(c, 1, ctx) + 2.0 * int(c["hidden_size"]) * int(c["vocab_size"])


def depth_step(c: Dict, k: int) -> float:
    """Depformer step k: its input projection, the layers at position k
    attending to k + 1 keys, its head."""
    dc = c["depth_decoder_config"]
    dd = int(dc["hidden_size"])
    return (2.0 * int(c["hidden_size"]) * dd + _layers(dc, 1, k + 1)
            + 2.0 * dd * int(c["audio_vocab_size"]))


def depth_frame(c: Dict) -> float:
    """A frame's eight depformer steps."""
    return sum(depth_step(c, k) for k in range(int(c["num_codebooks"])))


def temporal_bytes(c: Dict, ctx: int, dtype: str = "float32") -> float:
    """One temporal step: the layer weights, the final norm and the text
    head once, the position's 17 embedding rows, the cache's keys and values
    read over `ctx` positions and the new position's written."""
    d, _, _, kvh, hd, n = _dims(c)
    w = n * layer_weights(c) + d + d * int(c["vocab_size"])
    kv = n * 2 * kvh * hd * (ctx + 1)
    return ELEM[dtype] * (w + (1 + 2 * int(c["num_codebooks"])) * d + kv)


def depth_bytes(c: Dict, dtype: str = "float32") -> float:
    """A frame's eight depformer steps: each reads its weight set, its
    input projection, its head and an embedding row once, the shared norms,
    and its cache."""
    dc, q = c["depth_decoder_config"], int(c["num_codebooks"])
    d, _, _, kvh, hd, n = _dims(dc)
    per_step = n * layer_weights(dc) + d * int(c["hidden_size"]) + d * int(c["audio_vocab_size"]) + d
    kv = sum(n * 2 * kvh * hd * (k + 1) for k in range(q))
    return ELEM[dtype] * (q * per_step + int(c["hidden_size"]) + kv)


def request(c: Dict, m: Dict, frames: int, history: int) -> float:
    """Model operations of one call of `frames` frames after a `history`-frame
    history: the prefill, the temporal steps, the text heads and depformer
    steps, and the Mimi decode."""
    steps = sum(temporal_step(c, history + g + 1) for g in range(1, frames + 1))
    return (prefill(c, history + 1) + steps + depth_step(c, 0) + frames * depth_frame(c)
            + mimi_front(m, frames) + seanet_decoder(m, 2 * frames))
