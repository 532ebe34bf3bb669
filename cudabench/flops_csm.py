"""CSM's operations and bytes, from shapes alone, as `flops.py` counts them:
2 operations per multiply-add of every matrix product (attention's two
products included; elementwise work, norms and sampling not counted),
bytes of each input read once and each output written once. The Mimi
decode is `flops.py`'s.

A frame is one backbone step (codebook 0) and 31 depth-decoder passes
(codebooks 1..31); a request is the prompt's prefill, the frames, and one
Mimi decode of them.
"""

from __future__ import annotations

from typing import Dict

from cudabench.flops import ELEM, PEAK_BYTES, PEAK_FLOPS, mimi_front, seanet_decoder  # noqa: F401


def _dims(c: Dict):
    d, h = int(c["hidden_size"]), int(c["num_attention_heads"])
    hd = int(c.get("head_dim") or d // h)
    return d, int(c["intermediate_size"]), h, int(c["num_key_value_heads"]), hd, int(c["num_hidden_layers"])


def layer_weights(c: Dict) -> float:
    """Elements of one decoder layer's matrices and norms."""
    d, f, h, kvh, hd, _ = _dims(c)
    return d * (h + 2 * kvh) * hd + h * hd * d + 3.0 * d * f + 2 * d


def _layers(c: Dict, positions: int, keys: float) -> float:
    """Operations of the decoder layers over `positions` new positions that
    attend to `keys` keys in all (summed over the positions)."""
    d, f, h, kvh, hd, n = _dims(c)
    dense = 2.0 * positions * (d * (h + 2 * kvh) * hd + h * hd * d + 3.0 * d * f)
    return n * (dense + 4.0 * h * hd * keys)


def prefill(c: Dict, s: int) -> float:
    """The backbone over an s-position prompt and codebook 0's head."""
    return _layers(c, s, s * (s + 1) / 2) + 2.0 * int(c["hidden_size"]) * int(c["vocab_size"])


def backbone_step(c: Dict, ctx: int) -> float:
    """One backbone position attending to `ctx` keys, and the head."""
    return _layers(c, 1, ctx) + 2.0 * int(c["hidden_size"]) * int(c["vocab_size"])


def depth_frame(c: Dict) -> float:
    """The 31 depth passes of a frame: pass 1 over positions 0 and 1, pass i
    over position i; each projected from the backbone's width, each with its
    codebook's head."""
    dc, q, v = c["depth_decoder_config"], int(c["num_codebooks"]), int(c["vocab_size"])
    dd = int(dc["hidden_size"])
    proj = 2.0 * int(c["hidden_size"]) * dd * q  # positions 0..Q-1
    layers = _layers(dc, 2, 3) + sum(_layers(dc, 1, i + 1) for i in range(2, q))
    return proj + layers + 2.0 * dd * v * (q - 1)


def backbone_bytes(c: Dict, ctx: int, dtype: str = "float32") -> float:
    """One backbone step: the layer weights, the final norm and the head once,
    the frame's Q embedding rows, the cache's keys and values read over `ctx`
    positions and the new position's written."""
    d, _, _, kvh, hd, n = _dims(c)
    e = ELEM[dtype]
    w = n * layer_weights(c) + d + d * int(c["vocab_size"])
    kv = n * 2 * kvh * hd * (ctx + 1)
    return e * (w + int(c["num_codebooks"]) * d + kv)


def depth_bytes(c: Dict, dtype: str = "float32") -> float:
    """A frame's 31 depth passes: each reads the depth weights, the
    projector, its code's embedding row and its head slice once, and its
    cache."""
    dc, q, v = c["depth_decoder_config"], int(c["num_codebooks"]), int(c["vocab_size"])
    d, _, _, kvh, hd, n = _dims(dc)
    per_pass = n * layer_weights(dc) + d + d * int(c["hidden_size"]) + int(c["hidden_size"]) + d * v
    kv = sum(n * 2 * kvh * hd * (i + 1) for i in range(1, q))
    return ELEM[dtype] * ((q - 1) * per_pass + kv)


def prompt_len(text_len: int, mix: Dict) -> int:
    """Prompt positions of a call: the voice's transcript and the text, each
    framed by BOS, "[0]" and EOS, and the voice's frames with the end frame."""
    refs = mix["refs"]
    return int(refs["transcript"]) + 5 + int(refs["frames"]) + 1 + int(text_len) + 5


def request(c: Dict, m: Dict, frames: int, prompt: int) -> float:
    """Model operations of one call of `frames` frames after a `prompt`-position
    prompt: the prefill, the backbone steps of frames 1.., every frame's depth
    passes, and the Mimi decode."""
    steps = sum(backbone_step(c, prompt + f + 1) for f in range(frames - 1))
    return (prefill(c, prompt) + steps + frames * depth_frame(c) + mimi_front(m, frames)
            + seanet_decoder(m, 2 * frames))
