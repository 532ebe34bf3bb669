"""Operations and bytes the algorithm needs, from shapes alone.

Operations count 2 per multiply-add of every matrix product and
convolution (elementwise work is not counted); a transpose conv counts the
products its output needs, 2 * T_out * k/s * Cin/g * Cout. Each count is of
the work the inputs need, once, whatever an implementation recomputes or
pads. Bytes count each input read once and each output written once.

The Sopro counts follow the program's own counters (`ar_step_flops`,
`nar_heads_flops`, `nar_trunk_flops`, `seanet_decoder_flops`,
`conditioning_flops`), frozen here and completed with the Mimi decoder's
RVQ dequant, upsample and transformer, and Token2SV.

Peaks (NVIDIA's H100 SXM data sheet, dense): 989 TF/s bf16, 495 TF/s TF32,
which is the fastest rate at which the card takes float32 operands at all,
so no float32 implementation can read above it; 3.35 TB/s of HBM.
"""

from __future__ import annotations

from typing import Dict

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}
PEAK_BYTES = 3.35e12
ELEM = {"bfloat16": 2, "float32": 4}


def _n_xattn(c: Dict) -> int:
    return sum(1 for i in range(int(c["n_layers_ar"])) if (i + 1) % int(c["ar_text_attn_freq"]) == 0)


def _ssmlite(d: int, k: int) -> float:
    """One SSMLite block, one frame: GLU d->2d, FFN d->4d->d, depthwise conv."""
    return 20.0 * d * d + 2.0 * k * d


def ar_step(c: Dict, text_len: int) -> float:
    """One AR step of one row over `text_len` text tokens."""
    d = int(c["d_model"])
    xattn = 4.0 * d * d + 4.0 * text_len * d
    head = 2.0 * d * (int(c["codebook_size"]) + 1)
    return int(c["n_layers_ar"]) * _ssmlite(d, int(c["ar_kernel"])) + _n_xattn(c) * xattn + head


def ar_weight_elems(c: Dict) -> float:
    d = int(c["d_model"])
    per_block = 10.0 * d * d + 6.0 * d + int(c["ar_kernel"]) * d
    return (int(c["n_layers_ar"]) * per_block + _n_xattn(c) * 2.0 * d * d
            + d * (int(c["codebook_size"]) + 1))


def _n_heads(c: Dict) -> int:
    q = int(c["num_codebooks"])
    return sum(len([i for i in range(int(c[f"stage_{s}"][0]) - 1, int(c[f"stage_{s}"][1]))
                     if 1 <= i < q]) for s in "BCDE")


def _n_stages(c: Dict) -> int:
    q = int(c["num_codebooks"])
    return sum(1 for s in "BCDE"
               if any(1 <= i < q for i in range(int(c[f"stage_{s}"][0]) - 1, int(c[f"stage_{s}"][1]))))


def nar_heads(c: Dict, frames: int) -> float:
    return 2.0 * frames * _n_heads(c) * int(c["nar_head_dim"]) * int(c["codebook_size"])


def nar_trunk(c: Dict, frames: int) -> float:
    d = int(c["d_model"])
    per_stage = int(c["n_layers_nar"]) * _ssmlite(d, int(c["nar_kernel_size"])) + 2.0 * d * int(c["nar_head_dim"])
    return frames * _n_stages(c) * per_stage


def conditioning(c: Dict, frames: int, text_len: int, ref_len: int) -> float:
    d = int(c["d_model"])
    text = text_len * (int(c["n_layers_text"]) * _ssmlite(d, 7) + _n_xattn(c) * 4.0 * d * d)
    n_ref = int(c["ref_xattn_layers"])
    ref = ref_len * (int(c["ref_enc_layers"]) * _ssmlite(d, 7) + n_ref * 4.0 * d * d)
    per_frame = frames * n_ref * (4.0 * d * d + 4.0 * ref_len * d)
    sv = int(c["sv_student_dim"])
    t2sv = ref_len * (2 * 2.0 * 7 * 192 + 2.0 * 192 * 192 + 2.0 * 192) + 2.0 * 384 * sv
    film = 2.0 * sv * d + 2.0 * d * 2 * d
    return text + ref + per_frame + t2sv + film


def _decoder_layers(m: Dict):
    """(kind, k, stride, cin, cout) of the SEANet decoder."""
    nf, h = int(m["num_filters"]), int(m["hidden_size"])
    scale = 2 ** len(m["upsampling_ratios"])
    out = [("conv", int(m["kernel_size"]), 1, h, scale * nf)]
    for r in m["upsampling_ratios"]:
        cur = scale * nf
        out.append(("convt", 2 * int(r), int(r), cur, cur // 2))
        for _ in range(int(m["num_residual_layers"])):
            hid = cur // 2 // int(m["compress"])
            out.append(("conv", int(m["residual_kernel_size"]), 1, cur // 2, hid))
            out.append(("conv", 1, 1, hid, cur // 2))
        scale //= 2
    out.append(("conv", int(m["last_kernel_size"]), 1, nf, int(m["audio_channels"])))
    return out


def seanet_decoder(m: Dict, t25: int) -> float:
    """The SEANet decoder over `t25` 25 Hz frames (kernel K3's stage)."""
    t, total = int(t25), 0.0
    for kind, k, s, cin, cout in _decoder_layers(m):
        if kind == "convt":
            t *= s
            total += 2.0 * t * (k // s) * cin * cout
        else:
            total += 2.0 * t * k * cin * cout
    return total


def seanet_bytes(m: Dict, t25: int, dtype: str) -> float:
    """Weights, the 25 Hz input and the waveform, once each."""
    e = ELEM[dtype]
    w = sum(k * cin * cout + cout for _, k, _, cin, cout in _decoder_layers(m))
    hop = 1
    for r in m["upsampling_ratios"]:
        hop *= int(r)
    return e * (w + t25 * int(m["hidden_size"])) + 4.0 * t25 * hop


def mimi_front(m: Dict, frames: int) -> float:
    """RVQ dequant (each split's 1x1 output projection), the grouped
    upsample and the decoder transformer over 2 * frames tokens."""
    h, i = int(m["hidden_size"]), int(m["intermediate_size"])
    t = 2 * frames
    rvq = 2.0 * 2 * frames * int(m["codebook_dim"]) * h
    up = 2.0 * t * 2 * (h // int(m["upsample_groups"])) * h
    w = int(m["sliding_window"])
    keys = sum(min(p + 1, w) for p in range(t))  # keys each token attends to
    qd = int(m["num_attention_heads"]) * int(m["head_dim"])
    per_layer = t * (2.0 * h * qd * 4 + 4.0 * h * i) + 4.0 * keys * qd
    return rvq + up + int(m["num_hidden_layers"]) * per_layer


def k1_bound_s(c: Dict, steps: int, rows: int, text_len: int, dtype: str) -> float:
    ops = rows * steps * ar_step(c, text_len)
    d = int(c["d_model"])
    byts = ELEM[dtype] * (ar_weight_elems(c) + rows * (_n_xattn(c) * 2 * text_len * d + steps * d)) \
        + 4.0 * rows * steps
    return max(ops / PEAK_FLOPS[dtype], byts / PEAK_BYTES)


def k2_bound_s(c: Dict, frames: int, dtype: str) -> float:
    hd, v, h = int(c["nar_head_dim"]), int(c["codebook_size"]), _n_heads(c)
    ops = nar_heads(c, frames)
    byts = ELEM[dtype] * (h * hd * v + h * v + frames * _n_stages(c) * hd + h * hd) + 4.0 * frames * h
    return max(ops / PEAK_FLOPS[dtype], byts / PEAK_BYTES)


def k3_bound_s(m: Dict, frames: int, dtype: str) -> float:
    t25 = 2 * frames
    return max(seanet_decoder(m, t25) / PEAK_FLOPS[dtype], seanet_bytes(m, t25, dtype) / PEAK_BYTES)


def request(c: Dict, m: Dict, frames: int, text_len: int, ref_len: int) -> float:
    """Model operations of one whole request of `frames` frames: the
    conditioning, the AR steps, the NAR trunks and heads, and the Mimi
    decode."""
    return (conditioning(c, frames, text_len, ref_len) + frames * ar_step(c, text_len)
            + nar_trunk(c, frames) + nar_heads(c, frames) + mimi_front(m, frames)
            + seanet_decoder(m, 2 * frames))
