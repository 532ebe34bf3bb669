"""Seeded weights under the published checkpoint names and layouts.

`sopro_spec` lists Sopro's tensors as `src/sopro` names them (torch
layouts: Linear [out, in], depthwise Conv1d [D, 1, k]); `mimi_spec` the
kyutai/mimi tensors as `transformers.MimiModel` names them. Each entry is
(name, shape, init, value): "u" uniform on [-value, value], "n" normal with
std `value`, "c" the constant `value`, "lin" a linspace from value[0] to
value[1]. `make` draws them all from one seed on the device in two large
calls (uniform, normal) and hands back one host copy as numpy views, which
both the program's loader and the reference read.

Scales: Sopro's as its init draws them (Linear U(+-1/sqrt(in)), embeddings
N(0, 1)), with the leaves that init leaves at zero (cross-attention gates,
the FiLM and adapter output layers, head-id offsets, mixes, previous-codebook
weights) drawn nonzero so they take part; the AR head's EOS bias is -30, so
no session ends before its cap. Mimi's convs and projections at std
1/sqrt(fan in), so the waveform is of order one and depends on the codes.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

Spec = List[Tuple[str, Tuple[int, ...], str, object]]


def _linear(spec: Spec, name: str, d_in: int, d_out: int, bias: bool = True, std=None):
    bound = 1.0 / math.sqrt(d_in)
    if std is None:
        spec.append((f"{name}.weight", (d_out, d_in), "u", bound))
    else:
        spec.append((f"{name}.weight", (d_out, d_in), "n", std))
    if bias:
        spec.append((f"{name}.bias", (d_out,), "u" if std is None else "n",
                     bound if std is None else 0.3))


def _ssmlite(spec: Spec, name: str, d: int, k: int):
    spec.append((f"{name}.norm.weight", (d,), "c", 1.0))
    _linear(spec, f"{name}.glu.pro", d, 2 * d)
    spec.append((f"{name}.dw.dw.weight", (d, 1, k), "u", 1.0 / math.sqrt(k)))
    spec.append((f"{name}.dw.dw.bias", (d,), "u", 1.0 / math.sqrt(k)))
    spec.append((f"{name}.ff.0.weight", (d,), "c", 1.0))
    _linear(spec, f"{name}.ff.1", d, 4 * d)
    _linear(spec, f"{name}.ff.3", 4 * d, d)


def _xattn(spec: Spec, name: str, d: int):
    spec.append((f"{name}.nq.weight", (d,), "c", 1.0))
    spec.append((f"{name}.nkv.weight", (d,), "c", 1.0))
    for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
        _linear(spec, f"{name}.{proj}", d, d, bias=False)
    spec.append((f"{name}.gate", (), "n", 0.3))


def stage_indices(cfg: Dict) -> Dict[str, List[int]]:
    q = int(cfg["num_codebooks"])
    out = {}
    for s in ("B", "C", "D", "E"):
        lo, hi = cfg[f"stage_{s}"]
        idx = [i for i in range(int(lo) - 1, int(hi)) if 1 <= i < q]
        if idx:
            out[s] = idx
    return out


def sopro_spec(cfg: Dict, text_vocab: int) -> Spec:
    d, q, v = int(cfg["d_model"]), int(cfg["num_codebooks"]), int(cfg["codebook_size"])
    sv = int(cfg["sv_student_dim"])
    spec: Spec = [("text_enc.embed.emb.weight", (text_vocab, d), "n", 1.0)]
    for i in range(int(cfg["n_layers_text"])):
        _ssmlite(spec, f"text_enc.layers.{i}", d, 7)
    spec.append(("text_enc.norm.weight", (d,), "c", 1.0))
    spec.append(("cb_embed.emb.weight", (q * v + 1, d), "n", 1.0))
    spec.append(("nar_prev_cb_weights", (q,), "n", 0.3))
    spec.append(("token2sv.emb.weight", (q * v, 192), "n", 1.0))
    spec.append(("token2sv.cb_weights", (q,), "lin", (1.0, 0.1)))
    for conv in ("token2sv.enc.0.dw", "token2sv.enc.3.dw"):
        spec.append((f"{conv}.weight", (192, 1, 7), "u", 1.0 / math.sqrt(7)))
        spec.append((f"{conv}.bias", (192,), "u", 1.0 / math.sqrt(7)))
    _linear(spec, "token2sv.pool.attn.0", 192, 192)
    _linear(spec, "token2sv.pool.attn.2", 192, 1)
    _linear(spec, "token2sv.proj", 2 * 192, sv)
    _linear(spec, "spk_film.mlp.0", sv, d)
    _linear(spec, "spk_film.mlp.2", d, 2 * d, std=0.03)
    spec.append(("spk_film.norm.weight", (d,), "c", 1.0))
    spec.append(("spk_film.norm.bias", (d,), "c", 0.0))
    n_ar = int(cfg["n_layers_ar"])
    for i in range(n_ar):
        _ssmlite(spec, f"ar.blocks.{i}", d, int(cfg["ar_kernel"]))
    for i in range(n_ar):
        if (i + 1) % int(cfg["ar_text_attn_freq"]) == 0:
            _xattn(spec, f"ar.x_attns.{i}", d)
    spec.append(("ar.norm.weight", (d,), "c", 1.0))
    _linear(spec, "ar.head", d, v + 1)
    for i in range(int(cfg["n_layers_nar"])):
        _ssmlite(spec, f"nar.blocks.{i}", d, int(cfg["nar_kernel_size"]))
    spec.append(("nar.norm.weight", (d,), "c", 1.0))
    hd = int(cfg["nar_head_dim"])
    _linear(spec, "nar.pre", d, hd)
    stages = stage_indices(cfg)
    spec.append(("nar.stage_emb.weight", (len(stages), d), "n", 1.0))
    spec.append(("nar.adapter.norm.weight", (d,), "c", 1.0))
    _linear(spec, "nar.adapter.mlp.0", d, 256)
    _linear(spec, "nar.adapter.mlp.2", 256, 2 * d, std=0.03)
    for s, idx in stages.items():
        for i in range(len(idx)):
            _linear(spec, f"nar.heads.{s}.{i}", hd, v)
        spec.append((f"nar.head_id_emb.{s}.weight", (len(idx), hd), "n", 0.3))
        spec.append((f"nar.mix.{s}", (2,), "n", 0.3))
    spec.append(("cond_norm.weight", (d,), "c", 1.0))
    for i in range(int(cfg["ref_enc_layers"])):
        _ssmlite(spec, f"ref_enc_blocks.{i}", d, 7)
    spec.append(("ref_enc_norm.weight", (d,), "c", 1.0))
    for i in range(int(cfg["ref_xattn_layers"])):
        _xattn(spec, f"ref_xattn.blocks.{i}", d)
    spec.append(("ref_cb_weights", (q,), "lin", (1.0, 0.1)))
    return spec


EOS_BIAS = -30.0


def _conv(spec: Spec, name: str, cin: int, cout: int, k: int, groups: int = 1, bias=True):
    spec.append((f"{name}.weight", (cout, cin // groups, k), "n", 1.0 / math.sqrt(cin // groups * k)))
    if bias:
        spec.append((f"{name}.bias", (cout,), "n", 0.01))


def _convt(spec: Spec, name: str, cin: int, cout: int, k: int, stride: int, groups: int = 1,
           bias=True):
    std = 1.0 / math.sqrt(cin // groups * k / stride)
    spec.append((f"{name}.weight", (cin, cout // groups, k), "n", std))
    if bias:
        spec.append((f"{name}.bias", (cout,), "n", 0.01))


def _resnet(spec: Spec, name: str, cfg: Dict, dim: int):
    hidden = dim // int(cfg["compress"])
    _conv(spec, f"{name}.block.1.conv", dim, hidden, int(cfg["residual_kernel_size"]))
    _conv(spec, f"{name}.block.3.conv", hidden, dim, 1)


def _mimi_transformer(spec: Spec, prefix: str, cfg: Dict):
    h, i = int(cfg["hidden_size"]), int(cfg["intermediate_size"])
    qd = int(cfg["num_attention_heads"]) * int(cfg["head_dim"])
    kvd = int(cfg["num_key_value_heads"]) * int(cfg["head_dim"])
    for n in range(int(cfg["num_hidden_layers"])):
        p = f"{prefix}.layers.{n}"
        for ln in ("input_layernorm", "post_attention_layernorm"):
            spec.append((f"{p}.{ln}.weight", (h,), "c", 1.0))
            spec.append((f"{p}.{ln}.bias", (h,), "c", 0.0))
        spec.append((f"{p}.self_attn.q_proj.weight", (qd, h), "n", 1.0 / math.sqrt(h)))
        spec.append((f"{p}.self_attn.k_proj.weight", (kvd, h), "n", 1.0 / math.sqrt(h)))
        spec.append((f"{p}.self_attn.v_proj.weight", (kvd, h), "n", 1.0 / math.sqrt(h)))
        spec.append((f"{p}.self_attn.o_proj.weight", (h, qd), "n", 1.0 / math.sqrt(qd)))
        spec.append((f"{p}.mlp.fc1.weight", (i, h), "n", 1.0 / math.sqrt(h)))
        spec.append((f"{p}.mlp.fc2.weight", (h, i), "n", 1.0 / math.sqrt(i)))
        scale = float(cfg["layer_scale_initial_scale"])
        spec.append((f"{p}.self_attn_layer_scale.scale", (h,), "c", scale))
        spec.append((f"{p}.mlp_layer_scale.scale", (h,), "c", scale))


def mimi_spec(cfg: Dict) -> Spec:
    spec: Spec = []
    nf, h = int(cfg["num_filters"]), int(cfg["hidden_size"])
    ratios = [int(r) for r in cfg["upsampling_ratios"]]
    # encoder (MimiEncoder's layer list)
    i, scale = 0, 1
    _conv(spec, f"encoder.layers.{i}.conv", int(cfg["audio_channels"]), nf, int(cfg["kernel_size"]))
    i += 1
    for r in reversed(ratios):
        cur = scale * nf
        for _ in range(int(cfg["num_residual_layers"])):
            _resnet(spec, f"encoder.layers.{i}", cfg, cur)
            i += 1
        i += 1  # ELU
        _conv(spec, f"encoder.layers.{i}.conv", cur, 2 * cur, 2 * r)
        i += 1
        scale *= 2
    i += 1  # ELU
    _conv(spec, f"encoder.layers.{i}.conv", scale * nf, h, int(cfg["last_kernel_size"]))
    _mimi_transformer(spec, "encoder_transformer", cfg)
    _conv(spec, "downsample.conv", h, h, 4, bias=False)
    _convt(spec, "upsample.conv", h, h, 4, 2, groups=int(cfg["upsample_groups"]), bias=False)
    _mimi_transformer(spec, "decoder_transformer", cfg)
    # decoder (MimiDecoder's layer list)
    scale = 2 ** len(ratios)
    i = 0
    _conv(spec, f"decoder.layers.{i}.conv", h, scale * nf, int(cfg["kernel_size"]))
    i += 1
    for r in ratios:
        cur = scale * nf
        i += 1  # ELU
        _convt(spec, f"decoder.layers.{i}.conv", cur, cur // 2, 2 * r, r)
        i += 1
        for _ in range(int(cfg["num_residual_layers"])):
            _resnet(spec, f"decoder.layers.{i}", cfg, cur // 2)
            i += 1
        scale //= 2
    i += 1  # ELU
    _conv(spec, f"decoder.layers.{i}.conv", nf, int(cfg["audio_channels"]), int(cfg["last_kernel_size"]))
    # split RVQ: one semantic and the acoustic codebooks, the projections 1x1 convs
    cbd, v = int(cfg["codebook_dim"]), int(cfg["codebook_size"])
    ns, nq = int(cfg["num_semantic_quantizers"]), int(cfg["num_quantizers"])
    for split, n in (("semantic", ns), ("acoustic", nq - ns)):
        p = f"quantizer.{split}_residual_vector_quantizer"
        spec.append((f"{p}.input_proj.weight", (cbd, h, 1), "n", 1.0 / math.sqrt(h)))
        spec.append((f"{p}.output_proj.weight", (h, cbd, 1), "n", 1.0 / math.sqrt(cbd * nq)))
        for j in range(n):
            spec.append((f"{p}.layers.{j}.codebook.embed_sum", (v, cbd), "n", 1.0))
            spec.append((f"{p}.layers.{j}.codebook.cluster_usage", (v,), "c", 1.0))
    return spec


def numel(spec: Spec) -> int:
    return sum(int(np.prod(s)) if s else 1 for _, s, _, _ in spec)


def make(specs: List[Spec], seed: int, device) -> List[Dict[str, np.ndarray]]:
    """Every tensor of `specs` from `seed`, drawn on `device` (two calls:
    one uniform, one normal, over all entries in order), copied to the host
    once. -> one {name: float32 array} per spec."""
    flat = [e for spec in specs for e in spec]
    n_u = sum(int(np.prod(s)) if s else 1 for _, s, kind, _ in flat if kind == "u")
    n_n = sum(int(np.prod(s)) if s else 1 for _, s, kind, _ in flat if kind == "n")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & 0xFFFF_FFFF_FFFF)
    uni = torch.rand(n_u, generator=gen, device=device, dtype=torch.float32)
    nor = torch.randn(n_n, generator=gen, device=device, dtype=torch.float32)
    parts, iu, i_n = [], 0, 0
    for name, shape, kind, value in flat:
        size = int(np.prod(shape)) if shape else 1
        if kind == "u":
            parts.append((uni[iu: iu + size] * 2.0 - 1.0) * float(value))
            iu += size
        elif kind == "n":
            parts.append(nor[i_n: i_n + size] * float(value))
            i_n += size
        elif kind == "c":
            parts.append(torch.full((size,), float(value), device=device))
        else:
            parts.append(torch.linspace(float(value[0]), float(value[1]), size, device=device))
    host = torch.cat(parts).cpu().numpy()
    del uni, nor, parts
    out, off, k = [], 0, 0
    for spec in specs:
        d = {}
        for name, shape, _, _ in spec:
            size = int(np.prod(shape)) if shape else 1
            d[name] = host[off: off + size].reshape(shape)
            off += size
        out.append(d)
    if "ar.head.bias" in out[0]:
        out[0]["ar.head.bias"][-1] = EOS_BIAS
    return out
