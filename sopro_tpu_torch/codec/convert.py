"""Mimi checkpoint conversion: the `kyutai/mimi` state dict, as
`transformers.MimiModel` names it, -> the parameter tree that
`weights.mimi_params_from_jax` and `codec/mimi.py` take (counterpart:
sopro_tpu/codec/convert.py::convert_mimi_state_dict). Works on any flat
mapping name -> numpy array: the safetensors loader's (`hub.py`) or a torch
`MimiModel.state_dict()` turned into numpy.

Layout transforms:
* Conv1d [out, in/g, k]            -> HIO [k, in/g, out]
* ConvTranspose1d [in, out/g, k]   -> the kernel of the equivalent
  lhs-dilated forward conv: flipped along k and regrouped to HIO
  [k, in/g, out] with group-major out channels
* Linear [out, in]                 -> [in, out]
* Euclidean codebooks: embed = embed_sum / clamp(cluster_usage, eps); the
  decode tables also fold in the split's 1x1 output projection.

Encoder tensors are converted too (reference audio runs the encoder).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from sopro_tpu_torch.codec.mimi_config import (
    CONV,
    CONVT,
    ELU,
    RESNET,
    MimiConfig,
    Plan,
    decoder_plan,
    encoder_plan,
    upsample_spec,
)

Array = np.ndarray
SD = Dict[str, Array]


def conv_weight(w: Array) -> Array:
    """torch Conv1d [out, in/g, k] -> HIO [k, in/g, out]."""
    return np.ascontiguousarray(np.transpose(w, (2, 1, 0)))


def convt_weight(w: Array, groups: int) -> Array:
    """torch ConvTranspose1d [in, out/g, k] -> flipped HIO [k, in/g, out]."""
    i, og, k = w.shape
    w4 = w.reshape(groups, i // groups, og, k)[..., ::-1]
    return np.ascontiguousarray(np.transpose(w4, (3, 1, 0, 2)).reshape(k, i // groups, groups * og))


def _lin(sd: SD, name: str) -> Dict[str, Array]:
    return {"w": np.ascontiguousarray(sd[f"{name}.weight"].T)}


def _ln(sd: SD, name: str) -> Dict[str, Array]:
    return {"scale": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"]}


def _conv(sd: SD, name: str) -> Dict[str, Array]:
    p = {"w": conv_weight(sd[f"{name}.weight"])}
    if f"{name}.bias" in sd:
        p["b"] = sd[f"{name}.bias"]
    return p


def _convt(sd: SD, name: str, groups: int) -> Dict[str, Array]:
    p = {"w": convt_weight(sd[f"{name}.weight"], groups)}
    if f"{name}.bias" in sd:
        p["b"] = sd[f"{name}.bias"]
    return p


def _seanet(sd: SD, prefix: str, plan: Plan) -> List[Dict[str, Any]]:
    params: List[Dict[str, Any]] = []
    for i, (kind, spec) in enumerate(plan):
        name = f"{prefix}.layers.{i}"
        if kind == CONV:
            params.append(_conv(sd, f"{name}.conv"))
        elif kind == CONVT:
            params.append(_convt(sd, f"{name}.conv", int(spec.get("groups", 1))))
        elif kind == RESNET:
            params.append({"convs": [_conv(sd, f"{name}.block.1.conv"),
                                     _conv(sd, f"{name}.block.3.conv")]})
        elif kind == ELU:
            params.append({})
    return params


def _transformer(sd: SD, prefix: str, cfg: MimiConfig) -> Dict[str, Any]:
    layers = []
    for i in range(cfg.num_hidden_layers):
        name = f"{prefix}.layers.{i}"
        layers.append({
            "ln1": _ln(sd, f"{name}.input_layernorm"),
            "q": _lin(sd, f"{name}.self_attn.q_proj"),
            "k": _lin(sd, f"{name}.self_attn.k_proj"),
            "v": _lin(sd, f"{name}.self_attn.v_proj"),
            "o": _lin(sd, f"{name}.self_attn.o_proj"),
            "ln2": _ln(sd, f"{name}.post_attention_layernorm"),
            "fc1": _lin(sd, f"{name}.mlp.fc1"),
            "fc2": _lin(sd, f"{name}.mlp.fc2"),
            "scale_attn": sd[f"{name}.self_attn_layer_scale.scale"],
            "scale_mlp": sd[f"{name}.mlp_layer_scale.scale"],
        })
    return {"layers": layers}


def _codebook_embed(sd: SD, name: str, eps: float = 1e-5) -> Array:
    if f"{name}.initialized" in sd:
        # an EMA bookkeeping flag, not a weight: read so the coverage check
        # (hub.TrackedStateDict) counts it as consumed
        sd[f"{name}.initialized"]
    usage = np.clip(sd[f"{name}.cluster_usage"], eps, None)
    return sd[f"{name}.embed_sum"] / usage[:, None]


SEMANTIC = "quantizer.semantic_residual_vector_quantizer"
ACOUSTIC = "quantizer.acoustic_residual_vector_quantizer"


def _quantizer(sd: SD, cfg: MimiConfig) -> Dict[str, Any]:
    ns = cfg.num_semantic_quantizers
    na = cfg.num_quantizers - ns
    embed = np.stack(
        [_codebook_embed(sd, f"{SEMANTIC}.layers.{i}.codebook") for i in range(ns)]
        + [_codebook_embed(sd, f"{ACOUSTIC}.layers.{i}.codebook") for i in range(na)]
    )  # [Q, V, cb_dim]
    # 1x1 output projections [hidden, cb_dim, 1] -> right-matmul [cb_dim, hidden]
    out_sem = np.ascontiguousarray(sd[f"{SEMANTIC}.output_proj.weight"][..., 0].T)
    out_ac = np.ascontiguousarray(sd[f"{ACOUSTIC}.output_proj.weight"][..., 0].T)
    return {
        "embed": embed,
        "dec_embed": np.concatenate([embed[:ns] @ out_sem, embed[ns:] @ out_ac], axis=0),
        "in_proj_sem": np.ascontiguousarray(sd[f"{SEMANTIC}.input_proj.weight"][..., 0].T),
        "in_proj_ac": np.ascontiguousarray(sd[f"{ACOUSTIC}.input_proj.weight"][..., 0].T),
    }


def convert_mimi_state_dict(sd: SD, cfg: MimiConfig) -> Dict[str, Any]:
    """A whole MimiModel state dict -> the Mimi parameter tree (a missing
    tensor raises KeyError naming it)."""
    return {
        "encoder": _seanet(sd, "encoder", encoder_plan(cfg)),
        "enc_tf": _transformer(sd, "encoder_transformer", cfg),
        "downsample": {"w": conv_weight(sd["downsample.conv.weight"])},
        "upsample": {"w": convt_weight(sd["upsample.conv.weight"],
                                       int(upsample_spec(cfg)["groups"]))},
        "dec_tf": _transformer(sd, "decoder_transformer", cfg),
        "decoder": _seanet(sd, "decoder", decoder_plan(cfg)),
        "quantizer": _quantizer(sd, cfg),
    }
