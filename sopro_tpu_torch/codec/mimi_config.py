"""Mimi codec configuration and the static SEANet encoder and decoder plans
(counterpart: sopro_tpu/codec/mimi_config.py; stdlib only), plus
`required_halo`, the decoder's left context in 25 Hz frames (counterpart:
sopro_tpu/codec/pallas_vocoder.py::required_halo).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

# Layer plan entry kinds. Each entry: (kind, meta-dict).
CONV = "conv"
CONVT = "convt"
RESNET = "resnet"
ELU = "elu"

Plan = Tuple[Tuple[str, Dict[str, Any]], ...]


@dataclass(frozen=True)
class MimiConfig:
    sampling_rate: int = 24_000
    audio_channels: int = 1
    hidden_size: int = 512
    num_filters: int = 64
    num_residual_layers: int = 1
    upsampling_ratios: Tuple[int, ...] = (8, 6, 5, 4)
    kernel_size: int = 7
    last_kernel_size: int = 3
    residual_kernel_size: int = 3
    dilation_growth_rate: int = 2
    compress: int = 2
    trim_right_ratio: float = 1.0
    codebook_size: int = 2048
    codebook_dim: int = 256
    num_quantizers: int = 32
    vector_quantization_hidden_dimension: int = 256
    num_semantic_quantizers: int = 1
    upsample_groups: int = 512
    num_hidden_layers: int = 8
    intermediate_size: int = 2048
    num_attention_heads: int = 8
    num_key_value_heads: int = 8
    head_dim: int = 64
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    sliding_window: int = 250
    layer_scale_initial_scale: float = 0.01
    frame_rate: float = 12.5

    @property
    def hop_length(self) -> int:
        """Samples of audio per codec frame (1920 @ 24 kHz)."""
        return int(round(self.sampling_rate / self.frame_rate))

    @property
    def encodec_frame_rate(self) -> int:
        return math.ceil(self.sampling_rate / math.prod(self.upsampling_ratios))

    @property
    def tokens_per_frame(self) -> int:
        """Transformer tokens per codec frame (2: 12.5 Hz frames -> 25 Hz)."""
        return int(self.encodec_frame_rate / self.frame_rate)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "MimiConfig":
        """A Mimi `config.json`: unknown keys are dropped, lists become
        tuples, and a missing head_dim is hidden_size / heads."""
        names = {f.name for f in dataclasses.fields(cls)}
        init = {k: tuple(v) if isinstance(v, list) else v for k, v in d.items() if k in names}
        if "head_dim" not in init and "hidden_size" in init:
            init["head_dim"] = init["hidden_size"] // init.get("num_attention_heads", 8)
        return cls(**init)


def _resnet_plan(cfg: MimiConfig, dim: int, dilations: Tuple[int, int]) -> Tuple[str, Dict]:
    """SEANet residual block: ELU > conv(k_res, dil) > ELU > conv(1,1),
    identity shortcut."""
    hidden = dim // cfg.compress
    return (
        RESNET,
        {
            "convs": (
                {"in": dim, "out": hidden, "k": cfg.residual_kernel_size,
                 "stride": 1, "dilation": dilations[0], "pad_mode": "constant"},
                {"in": hidden, "out": dim, "k": 1, "stride": 1, "dilation": dilations[1],
                 "pad_mode": "constant"},
            )
        },
    )


def encoder_plan(cfg: MimiConfig) -> Plan:
    """SEANet encoder layer plan."""
    plan = [
        (CONV, {"in": cfg.audio_channels, "out": cfg.num_filters, "k": cfg.kernel_size,
                "stride": 1, "dilation": 1, "pad_mode": "constant"})
    ]
    scaling = 1
    for ratio in reversed(cfg.upsampling_ratios):
        current = scaling * cfg.num_filters
        for j in range(cfg.num_residual_layers):
            plan.append(_resnet_plan(cfg, current, (cfg.dilation_growth_rate ** j, 1)))
        plan.append((ELU, {}))
        plan.append(
            (CONV, {"in": current, "out": current * 2, "k": ratio * 2,
                    "stride": ratio, "dilation": 1, "pad_mode": "constant"})
        )
        scaling *= 2
    plan.append((ELU, {}))
    plan.append(
        (CONV, {"in": scaling * cfg.num_filters, "out": cfg.hidden_size,
                "k": cfg.last_kernel_size, "stride": 1, "dilation": 1,
                "pad_mode": "constant"})
    )
    return tuple(plan)


def decoder_plan(cfg: MimiConfig) -> Plan:
    """SEANet decoder layer plan."""
    scaling = int(2 ** len(cfg.upsampling_ratios))
    plan = [
        (CONV, {"in": cfg.hidden_size, "out": scaling * cfg.num_filters,
                "k": cfg.kernel_size, "stride": 1, "dilation": 1,
                "pad_mode": "constant"})
    ]
    for ratio in cfg.upsampling_ratios:
        current = scaling * cfg.num_filters
        plan.append((ELU, {}))
        plan.append(
            (CONVT, {"in": current, "out": current // 2, "k": ratio * 2,
                     "stride": ratio, "groups": 1})
        )
        for j in range(cfg.num_residual_layers):
            plan.append(
                _resnet_plan(cfg, current // 2, (cfg.dilation_growth_rate ** j, 1))
            )
        scaling //= 2
    plan.append((ELU, {}))
    plan.append(
        (CONV, {"in": cfg.num_filters, "out": cfg.audio_channels,
                "k": cfg.last_kernel_size, "stride": 1, "dilation": 1,
                "pad_mode": "constant"})
    )
    return tuple(plan)


def downsample_spec(cfg: MimiConfig) -> Dict[str, Any]:
    """25 Hz -> 12.5 Hz stride-2 conv with replicate padding."""
    k = 2 * int(cfg.encodec_frame_rate / cfg.frame_rate)
    return {"in": cfg.hidden_size, "out": cfg.hidden_size, "k": k, "stride": 2,
            "dilation": 1, "pad_mode": "replicate"}


def upsample_spec(cfg: MimiConfig) -> Dict[str, Any]:
    """12.5 Hz -> 25 Hz grouped stride-2 transpose conv."""
    k = 2 * int(cfg.encodec_frame_rate / cfg.frame_rate)
    return {"in": cfg.hidden_size, "out": cfg.hidden_size, "k": k, "stride": 2,
            "groups": cfg.upsample_groups}


def required_halo(cfg: MimiConfig) -> int:
    """Left-context frames (at the decoder-input rate, 25 Hz) that cover the
    whole causal decoder stack's receptive field: walk the plan backwards
    (a conv of kernel k consumes k-1 rows; a transpose conv of stride s turns
    `need` output rows into ceil(need/s)+1 input rows). 8 at production."""
    need = int(cfg.last_kernel_size) - 1
    for ratio in reversed(cfg.upsampling_ratios):
        need += int(cfg.residual_kernel_size) - 1
        need = math.ceil(need / int(ratio)) + 1
    return need + int(cfg.kernel_size) - 1
