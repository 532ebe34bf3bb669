"""Model hyper-parameter configuration (counterpart: sopro_tpu/config.py).

`SoproTTSConfig` keeps the checkpoint's exact field set and defaults, so a
`cfg` JSON deserializes unchanged. `RuntimeConfig` keeps only the knobs the
port reads: the padding buckets, which must match the JAX package's so both
compute on the same padded shapes.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

from sopro_tpu_torch.constants import TARGET_SR


@dataclass(frozen=True)
class SoproTTSConfig:
    num_codebooks: int = 32
    codebook_size: int = 2048
    mimi_fps: float = 12.5
    max_frames: int = 400
    audio_sr: int = TARGET_SR

    d_model: int = 384
    n_layers_text: int = 2
    dropout: float = 0.05
    pos_emb_max: int = 4096
    max_text_len: int = 2048

    n_layers_ar: int = 6
    ar_kernel: int = 13
    ar_dilation_cycle: Tuple[int, ...] = (1, 2, 4, 1)
    ar_text_attn_freq: int = 2
    min_gen_frames: int = 12

    n_layers_nar: int = 6
    nar_head_dim: int = 256
    nar_kernel_size: int = 11
    nar_dilation_cycle: Tuple[int, ...] = (1, 2, 4, 8)

    stage_B: Tuple[int, int] = (2, 4)
    stage_C: Tuple[int, int] = (5, 8)
    stage_D: Tuple[int, int] = (9, 16)
    stage_E: Tuple[int, int] = (17, 32)

    sv_student_dim: int = 192
    style_strength: float = 1.0

    ref_enc_layers: int = 2
    ref_xattn_heads: int = 2
    ref_xattn_layers: int = 3
    ref_xattn_gmax: float = 0.35

    @property
    def eos_id(self) -> int:
        # AR vocab is codebook_size + 1; the extra row is EOS
        return int(self.codebook_size)

    @property
    def ar_vocab(self) -> int:
        return int(self.codebook_size) + 1

    def ar_dilations(self) -> Tuple[int, ...]:
        return _cycle_to(self.ar_dilation_cycle, self.n_layers_ar)

    def nar_dilations(self) -> Tuple[int, ...]:
        cycle = tuple(int(x) for x in self.nar_dilation_cycle) or (1,)
        return _cycle_to(cycle, self.n_layers_nar)

    def rf_ar(self) -> int:
        return 1 + (int(self.ar_kernel) - 1) * int(sum(self.ar_dilations()))

    def rf_nar(self) -> int:
        return 1 + (int(self.nar_kernel_size) - 1) * int(sum(self.nar_dilations()))

    def stage_indices(self) -> Dict[str, List[int]]:
        """0-based codebook indices per NAR stage."""
        q = int(self.num_codebooks)
        out: Dict[str, List[int]] = {}
        for name, rng in (
            ("B", self.stage_B),
            ("C", self.stage_C),
            ("D", self.stage_D),
            ("E", self.stage_E),
        ):
            lo, hi = int(rng[0]), int(rng[1])
            out[name] = [i for i in range(lo - 1, hi) if 1 <= i < q]
        return out

    def stage_order(self) -> List[str]:
        idx = self.stage_indices()
        return [s for s in ("B", "C", "D", "E") if len(idx[s]) > 0]

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SoproTTSConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        init = {}
        for k, v in d.items():
            if k not in names:
                continue
            if isinstance(v, list):
                v = tuple(v)
            init[k] = v
        return cls(**init)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        return {k: (list(v) if isinstance(v, tuple) else v) for k, v in d.items()}


def _cycle_to(cycle: Tuple[int, ...], n: int) -> Tuple[int, ...]:
    out: List[int] = []
    while len(out) < int(n):
        out.extend(int(x) for x in cycle)
    return tuple(out[: int(n)])


@dataclass(frozen=True)
class RuntimeConfig:
    """Execution knobs; not part of the checkpoint contract. The port
    computes in float32 only (every tolerance it is held to assumes it)."""

    # Pad text-token sequences to these bucket lengths (same rule as the
    # JAX package, so both packages compute on identical padded shapes).
    text_buckets: Tuple[int, ...] = (16, 32, 64, 128, 256, 512, 1024, 2048)
    # Pad reference-token sequences (frames) to these buckets.
    ref_buckets: Tuple[int, ...] = (32, 64, 96, 128, 160, 256)


def pick_bucket(n: int, buckets: Tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return int(b)
    # beyond the largest bucket: round up to a multiple of it
    top = int(buckets[-1])
    return ((int(n) + top - 1) // top) * top
