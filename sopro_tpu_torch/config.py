"""Model hyper-parameter configuration (counterpart: sopro_tpu/config.py).

`SoproTTSConfig` keeps the checkpoint's exact field set and defaults, so a
`cfg` JSON deserializes unchanged. `RuntimeConfig` takes the JAX package's
fields: the padding buckets, which must match the JAX package's so both
compute on the same padded shapes, the batch grouping, the choice of AR
kernel and of SEANet kernel, and the dtypes (`compute_dtype` float32 or
bfloat16, the JAX package's compute policy).
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


DTYPES = ("float32", "bfloat16")


@dataclass(frozen=True)
class RuntimeConfig:
    """Execution knobs; not part of the checkpoint contract, names and
    defaults as in the JAX package.

    `compute_dtype` "bfloat16" casts every floating parameter of the model
    and the codec to bfloat16 when the engine is built, and every serving
    path then computes in bfloat16 with the JAX package's float32 islands
    (norms, softmaxes, the sampler) and the kernels' bfloat16
    instantiations; "float32" (the default) computes in float32. Three
    fields are accepted for the JAX API's sake and select nothing:
    `param_dtype` (read by no code in either package), `ar_chunk` (read by
    no code) and `use_pallas_vocoder` (the kernels are the only SEANet route
    on the card: False raises there). Either dtype field raises ValueError
    for another value than "float32" or "bfloat16"."""

    compute_dtype: str = "float32"
    param_dtype: str = "float32"
    # Pad text-token sequences to these bucket lengths (same rule as the
    # JAX package, so both packages compute on identical padded shapes).
    text_buckets: Tuple[int, ...] = (16, 32, 64, 128, 256, 512, 1024, 2048)
    # Pad reference-token sequences (frames) to these buckets.
    ref_buckets: Tuple[int, ...] = (32, 64, 96, 128, 160, 256)
    # The adaptive plan's NAR + Mimi decode run over the generated length
    # rounded up to a multiple of this.
    nar_pad_multiple: int = 64
    # The JAX package's AR scan chunk; read by neither package.
    ar_chunk: int = 8
    # synthesize_batch sub-batch size (0: one batch); every group is
    # enqueued before the first is copied to the host.
    batch_pipeline_group: int = 0
    # The per-step AR kernel K5 (`ops/ar_step.py`, `ar_step`), for B <= 2
    # where K1 is not selected. None: on for a CUDA device.
    use_pallas_ar: "bool | None" = None
    # The whole-loop AR kernel K1 (`ops/ar_loop.py`, `ar_loop`) wherever its
    # shared memory fits (`Engine.resident_eligible`). None: on for a CUDA
    # device. On CUDA, a call that neither knob selects raises.
    use_pallas_resident: "bool | None" = None
    # The SEANet kernels K3 and K4 (`codec/vocoder.py`). None or True: the
    # kernels on a CUDA device; False raises there (the port has no other
    # SEANet route on the card). CPU tensors take the plain version either way.
    use_pallas_vocoder: "bool | None" = None

    def __post_init__(self):
        for name in ("compute_dtype", "param_dtype"):
            if getattr(self, name) not in DTYPES:
                raise ValueError(
                    f"RuntimeConfig({name}={getattr(self, name)!r}): takes one of {DTYPES}"
                )


def pick_bucket(n: int, buckets: Tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return int(b)
    # beyond the largest bucket: round up to a multiple of it
    top = int(buckets[-1])
    return ((int(n) + top - 1) // top) * top
