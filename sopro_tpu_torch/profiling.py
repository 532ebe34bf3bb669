"""Observability (counterpart: sopro_tpu/profiling.py): per-utterance
metrics, a section timer, a device trace through `torch.profiler`, and
analytic FLOP counts of the kernels' stages and of a training step.

`enable_compilation_cache` has no counterpart: it points XLA's persistent
cache of compiled programs at a directory, and the port compiles no graphs.
Its kernels are built once by nvcc into `build/kernels/`, keyed by a hash of
their sources (`kernels.py`), which plays that part.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def device_trace(out_dir: str, device="cuda"):
    """Profile the block with `torch.profiler` (host activity, and the card's
    kernels when `device` is CUDA) and write a Chrome trace to
    `out_dir/trace.json` (open it in chrome://tracing or Perfetto). Yields
    the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(out_dir, TRACE_FILE))


@dataclass
class GenerationMetrics:
    """Per-utterance structured metrics."""

    ttfa_s: Optional[float] = None
    wall_s: float = 0.0
    audio_s: float = 0.0
    frames: int = 0

    @property
    def rtf(self) -> float:
        return self.wall_s / self.audio_s if self.audio_s > 0 else float("inf")

    @property
    def frames_per_s(self) -> float:
        return self.frames / self.wall_s if self.wall_s > 0 else 0.0

    def to_dict(self) -> Dict:
        return {
            "ttfa_ms": round(self.ttfa_s * 1000, 1) if self.ttfa_s else None,
            "wall_s": round(self.wall_s, 4),
            "audio_s": round(self.audio_s, 3),
            "rtf": round(self.rtf, 5),
            "frames_per_s": round(self.frames_per_s, 1),
        }


class Timer:
    """Named section timer: `with timer.section("ar"): ...`."""

    def __init__(self):
        self.sections: Dict[str, float] = {}
        self._order: List[str] = []

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if name not in self.sections:
                self._order.append(name)
            self.sections[name] = self.sections.get(name, 0.0) + dt

    def report(self) -> str:
        return " ".join(f"{k}={self.sections[k] * 1000:.1f}ms" for k in self._order)


# --------------------------------------------------------------------------
# analytic FLOP counts (matmuls and convolutions, 2 per multiply-add)
# --------------------------------------------------------------------------
#
# The JAX package's conventions, so a count means the same in both packages:
# a conv is 2*T*k*Cin*Cout, a transpose conv in its polyphase dense form
# 2*T*(2*Cin)*(s*Cout); elementwise work is not counted.


def _ssmlite_flops(d: int, k: int) -> int:
    """One SSMLite block for one frame: GLU d->2d (4d^2), FFN d->4d->d
    (16d^2), depthwise conv (2kd)."""
    return 20 * d * d + 2 * k * d


def ar_step_flops(cfg, text_len: int) -> float:
    """Matmul FLOPs of ONE AR decode step for ONE row: per SSMLite block
    20d^2 + 2kd; per text cross-attention (every `ar_text_attn_freq`-th
    block) the q and out projections (4d^2) and the score / value
    contractions over `text_len` keys (4Ld); the head d -> codebook_size+1."""
    d = int(cfg.d_model)
    n_x = sum(1 for i in range(int(cfg.n_layers_ar)) if (i + 1) % int(cfg.ar_text_attn_freq) == 0)
    xattn = 4 * d * d + 4 * int(text_len) * d
    head = 2 * d * (int(cfg.codebook_size) + 1)
    return float(int(cfg.n_layers_ar) * _ssmlite_flops(d, int(cfg.ar_kernel)) + n_x * xattn + head)


def ar_loop_flops(cfg, batch: int, text_len: int, steps: int) -> float:
    """Algorithmic FLOPs of the whole AR decode (`steps` steps, `batch` rows)."""
    return float(batch) * float(steps) * ar_step_flops(cfg, text_len)


def nar_heads_flops(cfg, batch: int, t: int) -> float:
    """Matmul FLOPs of every stage's head projections (z + hid_h) @ W_h over
    `batch` rows of `t` frames: 2*B*T*H*hd*V (kernel K2's product)."""
    hd, v = int(cfg.nar_head_dim), int(cfg.codebook_size)
    n_heads = sum(len(ix) for ix in cfg.stage_indices().values())
    return 2.0 * float(batch) * float(t) * n_heads * hd * v


def seanet_decoder_flops(mimi_cfg, batch: int, t25: int) -> float:
    """Algorithmic FLOPs of the SEANet decoder (kernel K3's stage) for
    `batch` rows of `t25` 25 Hz frames, over `codec.mimi_config.decoder_plan`."""
    from sopro_tpu_torch.codec.mimi_config import CONV, CONVT, RESNET, decoder_plan

    t = int(t25)
    total = 0.0
    for kind, spec in decoder_plan(mimi_cfg):
        if kind == CONV:
            total += 2.0 * t * spec["k"] * spec["in"] * spec["out"]
        elif kind == CONVT:
            s = int(spec["stride"])
            total += 2.0 * t * (2 * spec["in"]) * (s * spec["out"])
            t *= s
        elif kind == RESNET:
            c3, c1 = spec["convs"]
            total += 2.0 * t * c3["k"] * c3["in"] * c3["out"]
            total += 2.0 * t * c1["k"] * c1["in"] * c1["out"]
    return float(batch) * total


def nar_trunk_flops(cfg, batch: int, t: int) -> float:
    """Matmul FLOPs of the NAR trunks of every stage over `batch` rows of `t`
    frames: per stage and frame the SSMLite blocks and the pre-head
    projection d -> head_dim (the heads are `nar_heads_flops`)."""
    d = int(cfg.d_model)
    per_stage = (int(cfg.n_layers_nar) * _ssmlite_flops(d, int(cfg.nar_kernel_size))
                 + 2 * d * int(cfg.nar_head_dim))
    return float(batch) * float(t) * len(cfg.stage_order()) * per_stage


def conditioning_flops(cfg, batch: int, t: int, text_len: int, ref_len: int) -> float:
    """Matmul FLOPs of the conditioning of `batch` rows: the text encoder over
    `text_len` tokens and the AR text K/V (2 x 2d^2 per token per text
    cross-attention), the reference encoder and the reference K/V over
    `ref_len` frames, and the reference cross-attention over `t` frames
    (q and out projections, scores and values over `ref_len` keys).
    Token2SV's 192-wide stack is left out (under 1 % at full width)."""
    d = int(cfg.d_model)
    n_x = sum(1 for i in range(int(cfg.n_layers_ar)) if (i + 1) % int(cfg.ar_text_attn_freq) == 0)
    text = text_len * (int(cfg.n_layers_text) * _ssmlite_flops(d, 7) + n_x * 4 * d * d)
    n_ref = int(cfg.ref_xattn_layers)
    ref = ref_len * (int(cfg.ref_enc_layers) * _ssmlite_flops(d, 7) + n_ref * 4 * d * d)
    frames = t * n_ref * (4 * d * d + 4 * ref_len * d)
    return float(batch) * float(text + ref + frames)


def train_step_flops(cfg, batch: int, t: int, text_len: int, ref_len: int) -> float:
    """Matmul FLOPs of one training step (`train.loss_fn` forward and its
    backward, counted as twice the forward) over `batch` rows of `t` frames:
    the teacher-forced AR stack (`ar_step_flops` per frame), the NAR trunks
    and heads, and the conditioning."""
    fwd = (float(batch) * float(t) * ar_step_flops(cfg, text_len)
           + nar_trunk_flops(cfg, batch, t) + nar_heads_flops(cfg, batch, t)
           + conditioning_flops(cfg, batch, t, text_len, ref_len))
    return 3.0 * fwd
