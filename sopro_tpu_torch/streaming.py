"""Streaming synthesis (counterpart: sopro_tpu/streaming.py): chunked
AR decode, windowed NAR re-refinement and the exact streaming Mimi decode.

A chunk boundary falls every `chunk_frames` AR frames. Each chunk's frames
are refined by the NAR over a trailing window of `nar_context_frames`
(default: the NAR receptive field, `cfg.rf_nar()`), and only the new frames
are vocoded; EOS ends the stream with what remains. One engine call, and one
device->host copy, per chunk (engine.py `stream_start_fused` /
`stream_step_fused`).

`stream()` defaults to chunk_frames=6 and `StreamConfig` to 16, as in the
JAX package.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from sopro_tpu_torch.models.sopro import PreparedReference


@dataclass
class StreamConfig:
    chunk_frames: int = 16
    nar_context_frames: Optional[int] = None


class SoproTTSStreamer:
    def __init__(self, tts, cfg: Optional[StreamConfig] = None):
        self.tts = tts
        self.cfg = cfg or StreamConfig()
        # set by stream(): wall seconds from the call to its first chunk
        self.last_ttfa_s: Optional[float] = None

    def stream(
        self,
        text: str,
        *,
        ref_audio_path: Optional[str] = None,
        ref_tokens_tq: Optional[np.ndarray] = None,
        ref: Optional[PreparedReference] = None,
        max_frames: int = 400,
        top_p: float = 0.9,
        temperature: float = 1.05,
        anti_loop: bool = True,
        style_strength: Optional[float] = None,
        ref_seconds: Optional[float] = None,
        chunk_frames: Optional[int] = None,
        nar_context_frames: Optional[int] = None,
        min_gen_frames: Optional[int] = None,
        seed: int = 0,
    ) -> Iterator[np.ndarray]:
        tts, eng = self.tts, self.tts.engine
        t_start = time.perf_counter()
        self.last_ttfa_s = None
        if ref is None:
            ref = tts.prepare_reference(
                ref_audio_path=ref_audio_path, ref_tokens_tq=ref_tokens_tq,
                ref_seconds=ref_seconds,
            )
        cf = int(chunk_frames if chunk_frames is not None else self.cfg.chunk_frames)
        nar_ctx = next(
            (int(v) for v in (nar_context_frames, self.cfg.nar_context_frames) if v is not None),
            int(tts.cfg.rf_nar()),
        )
        style = float(style_strength if style_strength is not None else tts.cfg.style_strength)
        min_gen = int(min_gen_frames or tts.cfg.min_gen_frames)
        sampling = dict(top_p=top_p, temperature=temperature, anti_loop=anti_loop, min_gen=min_gen)
        hop = int(eng.codec.cfg.hop_length)

        wav, valid, done, carry, ctx, cond, mstate = eng.stream_start_fused(
            tts.encode_text(text), ref, max_frames=max_frames, chunk=cf,
            style_strength=style, seed=seed, **sampling,
        )
        emitted = valid
        if emitted > 0:
            self.last_ttfa_s = time.perf_counter() - t_start
            yield wav[:, : emitted * hop]
        while not done:
            wav, valid, done, carry, mstate = eng.stream_step_fused(
                carry, ctx, cond, mstate, emitted, chunk=cf, nar_ctx=nar_ctx, **sampling,
            )
            n_new = valid - emitted
            if n_new > 0:
                emitted = valid
                if self.last_ttfa_s is None:
                    self.last_ttfa_s = time.perf_counter() - t_start
                yield wav[:, : n_new * hop]


def stream(
    tts,
    text: str,
    *,
    ref_audio_path: Optional[str] = None,
    ref_tokens_tq: Optional[np.ndarray] = None,
    ref: Optional[PreparedReference] = None,
    chunk_frames: int = 6,
    **kwargs,
) -> Iterator[np.ndarray]:
    """Chunks of `tts.stream`, chunk_frames 6 by default."""
    streamer = SoproTTSStreamer(tts, StreamConfig(chunk_frames=chunk_frames))
    return streamer.stream(
        text, ref_audio_path=ref_audio_path, ref_tokens_tq=ref_tokens_tq, ref=ref,
        chunk_frames=chunk_frames, **kwargs,
    )
