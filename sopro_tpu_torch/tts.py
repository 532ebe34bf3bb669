"""User-facing facade (counterpart: sopro_tpu/tts.py): `SoproTTS` with the
JAX package's argument names and defaults for the synthesize and stream
paths.

Waveforms are numpy float32 [1, S] at 24 kHz on the host. `synthesize` runs
the fused plan for every `max_frames`; `stream` yields chunks from the
stream plan (streaming.py). A reference voice comes as Mimi tokens
(`ref_tokens_tq`) or as a WAV file (`ref_audio_path`: VAD trim, resample to
24 kHz, centre crop, Mimi encode).
"""

from __future__ import annotations

import os
import wave
from typing import Iterator, Optional

import numpy as np
import torch

from sopro_tpu_torch import audio as A
from sopro_tpu_torch.codec.mimi_config import MimiConfig
from sopro_tpu_torch.config import RuntimeConfig, SoproTTSConfig
from sopro_tpu_torch.constants import TARGET_SR
from sopro_tpu_torch.engine import Engine
from sopro_tpu_torch.models.sopro import PreparedReference
from sopro_tpu_torch.tokenizer import SimpleCharTokenizer
from sopro_tpu_torch import weights as W


def center_crop_tokens(tokens_tq: np.ndarray, win: int) -> np.ndarray:
    t = int(tokens_tq.shape[0])
    if t <= win:
        return tokens_tq
    s = (t - win) // 2
    return tokens_tq[s: s + win]


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but no CUDA device is available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class SoproTTS:
    def __init__(
        self,
        engine: Engine,
        cfg: SoproTTSConfig,
        tokenizer,
        runtime: Optional[RuntimeConfig] = None,
    ):
        self.engine = engine
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.rt = runtime or RuntimeConfig()

    @classmethod
    def from_random(
        cls,
        cfg: Optional[SoproTTSConfig] = None,
        *,
        seed: int = 0,
        mimi_cfg: Optional[MimiConfig] = None,
        runtime: Optional[RuntimeConfig] = None,
        device,
    ) -> "SoproTTS":
        """Random-weight instance drawn from a numpy seed, built directly on
        `device` ("cuda" raises when no GPU is present)."""
        dev = _resolve_device(device)
        cfg = cfg or SoproTTSConfig()
        mimi_cfg = mimi_cfg or MimiConfig()
        tokenizer = SimpleCharTokenizer()
        model = W.sopro_params_from_jax(
            W.init_sopro_params(seed, cfg, tokenizer.vocab_size), cfg, dev
        )
        mimi = W.mimi_params_from_jax(W.init_mimi_params(seed, mimi_cfg), mimi_cfg, dev)
        return cls(Engine(model, mimi, runtime), cfg, tokenizer, runtime)

    def encode_text(self, text: str) -> np.ndarray:
        return np.asarray(self.tokenizer.encode(text), np.int32)

    def encode_reference(
        self,
        *,
        ref_audio_path: Optional[str] = None,
        ref_tokens_tq: Optional[np.ndarray] = None,
        ref_seconds: Optional[float] = None,
    ) -> np.ndarray:
        """-> Mimi tokens [T, Q], centre-cropped to `ref_seconds` (default
        12): given tokens directly, or encoded from a WAV file."""
        if (ref_tokens_tq is None) == (ref_audio_path is None):
            raise RuntimeError("Provide exactly one of ref_audio_path or ref_tokens_tq.")
        if ref_seconds is None:
            ref_seconds = 12.0
        if ref_tokens_tq is not None:
            ref = np.asarray(ref_tokens_tq, np.int32)
            if ref_seconds and ref_seconds > 0:
                win = max(1, int(round(ref_seconds * float(self.cfg.mimi_fps))))
                ref = center_crop_tokens(ref, win)
            return ref
        # load -> VAD trim -> resample -> crop -> whole frames -> Mimi encode
        mcfg = self.engine.mimi_cfg
        wav, sr = A.load_audio_file(ref_audio_path)
        wav = A.trim_silence_energy(wav, sr)
        sr_t = int(mcfg.sampling_rate)
        wav = A.resample(wav, sr, sr_t)
        if ref_seconds and ref_seconds > 0:
            fps = float(mcfg.frame_rate)
            win = max(1, int(round(ref_seconds * fps))) * int(round(sr_t / fps))
            wav = A.center_crop_audio(wav, win)
        hop = int(mcfg.hop_length)
        return self.engine.encode_audio(wav[: (wav.shape[-1] // hop) * hop])

    def prepare_reference(
        self,
        *,
        ref_audio_path: Optional[str] = None,
        ref_tokens_tq: Optional[np.ndarray] = None,
        ref_seconds: Optional[float] = None,
    ) -> PreparedReference:
        toks = self.encode_reference(
            ref_audio_path=ref_audio_path, ref_tokens_tq=ref_tokens_tq, ref_seconds=ref_seconds
        )
        return self.engine.prepare_reference(toks)

    def _run(self, text, ref, ref_audio_path, ref_tokens_tq, ref_seconds, style_strength,
             min_gen_frames, return_tokens, **kw):
        if ref is None:
            ref = self.prepare_reference(
                ref_audio_path=ref_audio_path, ref_tokens_tq=ref_tokens_tq, ref_seconds=ref_seconds
            )
        style = float(style_strength if style_strength is not None else self.cfg.style_strength)
        return self.engine.synthesize_fused(
            self.encode_text(text), ref, style_strength=style,
            min_gen=int(min_gen_frames or self.cfg.min_gen_frames),
            return_tokens=return_tokens, **kw,
        )

    def synthesize(
        self,
        text: str,
        *,
        ref: Optional[PreparedReference] = None,
        ref_audio_path: Optional[str] = None,
        ref_tokens_tq: Optional[np.ndarray] = None,
        max_frames: int = 400,
        top_p: float = 0.9,
        temperature: float = 1.05,
        anti_loop: bool = True,
        style_strength: Optional[float] = None,
        ref_seconds: Optional[float] = None,
        min_gen_frames: Optional[int] = None,
        seed: int = 0,
        pcm16: bool = False,
    ) -> np.ndarray:
        """-> wav [1, S] @ 24 kHz, float32 (int16 with `pcm16=True`)."""
        wav, t = self._run(
            text, ref, ref_audio_path, ref_tokens_tq, ref_seconds, style_strength,
            min_gen_frames, False,
            max_frames=max_frames, seed=seed, top_p=top_p, temperature=temperature,
            anti_loop=anti_loop,
        )
        if t <= 0:
            return np.zeros((1, 0), np.int16 if pcm16 else np.float32)
        return to_pcm16(wav) if pcm16 else wav

    def generate_tokens(
        self,
        text: str,
        ref: PreparedReference,
        *,
        max_frames: int = 400,
        top_p: float = 0.9,
        temperature: float = 1.05,
        anti_loop: bool = True,
        style_strength: Optional[float] = None,
        min_gen_frames: Optional[int] = None,
        seed: int = 0,
    ) -> np.ndarray:
        """text + prepared ref -> [T, num_codebooks] token matrix (the tokens
        the fused plan decodes)."""
        _, _, toks = self._run(
            text, ref, None, None, None, style_strength, min_gen_frames, True,
            max_frames=max_frames, seed=seed, top_p=top_p, temperature=temperature,
            anti_loop=anti_loop,
        )
        return toks

    def stream(self, text: str, **kwargs) -> Iterator[np.ndarray]:
        """Chunked synthesis: `streaming.stream` (chunk_frames 6 by default);
        yields wav chunks [1, n*hop] float32."""
        from sopro_tpu_torch.streaming import stream

        return stream(self, text, **kwargs)

    def save_wav(self, path: str, wav: np.ndarray) -> None:
        """Write mono PCM16 WAV at 24 kHz."""
        wav = np.asarray(wav)
        if wav.ndim == 2:
            wav = wav[0] if wav.shape[0] == 1 else wav.mean(axis=0)
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
        with wave.open(path, "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(TARGET_SR)
            f.writeframes(to_pcm16(wav).tobytes())


def to_pcm16(wav: np.ndarray) -> np.ndarray:
    """float [-1, 1] -> int16 with clipping; int16 passes through."""
    wav = np.asarray(wav)
    if wav.dtype == np.int16:
        return wav
    return np.round(np.clip(wav.astype(np.float32), -1.0, 1.0) * 32767.0).astype(np.int16)
