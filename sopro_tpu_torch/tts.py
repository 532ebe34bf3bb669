"""User-facing facade (counterpart: sopro_tpu/tts.py): `SoproTTS` with the
JAX package's argument names and defaults for the synthesize, batch,
long-form and stream paths.

Waveforms are numpy float32 [1, S] at 24 kHz on the host. `synthesize` runs
the fused plan for `max_frames` >= 256 and the adaptive plan below that (or
as `fused=` says); `synthesize_batch` runs padded batches of texts, each row
with its own seed; `synthesize_long` splits a text into sentence chunks and
runs them as one batch; `stream` yields chunks from the stream plan
(streaming.py). A reference voice comes as Mimi tokens (`ref_tokens_tq`) or
as a WAV file (`ref_audio_path`: VAD trim, resample to 24 kHz, centre crop,
Mimi encode).

`from_pretrained` loads a local snapshot directory (model.safetensors with
its cfg, the BPE tokenizer, and a Mimi snapshot directory with
model.safetensors and config.json); `save_pretrained` writes the Sopro
weights back in the same format; `from_random` draws weights from a seed.
"""

from __future__ import annotations

import os
import re
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from sopro_tpu_torch import audio as A
from sopro_tpu_torch import hub as H
from sopro_tpu_torch import weights as W
from sopro_tpu_torch.codec.mimi_config import MimiConfig
from sopro_tpu_torch.config import RuntimeConfig, SoproTTSConfig
from sopro_tpu_torch.constants import DEFAULT_MIMI_ID, TARGET_SR
from sopro_tpu_torch.engine import Engine
from sopro_tpu_torch.models.sopro import PreparedReference, tile_reference
from sopro_tpu_torch.tokenizer import SimpleCharTokenizer, TextTokenizer


def center_crop_tokens(tokens_tq: np.ndarray, win: int) -> np.ndarray:
    t = int(tokens_tq.shape[0])
    if t <= win:
        return tokens_tq
    s = (t - win) // 2
    return tokens_tq[s: s + win]


def split_sentences(text: str, max_chars: int = 350) -> List[str]:
    """Split text into sentence chunks of at most ~max_chars for long-form
    synthesis past the 400-frame cap: breaks after . ! ? ; and at line
    breaks, keeping the punctuation; sentences merge greedily up to
    max_chars; an over-long sentence falls back to comma, then space breaks
    (the JAX package's rule)."""
    text = text.strip()
    if not text:
        return []
    raw = [s.strip() for s in re.split(r"(?<=[.!?;])\s+|\n+", text) if s.strip()]

    def hard_split(s: str) -> List[str]:
        out = []
        while len(s) > max_chars:
            window = s[: max_chars + 1]
            comma = window.rfind(", ")
            cut = comma + 1 if comma > 0 else window.rfind(" ")
            if cut <= 0:
                cut = max_chars
            out.append(s[:cut].strip())
            s = s[cut:].lstrip(", ").strip()
        return out + [s] if s else out

    merged: List[str] = []
    for p in (p for s in raw for p in hard_split(s)):
        if merged and len(merged[-1]) + 1 + len(p) <= max_chars:
            merged[-1] = merged[-1] + " " + p
        else:
            merged.append(p)
    return merged


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
    def from_pretrained(
        cls,
        repo_id: str,
        *,
        mimi_repo_id: str = DEFAULT_MIMI_ID,
        runtime: Optional[RuntimeConfig] = None,
        device="cuda",
        tokenizer=None,
        on_unconsumed: str = "warn",
    ) -> "SoproTTS":
        """Load local snapshot directories: `repo_id` holds model.safetensors
        (its cfg in the metadata) and the tokenizer files, `mimi_repo_id`
        the Mimi model.safetensors and config.json. A name that is not a
        directory raises FileNotFoundError (nothing is downloaded). The
        tokenizer is the snapshot's BPE `TextTokenizer` unless `tokenizer`
        is given (e.g. SimpleCharTokenizer() for a snapshot of random
        weights); `on_unconsumed` says what a tensor that no converter reads
        does ("warn", "raise", "ignore"). Built on `device`, the card unless
        the caller asks for "cpu"."""
        dev = _resolve_device(device)
        local = H.local_dir(repo_id)
        model_path = os.path.join(local, "model.safetensors")
        if not os.path.exists(model_path):
            raise FileNotFoundError(f"Expected {model_path} in repo snapshot.")
        cfg, params = H.load_sopro_checkpoint(model_path, on_unconsumed=on_unconsumed)
        mimi_local = H.local_dir(mimi_repo_id)
        mimi_cfg, mimi_params = H.load_mimi_checkpoint(
            os.path.join(mimi_local, "model.safetensors"),
            cfg_json=os.path.join(mimi_local, "config.json"), on_unconsumed=on_unconsumed,
        )
        tokenizer = tokenizer if tokenizer is not None else TextTokenizer(model_name=local)
        model = W.sopro_params_from_jax(params, cfg, dev)
        mimi = W.mimi_params_from_jax(mimi_params, mimi_cfg, dev)
        return cls(Engine(model, mimi, runtime), cfg, tokenizer, runtime)

    @classmethod
    def from_random(
        cls,
        cfg: Optional[SoproTTSConfig] = None,
        *,
        seed: int = 0,
        with_codec: bool = True,
        mimi_cfg: Optional[MimiConfig] = None,
        runtime: Optional[RuntimeConfig] = None,
        device="cuda",
    ) -> "SoproTTS":
        """Random-weight instance drawn from a numpy seed, built directly on
        `device`: the card unless the caller asks for "cpu" ("cuda" raises
        when no GPU is present). With `with_codec=False` there is no Mimi
        codec: AR decode and NAR refine run, decoding raises."""
        dev = _resolve_device(device)
        cfg = cfg or SoproTTSConfig()
        tokenizer = SimpleCharTokenizer()
        model = W.sopro_params_from_jax(
            W.init_sopro_params(seed, cfg, tokenizer.vocab_size), cfg, dev
        )
        mimi = None
        if with_codec:
            mimi_cfg = mimi_cfg or MimiConfig()
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
        mcfg = self.engine.codec.cfg
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

    def encode_speaker(
        self,
        *,
        ref_audio_path: Optional[str] = None,
        ref_tokens_tq: Optional[np.ndarray] = None,
        ref_seconds: Optional[float] = None,
    ) -> np.ndarray:
        """-> speaker embedding [sv_dim] of the reference (Token2SV)."""
        toks = self.encode_reference(
            ref_audio_path=ref_audio_path, ref_tokens_tq=ref_tokens_tq, ref_seconds=ref_seconds
        )
        return self.engine.token2sv(toks)

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

    def _ref(self, ref, ref_audio_path, ref_tokens_tq, ref_seconds) -> PreparedReference:
        if ref is not None:
            return ref
        return self.prepare_reference(
            ref_audio_path=ref_audio_path, ref_tokens_tq=ref_tokens_tq, ref_seconds=ref_seconds
        )

    def _style(self, style_strength: Optional[float]) -> float:
        return float(style_strength if style_strength is not None else self.cfg.style_strength)

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
        fused: Optional[bool] = None,
    ) -> np.ndarray:
        """-> wav [1, S] @ 24 kHz, float32 (int16 with `pcm16=True`).

        `fused=None` picks the plan as the JAX package does: the fused plan
        (NAR and Mimi decode over all max_frames+1 frames, one copy to the
        host) when max_frames >= 256, else the adaptive plan (AR decode,
        then NAR and Mimi decode over the generated length rounded up to
        `nar_pad_multiple`)."""
        ref = self._ref(ref, ref_audio_path, ref_tokens_tq, ref_seconds)
        ids = self.encode_text(text)
        empty = np.zeros((1, 0), np.int16 if pcm16 else np.float32)
        sampling = dict(max_frames=max_frames, seed=seed, top_p=top_p,
                        temperature=temperature, anti_loop=anti_loop)
        if fused if fused is not None else int(max_frames) >= 256:
            wav, t = self.engine.synthesize_fused(
                ids, ref, style_strength=self._style(style_strength),
                min_gen=int(min_gen_frames or self.cfg.min_gen_frames), **sampling,
            )
            if t <= 0:
                return empty
            return A.pcm16(wav) if pcm16 else wav
        prep = self.engine.prepare_conditioning(
            ids, ref, max_frames=max_frames, style_strength=self._style(style_strength)
        )
        tokens_dev, t = self.engine.ar_generate_device(
            prep, min_gen_frames=min_gen_frames, **sampling
        )
        if t <= 0:
            return empty
        return self.engine.nar_decode_fused(prep["cond_ar"], tokens_dev, t, pcm16=pcm16)

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
        """text + prepared ref -> [T, num_codebooks] token matrix: AR decode,
        then the NAR over the generated length's frame bucket."""
        prep = self.engine.prepare_conditioning(
            self.encode_text(text), ref, max_frames=max_frames,
            style_strength=self._style(style_strength),
        )
        rvq1, t = self.engine.ar_generate(
            prep, max_frames=max_frames, seed=seed, top_p=top_p, temperature=temperature,
            anti_loop=anti_loop, min_gen_frames=min_gen_frames,
        )
        if t <= 0:
            return np.zeros((0, self.cfg.num_codebooks), np.int32)
        return self.engine.nar_refine(prep["cond_ar"], rvq1, t)

    def synthesize_batch(
        self,
        texts: Sequence[str],
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
        seeds: Optional[Sequence[int]] = None,
        pcm16: bool = False,
        pipeline_group: Optional[int] = None,
    ) -> List[np.ndarray]:
        """Batched synthesis with one reference: the texts decode as padded
        batches, each row with its own seed (default: its index) and its own
        EOS, one NAR + Mimi decode per group. Groups of `pipeline_group` rows
        (default `RuntimeConfig.batch_pipeline_group`, 0: one group) are all
        enqueued before the first is copied to the host. Returns one
        [1, S_i] waveform per text (float32, or int16 with `pcm16=True`,
        converted on the device); row i equals `synthesize(texts[i],
        seed=seeds[i], fused=True)`."""
        ref = self._ref(ref, ref_audio_path, ref_tokens_tq, ref_seconds)
        b = len(texts)
        seeds = list(seeds) if seeds is not None else list(range(b))
        g = int(pipeline_group or self.rt.batch_pipeline_group or b) or b
        ids_rows = [self.encode_text(t) for t in texts]
        hop = int(self.engine.codec.cfg.hop_length)
        packed = [
            self.engine.synthesize_batch_dispatch(
                ids_rows[lo: lo + g], tile_reference(ref, len(ids_rows[lo: lo + g])),
                max_frames=max_frames, style_strength=self._style(style_strength),
                seeds=seeds[lo: lo + g], top_p=top_p, temperature=temperature,
                anti_loop=anti_loop, min_gen=int(min_gen_frames or self.cfg.min_gen_frames),
                pcm16=pcm16,
            )
            for lo in range(0, b, g)
        ]
        outs = []
        for p in packed:
            wav, lengths = self.engine.synthesize_batch_read(p)
            outs.extend(wav[i: i + 1, : int(lengths[i]) * hop] for i in range(wav.shape[0]))
        return outs

    def synthesize_long(
        self,
        text: str,
        *,
        ref: Optional[PreparedReference] = None,
        ref_audio_path: Optional[str] = None,
        ref_tokens_tq: Optional[np.ndarray] = None,
        max_frames: int = 400,
        gap_ms: float = 120.0,
        max_chars: int = 350,
        seed: int = 0,
        pcm16: bool = False,
        **kwargs,
    ) -> np.ndarray:
        """Synthesis past the 400-frame cap: `split_sentences`, then one
        chunk goes to `synthesize`, several to one `synthesize_batch` with
        seeds seed + i, joined with `gap_ms` of silence between chunks.
        Chunks take the other keyword arguments (top_p, temperature, ...).
        Returns wav [1, S] (int16 with `pcm16=True`)."""
        ref = self._ref(ref, ref_audio_path, ref_tokens_tq, kwargs.pop("ref_seconds", None))
        chunks = split_sentences(text, max_chars=max_chars)
        dtype = np.int16 if pcm16 else np.float32
        if not chunks:
            return np.zeros((1, 0), dtype)
        if len(chunks) == 1:
            return self.synthesize(
                chunks[0], ref=ref, max_frames=max_frames, seed=seed, pcm16=pcm16, **kwargs
            )
        outs = self.synthesize_batch(
            chunks, ref=ref, max_frames=max_frames,
            seeds=[seed + i for i in range(len(chunks))], pcm16=pcm16, **kwargs,
        )
        gap = np.zeros((1, int(round(gap_ms / 1000.0 * TARGET_SR))), dtype)
        parts = [x for i, w in enumerate(outs) for x in ((gap,) if i else ()) + (w.astype(dtype),)]
        return np.concatenate(parts, axis=1)

    def stream(self, text: str, **kwargs) -> Iterator[np.ndarray]:
        """Chunked synthesis: `streaming.stream` (chunk_frames 6 by default);
        yields wav chunks [1, n*hop] float32."""
        from sopro_tpu_torch.streaming import stream

        return stream(self, text, **kwargs)

    def save_wav(self, path: str, wav: np.ndarray) -> None:
        """Write mono PCM16 WAV at 24 kHz (`audio.save_audio`)."""
        A.save_audio(path, wav, TARGET_SR)

    def save_pretrained(self, out_dir: str) -> str:
        """Write `out_dir/model.safetensors` (reference names and layouts,
        float32, the cfg embedded as metadata) and the tokenizer files where
        the tokenizer has them; returns the model file's path."""
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, "model.safetensors")
        H.save_sopro_checkpoint(path, W.sopro_tree(self.engine.model), self.cfg)
        tok = getattr(self.tokenizer, "tok", None)
        if tok is not None and hasattr(tok, "save_pretrained"):
            tok.save_pretrained(out_dir)
        return path
