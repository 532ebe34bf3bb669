"""Host-side audio I/O for reference voices and outputs (counterpart:
sopro_tpu/audio.py): loading, saving 16-bit WAV, polyphase resampling,
energy VAD trim and centre crop. Waveforms are numpy float32, mono, shape
[S].

WAV comes through the standard library's `wave` (8/16/24/32-bit PCM) or
`scipy.io.wavfile` (IEEE float and the formats `wave` refuses); mp3 and ogg
vorbis through the repository's native decoder (`native.decode_file`,
which opens the system's libmpg123 / libvorbisfile). Other containers raise
a ValueError.
"""

from __future__ import annotations

import math
import os
import wave
from typing import Tuple

import numpy as np


def load_audio_file(path: str) -> Tuple[np.ndarray, int]:
    """Read an audio file -> (mono float32 [S], sample rate)."""
    if str(path).lower().endswith(".wav"):
        try:
            return _load_wav_stdlib(path)
        except wave.Error:
            from scipy.io import wavfile

            sr, data = wavfile.read(path)
            return _to_float_mono(data), int(sr)
    from sopro_tpu_torch import native

    try:
        return native.decode_file(str(path))
    except ValueError as e:
        raise ValueError(f"{e} (references are read as WAV, mp3 or ogg vorbis)") from None


def _load_wav_stdlib(path: str) -> Tuple[np.ndarray, int]:
    with wave.open(path, "rb") as f:
        sr, n, ch, width = f.getframerate(), f.getnframes(), f.getnchannels(), f.getsampwidth()
        raw = f.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 3:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3).astype(np.int32)
        i32 = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
        i32 = np.where(i32 >= 1 << 23, i32 - (1 << 24), i32)
        data = i32.astype(np.float32) / float(1 << 23)
    else:
        raise ValueError(f"unsupported WAV sample width {width}")
    if ch > 1:
        data = data.reshape(-1, ch).mean(axis=1)
    return data.astype(np.float32), int(sr)


def _to_float_mono(data: np.ndarray) -> np.ndarray:
    if data.dtype == np.int16:
        out = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        out = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        out = (data.astype(np.float32) - 128.0) / 128.0
    else:
        out = data.astype(np.float32)
    return out.mean(axis=1) if out.ndim > 1 else out


def save_audio(path: str, wav: np.ndarray, sr: int = 24000) -> None:
    """Write mono PCM16 WAV. Takes [S], [C, S] (downmixed; int16 rows from
    a pcm16 call are written as they are when there is one) or [1, C, S]."""
    wav = np.asarray(wav)
    if wav.ndim == 3:
        wav = wav[0]
    if wav.ndim == 2:
        if wav.dtype == np.int16 and wav.shape[0] == 1:
            wav = wav[0]
        else:
            wav = (wav.astype(np.float32) / 32768.0 if wav.dtype == np.int16 else wav).mean(axis=0)
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(int(sr))
        f.writeframes(pcm16(wav).tobytes())


def pcm16(wav: np.ndarray) -> np.ndarray:
    """float [-1, 1] -> int16 with clipping; int16 passes through."""
    wav = np.asarray(wav)
    if wav.dtype == np.int16:
        return wav
    return np.round(np.clip(wav.astype(np.float32), -1.0, 1.0) * 32767.0).astype(np.int16)


def resample(wav: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase resampling with scipy's Kaiser-windowed filter (beta 5), the
    filter the JAX package's native resampler matches."""
    if sr_in == sr_out:
        return np.asarray(wav, np.float32)
    from scipy.signal import resample_poly

    g = math.gcd(int(sr_in), int(sr_out))
    x = np.ascontiguousarray(wav, np.float64).ravel()
    return resample_poly(x, sr_out // g, sr_in // g, window=("kaiser", 5.0)).astype(np.float32)


def trim_silence_energy(
    wav: np.ndarray,
    sr: int,
    frame_ms: float = 25.0,
    hop_ms: float = 10.0,
    thresh_db_floor: float = -40.0,
    prepad_ms: float = 30.0,
    postpad_ms: float = 30.0,
    min_keep_sec: float = 0.5,
) -> np.ndarray:
    """Energy VAD trim: 25 ms frames every 10 ms, keep the span of frames
    within 40 dB of the loudest, pad 30 ms each side; the input comes back
    whole when the span is under 0.5 s."""
    wav = np.asarray(wav, np.float32)
    t = wav.shape[-1]
    if t == 0 or t < int(sr * 0.1):
        return wav
    frame_len = max(1, int(sr * frame_ms / 1000.0))
    hop = max(1, int(sr * hop_ms / 1000.0))
    if t < frame_len:
        return wav

    mono = wav if wav.ndim == 1 else wav.mean(axis=0)
    n_frames = 1 + (t - frame_len) // hop
    idx = np.arange(frame_len)[None, :] + hop * np.arange(n_frames)[:, None]
    energy_db = 10.0 * np.log10(np.mean(np.square(mono[idx]), axis=1) + 1e-10)
    thresh_db = max(float(energy_db.max()) + thresh_db_floor, thresh_db_floor)
    voiced = np.nonzero(energy_db > thresh_db)[0]
    if voiced.size == 0:
        return wav

    start = max(0, int(voiced[0]) * hop - int(sr * prepad_ms / 1000.0))
    end = min(t, int(voiced[-1]) * hop + frame_len + int(sr * postpad_ms / 1000.0))
    if end <= start or (end - start) < int(min_keep_sec * sr):
        return wav
    return wav[..., start:end]


def center_crop_audio(wav: np.ndarray, win_samples: int) -> np.ndarray:
    if win_samples <= 0:
        return wav
    t = int(wav.shape[-1])
    if t <= win_samples:
        return wav
    s = (t - win_samples) // 2
    return wav[..., s: s + win_samples]
