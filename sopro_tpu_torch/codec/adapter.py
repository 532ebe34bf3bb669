"""A `MimiCodec` facade for users who drive the codec directly
(counterpart: sopro_tpu/codec/adapter.py): numpy in and out, over the
port's codec module (`codec/mimi.py`) and stream state
(`codec/streaming.py`).

`encode_file` runs the preprocessing chain of the reference voice (load ->
VAD trim -> resample -> crop to whole frames -> encode); `decode_full` is
the whole-utterance decode (kernel K3 on CUDA); `MimiStreamDecoder.
decode_step` streams chunks with exact carried state (kernel K4 on CUDA).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from sopro_tpu_torch import audio as A
from sopro_tpu_torch.codec import mimi as CM
from sopro_tpu_torch.codec.mimi_config import MimiConfig
from sopro_tpu_torch.codec.streaming import MimiStreamState, init_mimi_stream_state, mimi_decode_step


class MimiCodec:
    def __init__(
        self,
        params: Dict[str, Any],
        cfg: Optional[MimiConfig] = None,
        num_quantizers: Optional[int] = None,
        device="cuda",
    ):
        """`params`: the Mimi tree (numpy, `codec/convert.py`'s layout), put
        on `device`, the card unless the caller asks for "cpu"."""
        from sopro_tpu_torch.tts import _resolve_device
        from sopro_tpu_torch.weights import mimi_params_from_jax

        self.cfg = cfg or MimiConfig()
        self.device = _resolve_device(device)
        self.module: CM.MimiCodec = mimi_params_from_jax(params, self.cfg, self.device)
        self.num_quantizers = int(num_quantizers or self.cfg.num_quantizers)

    @classmethod
    def from_pretrained(cls, repo_id: str, **kwargs) -> "MimiCodec":
        """A Mimi snapshot (model.safetensors, config.json): a local directory
        or a hub repo id that `hub.download_repo` resolves; `kwargs` go to
        the constructor."""
        from sopro_tpu_torch.hub import download_repo, load_mimi_checkpoint

        local = download_repo(repo_id)
        cfg, params = load_mimi_checkpoint(os.path.join(local, "model.safetensors"),
                                           cfg_json=os.path.join(local, "config.json"))
        return cls(params, cfg, **kwargs)

    @property
    def sample_rate(self) -> int:
        return int(self.cfg.sampling_rate)

    @property
    def codebook_size(self) -> int:
        return int(self.cfg.codebook_size)

    @torch.inference_mode()
    def encode_file(self, wav_path: str, *, crop_seconds: Optional[float] = None) -> np.ndarray:
        """An audio file -> Mimi tokens [T, Q]."""
        wav, sr = A.load_audio_file(wav_path)
        wav = A.trim_silence_energy(wav, sr)
        wav = A.resample(wav, sr, self.sample_rate)
        hop = self.cfg.hop_length
        if crop_seconds is not None and crop_seconds > 0:
            fps = float(self.cfg.frame_rate)
            wav = A.center_crop_audio(wav, max(1, int(round(crop_seconds * fps))) * hop)
        t = (wav.shape[-1] // hop) * hop
        x = torch.from_numpy(np.asarray(wav[:t], np.float32))[None].to(self.device)
        return CM.mimi_encode(self.module.p, self.cfg, x, self.num_quantizers)[0].cpu().numpy()

    @torch.inference_mode()
    def decode_full(self, codes_tq: np.ndarray) -> np.ndarray:
        """[T, Q] tokens -> wav [1, T*hop]."""
        codes = torch.from_numpy(np.asarray(codes_tq, np.int32))[None].to(self.device)
        return self.module(codes).cpu().numpy()


class MimiStreamDecoder:
    """Chunked decode with exact carried state."""

    def __init__(self, codec: MimiCodec):
        self.codec = codec

    def init_state(self) -> MimiStreamState:
        return init_mimi_stream_state(self.codec.cfg, 1, self.codec.device)

    @torch.inference_mode()
    def decode_step(
        self, codes_tq: np.ndarray, state: Optional[MimiStreamState] = None
    ) -> Tuple[np.ndarray, MimiStreamState]:
        """[n, Q] new frames -> (wav [1, n*hop], the new state)."""
        if state is None:
            state = self.init_state()
        m = self.codec.module
        codes = torch.from_numpy(np.asarray(codes_tq, np.int32))[None].to(self.codec.device)
        wav, state = mimi_decode_step(m.p, self.codec.cfg, codes, state, packed=m.packed_decoder())
        return wav.cpu().numpy(), state
