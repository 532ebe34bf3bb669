"""`MoshiDuplex`: Moshi (Kyutai's full-duplex speech-text model, moshiko)
on the port, speaking while the user's audio keeps arriving, decoding to
24 kHz through the Mimi codec the Sopro and CSM paths use.

    duplex = MoshiDuplex.from_pretrained("kmhf/hf-moshiko")   # or a local snapshot
    history = duplex.prepare_history(text_ids, moshi_codes_tq, user_codes_tq)
    wav, text_ids, codes = duplex.converse(history, user_codes_tq=next_user_frames,
                                           max_frames=100, seed=7)

A history is the conversation so far, frame by frame at 12.5 Hz: Moshi's
text ids [H] (its inner monologue, one token a frame), Moshi's Mimi codes
[H, 8] and the user's [H, 8]. A call generates `max_frames` frames of
Moshi's speech while the user's next `max_frames` frames of codes stream
in, and returns the waveform [1, max_frames * hop_length], Moshi's text
ids [max_frames] and Moshi's codes [max_frames, 8], which the next call's
history takes. No frame ends a call.

A snapshot is transformers' `MoshiForConditionalGeneration` format:
config.json (the codec's config under `audio_encoder_config`),
model.safetensors or its shards (the Mimi codec under `audio_encoder.*`).
Text ids are SentencePiece ids of Kyutai's 32k vocabulary; tokenizing is
the caller's.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from sopro_tpu_torch import hub as H
from sopro_tpu_torch import weights as W
from sopro_tpu_torch.codec.convert import convert_mimi_state_dict
from sopro_tpu_torch.codec.mimi_config import MimiConfig
from sopro_tpu_torch.models.moshi import MoshiConfig, MoshiModel
from sopro_tpu_torch.moshi_engine import MoshiEngine, MoshiHistory
from sopro_tpu_torch.profiling import span
from sopro_tpu_torch.tts import _resolve_device


class MoshiDuplex:
    def __init__(self, engine: MoshiEngine):
        self.engine = engine
        self.cfg: MoshiConfig = engine.cfg

    @classmethod
    def from_state_dicts(cls, moshi_sd: Dict[str, np.ndarray], mimi_sd: Dict[str, np.ndarray],
                         cfg: MoshiConfig = MoshiConfig(), mimi_cfg: MimiConfig = MimiConfig(), *,
                         device="cuda") -> "MoshiDuplex":
        """From transformers-named state dicts: Moshi's
        (`hub.moshi_params_from_flat`) and the Mimi codec's (MimiModel
        names)."""
        dev = _resolve_device(device)
        model = MoshiModel(W.to_torch(H.moshi_params_from_flat(moshi_sd, cfg), dev), cfg)
        mimi = W.mimi_params_from_jax(convert_mimi_state_dict(mimi_sd, mimi_cfg), mimi_cfg, dev)
        return cls(MoshiEngine(model, mimi))

    @classmethod
    def from_pretrained(cls, repo_id: str, *, revision: Optional[str] = None,
                        cache_dir: Optional[str] = None, token: Optional[str] = None,
                        device="cuda") -> "MoshiDuplex":
        """A snapshot (module docstring): a local directory or a hub repo id
        that `hub.download_repo` resolves."""
        local = H.download_repo(repo_id, revision=revision, cache_dir=cache_dir, token=token)
        raw, flat = H.load_snapshot(local)
        moshi_sd, mimi_sd = H.split_codec(flat, H.MOSHI_CODEC_PREFIX)
        mimi_cfg = MimiConfig.from_dict(raw.get("audio_encoder_config") or {})
        return cls.from_state_dicts(moshi_sd, mimi_sd, MoshiConfig.from_dict(raw), mimi_cfg,
                                    device=device)

    @property
    def hop_length(self) -> int:
        """Waveform samples per frame."""
        return int(self.engine.mimi.cfg.hop_length)

    def prepare_history(self, text_ids, moshi_codes_tq, user_codes_tq) -> MoshiHistory:
        """The conversation so far on the device: Moshi's text ids [H], its
        codes [H, 8] and the user's [H, 8], H >= 1."""
        return self.engine.prepare_history(text_ids, moshi_codes_tq, user_codes_tq)

    def converse(self, history: MoshiHistory, user_codes_tq, *, max_frames: int, seed: int = 0,
                 text_temperature: float = 0.7, text_top_k: int = 25,
                 audio_temperature: float = 0.8, audio_top_k: int = 250):
        """Moshi's next `max_frames` frames after `history`, the user's codes
        for those frames `user_codes_tq` [max_frames, 8] arriving meanwhile:
        (wav [1, max_frames * hop_length], text ids [max_frames], Moshi's
        codes [max_frames, 8]). The sampling defaults are Kyutai's
        `LMGen`'s."""
        with span("moshi.converse"):
            return self.engine.converse(
                history, user_codes_tq, max_frames=int(max_frames), seed=int(seed),
                text_temperature=float(text_temperature), text_top_k=int(text_top_k),
                audio_temperature=float(audio_temperature), audio_top_k=int(audio_top_k))
