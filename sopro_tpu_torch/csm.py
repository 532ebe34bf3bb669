"""`CsmTTS`: CSM-1B (Sesame's Conversational Speech Model) on the port,
decoding to 24 kHz audio through the Mimi codec the Sopro path uses.

    tts = CsmTTS.from_pretrained("sesame/csm-1b")   # or a local snapshot
    ref = tts.prepare_reference(ref_tokens_tq=codes, transcript="what the voice says")
    wav = tts.synthesize("Hello there.", ref=ref, max_frames=250, seed=7)

A snapshot is transformers' `CsmForConditionalGeneration` format: config.json
(the codec's config under `codec_config`), model.safetensors or its shards
(the Mimi codec under `codec_model.*`), and the tokenizer's files. Text is
tokenized as Sesame's generator does it, "[speaker]text" between the
tokenizer's BOS and EOS. Waveforms are numpy float32 [1, S] on the host.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from sopro_tpu_torch import hub as H
from sopro_tpu_torch import weights as W
from sopro_tpu_torch.codec.convert import convert_mimi_state_dict
from sopro_tpu_torch.codec.mimi_config import MimiConfig
from sopro_tpu_torch.csm_engine import CsmEngine, CsmReference
from sopro_tpu_torch.models.csm import CsmConfig, CsmModel
from sopro_tpu_torch.profiling import span
from sopro_tpu_torch.tts import _resolve_device

# Sesame's `generator.py`: 90 s at 12.5 frames a second
MAX_FRAMES = 1125


class CsmTTS:
    def __init__(self, engine: CsmEngine, tokenizer):
        self.engine = engine
        self.cfg: CsmConfig = engine.cfg
        self.tokenizer = tokenizer

    @classmethod
    def from_state_dicts(cls, csm_sd: Dict[str, np.ndarray], mimi_sd: Dict[str, np.ndarray],
                         cfg: CsmConfig, mimi_cfg: MimiConfig, *, device="cuda",
                         tokenizer=None) -> "CsmTTS":
        """From transformers-named state dicts: CSM's (`hub.csm_params_from_flat`)
        and the Mimi codec's (MimiModel names)."""
        dev = _resolve_device(device)
        model = CsmModel(W.to_torch(H.csm_params_from_flat(csm_sd, cfg), dev), cfg)
        mimi = W.mimi_params_from_jax(convert_mimi_state_dict(mimi_sd, mimi_cfg), mimi_cfg, dev)
        return cls(CsmEngine(model, mimi), tokenizer)

    @classmethod
    def from_pretrained(cls, repo_id: str, *, revision: Optional[str] = None,
                        cache_dir: Optional[str] = None, token: Optional[str] = None,
                        device="cuda", tokenizer=None) -> "CsmTTS":
        """A snapshot (module docstring): a local directory or a hub repo id
        that `hub.download_repo` resolves. The tokenizer is the snapshot's
        unless `tokenizer` is given."""
        from sopro_tpu_torch.tokenizer import TextTokenizer

        local = H.download_repo(repo_id, revision=revision, cache_dir=cache_dir, token=token)
        raw, flat = H.load_snapshot(local)
        csm_sd, mimi_sd = H.split_codec(flat, H.CSM_CODEC_PREFIX)
        mimi_cfg = MimiConfig.from_dict(raw.get("codec_config") or {})
        tokenizer = tokenizer if tokenizer is not None else TextTokenizer(model_name=local)
        return cls.from_state_dicts(csm_sd, mimi_sd, CsmConfig.from_dict(raw), mimi_cfg,
                                    device=device, tokenizer=tokenizer)

    @property
    def hop_length(self) -> int:
        """Waveform samples per frame."""
        return int(self.engine.mimi.cfg.hop_length)

    def text_ids(self, text: str, speaker: int = 0):
        """A segment's text ids: "[speaker]text", as the tokenizer frames it."""
        return self.tokenizer.encode(f"[{int(speaker)}]{text}")

    def prepare_reference(self, *, ref_tokens_tq: np.ndarray, transcript: Optional[str] = None,
                          transcript_ids: Optional[Sequence[int]] = None,
                          speaker: int = 0) -> CsmReference:
        """The context segment of a voice: its transcript (text, or the ids
        `text_ids` gives for it), its Mimi codes [frames, 32] and an all-zero
        end frame, on the device."""
        if (transcript is None) == (transcript_ids is None):
            raise ValueError("give the reference's transcript or its transcript_ids")
        ids = self.text_ids(transcript, speaker) if transcript_ids is None else transcript_ids
        return self.engine.prepare_reference(ids, ref_tokens_tq)

    def synthesize(self, text: str, *, ref: Optional[CsmReference] = None,
                   max_frames: int = MAX_FRAMES, top_k: int = 50, temperature: float = 0.9,
                   seed: int = 0, speaker: int = 0) -> np.ndarray:
        """Speech for `text` in `speaker`'s voice after the reference segment:
        wav [1, frames * hop_length], at most `max_frames` frames."""
        with span("csm.synthesize"):
            wav, _ = self.engine.synthesize(self.text_ids(text, speaker), ref,
                                            max_frames=int(max_frames), seed=int(seed),
                                            temperature=float(temperature), top_k=int(top_k))
            return wav
