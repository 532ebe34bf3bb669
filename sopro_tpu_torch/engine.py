"""Execution engine (counterpart: sopro_tpu/engine.py): padding to the JAX
package's buckets, and the fused synthesize plan -- conditioning, AR decode
(kernel K1 on CUDA), NAR refine over every frame (kernel K2) and the Mimi
decode (kernel K3) -- with one device->host copy at the end.

Text, reference and frame padding follow the JAX package exactly
(`pick_bucket`, `_pad_axis`, NAR and vocoder over all max_frames+1 frames
with a validity mask), so both packages compute on the same shapes.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from sopro_tpu_torch.codec.mimi import MimiDecoder
from sopro_tpu_torch.config import RuntimeConfig, SoproTTSConfig, pick_bucket
from sopro_tpu_torch.models import sopro as M


def _pad_axis(x: np.ndarray, axis: int, to: int) -> np.ndarray:
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, to - x.shape[axis])
    return np.pad(x, pad)


def configure_cuda_numerics() -> None:
    """Full float32 on the card: TF32 in matmuls or cuDNN convs would break
    the port's fp32 tolerances."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Engine:
    def __init__(
        self,
        model: M.SoproModel,
        mimi: MimiDecoder,
        runtime: Optional[RuntimeConfig] = None,
    ):
        self.model = model
        self.cfg: SoproTTSConfig = model.cfg
        self.mimi = mimi
        self.mimi_cfg = mimi.cfg
        self.rt = runtime or RuntimeConfig()
        self.device = model.device()
        if self.device.type == "cuda":
            configure_cuda_numerics()

    def _padded(self, row: np.ndarray, buckets) -> Tuple[torch.Tensor, torch.Tensor]:
        """[T, ...] ints -> ([1, Tb, ...] int32, mask [1, Tb]) on the device."""
        t = int(row.shape[0])
        tb = pick_bucket(t, buckets)
        ids = _pad_axis(np.asarray(row, np.int32), 0, tb)[None]
        mask = np.zeros((1, tb), bool)
        mask[:, :t] = True
        return (torch.from_numpy(ids).to(self.device),
                torch.from_numpy(mask).to(self.device))

    @torch.inference_mode()
    def prepare_reference(self, ref_tokens_tq: np.ndarray) -> M.PreparedReference:
        """[T, Q] tokens -> PreparedReference (padded to a ref bucket; the
        masks keep the numerics exact)."""
        toks, mask = self._padded(ref_tokens_tq, self.rt.ref_buckets)
        return M.prepare_reference(self.model, toks, mask=mask)

    @torch.inference_mode()
    def prepare_conditioning(
        self, text_ids: np.ndarray, ref: M.PreparedReference, *,
        max_frames: int, style_strength: float,
    ) -> Dict[str, torch.Tensor]:
        ids, mask = self._padded(text_ids, self.rt.text_buckets)
        return M.prepare_conditioning(
            self.model, ids, mask, ref, max_frames=max_frames, style_strength=style_strength
        )

    def fused_synth_graph(
        self, ids: torch.Tensor, mask: torch.Tensor, ref: M.PreparedReference,
        strength: float, seed: int, settings: M.ARSettings, *, max_frames: int,
    ):
        """Conditioning + AR decode + NAR over all max_frames+1 frames +
        Mimi decode, on the device. Returns (wav [1, s*hop], t [1], tokens
        [1, s, Q])."""
        s = int(max_frames) + 1
        prep = M.prepare_conditioning(
            self.model, ids, mask, ref, max_frames=max_frames, style_strength=strength
        )
        carry = M.ar_generate(
            self.model, prep["cond_ar"], prep["txt_seq"], mask, seed, settings, s
        )
        t = torch.minimum(carry.first_eos, carry.t)  # [1]
        frame_mask = torch.arange(s, device=t.device)[None, :] < t[:, None]
        toks = M.nar_refine(self.model, prep["cond_ar"], carry.tokens, mask=frame_mask)
        return self.mimi(toks), t, toks

    @torch.inference_mode()
    def synthesize_fused(
        self,
        ids_row: np.ndarray,
        ref: M.PreparedReference,
        *,
        max_frames: int,
        style_strength: float,
        seed: int,
        top_p: float,
        temperature: float,
        anti_loop: bool,
        min_gen: int,
        return_tokens: bool = False,
    ):
        """Whole pipeline with one device->host copy.
        Returns (wav [1, t*hop] float32, t), plus tokens [t, Q] when asked."""
        ids, mask = self._padded(ids_row, self.rt.text_buckets)
        settings = M.ARSettings(
            top_p=top_p, temperature=temperature, min_gen_frames=int(min_gen),
            anti_loop=bool(anti_loop),
        )
        wav, t, toks = self.fused_synth_graph(
            ids, mask, ref, float(style_strength), int(seed), settings, max_frames=max_frames
        )
        t = int(t.cpu()[0])
        wav = wav.cpu().numpy()[:, : t * int(self.mimi_cfg.hop_length)]
        if return_tokens:
            return wav, t, toks[0, :t].cpu().numpy()
        return wav, t
