"""A toy architecture for the harness's own tests, written as a second
family would be: text ids and a voice of Mimi codes in, a few greedy AR
steps that each give one frame of codes, and the Mimi decode
(`cudabench.reference.mimi`). Its program is its reference, in plain
PyTorch, with the token at `PLANT` (frame, codebook) altered where the
program makes it: a planted fault."""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from cudabench import weights
from cudabench.check import Checked
from cudabench.reference.mimi import MimiDecoder
from cudabench.reference.precision import Precision

flops = None  # no per-layer reader reads a toy cell
PLANT = None


def _sizes(cfg: Dict):
    return (int(cfg["toy"]["d_model"]), int(cfg["mimi"]["num_quantizers"]),
            int(cfg["mimi"]["codebook_size"]))


def specs(cfg: Dict) -> List:
    d, q, v = _sizes(cfg)
    s = 1.0 / math.sqrt(d)
    return [[("text", (int(cfg["text_vocab"]), d), "n", 1.0), ("codes", (q * v, d), "n", s),
             ("step", (d, d), "u", s), ("head", (q * v, d), "u", 1.0)],
            weights.mimi_spec(cfg["mimi"])]


class Toy:
    """The model over the harness's two state dicts, on `device`."""

    def __init__(self, state_dicts, cfg: Dict, prec, device):
        to = lambda sd: {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in sd.items()}
        self.sd = to(state_dicts[0])
        self.d, self.q, self.v = _sizes(cfg)
        self.mimi = MimiDecoder(to(state_dicts[1]), cfg["mimi"], prec)
        self.hop = int(round(int(cfg["mimi"]["sampling_rate"]) / float(cfg["mimi"]["frame_rate"])))
        self.device = device

    @torch.inference_mode()
    def decode(self, ids, voice, frames: int, force: Optional[Dict] = None):
        """Greedy codes [frames, q], each decision's gap to its runner-up,
        and the runner-up; `force` ({(frame, codebook): code}) sets
        decisions."""
        sd, q, v, dev = self.sd, self.q, self.v, self.device
        offs = torch.arange(q, device=dev) * v
        h = sd["text"][torch.as_tensor(np.asarray(ids), device=dev).long()].mean(0)
        h = h + sd["codes"][torch.as_tensor(voice, device=dev).long() + offs].sum(1).mean(0)
        codes, gaps, second = [], [], []
        for t in range(frames):
            h = torch.tanh(sd["step"] @ h)
            top = (sd["head"] @ h).view(q, v).topk(2, -1)
            code = top.indices[:, 0].clone()
            for (step, cb), c in (force or {}).items():
                if step == t:
                    code[cb] = c
            codes.append(code)
            gaps.append(top.values[:, 0] - top.values[:, 1])
            second.append(top.indices[:, 1])
            h = h + sd["codes"][code + offs].sum(0)
        return torch.stack(codes), torch.stack(gaps), torch.stack(second)

    @torch.inference_mode()
    def wav(self, codes: torch.Tensor) -> np.ndarray:
        return self.mimi.decode(codes[None])[0].float().cpu().numpy()


class Program:
    """The program under test, as a caller sees it."""

    def __init__(self, model: Toy, tokenizer):
        self.model, self.tokenizer, self.hop = model, tokenizer, model.hop

    def generate(self, text: str, voice: np.ndarray, frames: int) -> np.ndarray:
        codes, _, _ = self.model.decode(self.tokenizer.encode(text), voice, frames)
        if PLANT is not None:
            codes = codes.clone()
            codes[PLANT] = (codes[PLANT] + 1) % self.model.v
        return self.model.wav(codes)


def build(cfg: Dict, state_dicts, device, tokenizer) -> Program:
    return Program(Toy(state_dicts, cfg, Precision(), device), tokenizer)


def voices(traffic, cfg: Dict) -> List[np.ndarray]:
    _, q, v = _sizes(cfg)
    return traffic.voices(q, v)


def sample_rate(cfg: Dict) -> int:
    return int(cfg["mimi"]["sampling_rate"])


def checked(records, mix: Dict, voices) -> List[Checked]:
    return [Checked(ids=r.sess.ids, voice=r.sess.voice, ref_tokens=voices[r.sess.voice],
                    seed=r.sess.seed, cap=r.sess.frames, sampling=dict(mix["sampling"]),
                    chunks=list(r.chunk_n), wav=np.concatenate(r.wav)) for r in records]


def reference(state_dicts, cfg: Dict, prec, device, entry, mix: Dict) -> "Reference":
    return Reference(Toy(state_dicts, cfg, prec, device))


class Reference:
    def __init__(self, model: Toy):
        self.model, self.hop = model, model.hop

    def run(self, sessions: Sequence[Checked], forces: Optional[Sequence[Dict]] = None,
            only: Optional[Sequence[int]] = None) -> List[Dict]:
        forces = list(forces) if forces is not None else [{} for _ in sessions]
        out = []
        for i in range(len(sessions)) if only is None else only:
            s = sessions[i]
            codes, gap, second = self.model.decode(s.ids, s.ref_tokens, s.cap, forces[i])
            out.append({"wav": self.model.wav(codes), "frames": s.cap,
                        "gap": gap.cpu().numpy(), "second": second.cpu().numpy()})
        return out

    @staticmethod
    def near_ties(out: Dict, f: int, tie: float, done) -> List[tuple]:
        """The decisions of frames f - 1 and f (the decoder is causal: a
        code reaches its own frame's samples and later ones)."""
        ties = [(float(out["gap"][t, cb]), "ar", (t, cb), int(out["second"][t, cb]))
                for t in range(max(0, f - 1), min(f + 1, len(out["gap"])))
                for cb in range(out["gap"].shape[1])]
        return sorted(c for c in ties if c[0] < tie and (c[1], c[2]) not in done)

    @staticmethod
    def force(forces: Dict, kind: str, key, code: int) -> Dict:
        return {**forces, key: code}
