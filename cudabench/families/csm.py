"""CSM-1B (Sesame's Conversational Speech Model) with the Mimi decoder: the
family of the configurations whose "family" is "csm"
(`cudabench/families/__init__.py` lists what a family module gives).

The program is `sopro_tpu_torch`'s `CsmTTS`, built from the harness's
weights under transformers' `CsmForConditionalGeneration` names through
`hub.csm_params_from_flat`, and the codec through the Mimi converter. The
tokenizer files are not in the repository: the harness's text ids stand for
the Llama-3 tokenizer's, framed as Sesame's tokenizer frames a segment
(`segment_ids`: BOS, "[speaker]", the ids, EOS).

The reference (`cudabench/reference/csm.py`, `mimi.py`) works a checked
call out again from its inputs: the prompt (the voice's transcript, its
frames and the end frame, then the text), every frame's backbone and depth
decoder over their whole inputs with no cache, each decision keyed as the
program keys it, and one Mimi decode of the codes. A changed code changes
its own frame's audio and, through the backbone, every later frame's: the
decisions that can reach frame f are the 32 of each of frames f - 2..f.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from cudabench import flops_csm as flops  # noqa: F401  (what the per-layer readers find in rec["flops"])
from cudabench import weights
from cudabench.check import Checked
from cudabench.reference import csm as R
from cudabench.reference.mimi import MimiDecoder
from sopro_tpu_torch.codec.mimi_config import MimiConfig
from sopro_tpu_torch.csm import CsmTTS  # a program without CSM fails here, before any weight
from sopro_tpu_torch.models.csm import CsmConfig

REACH = 2  # frames before a divergence whose decisions can reach it


def _tag(speaker: int) -> List[int]:
    """"[speaker]" in the Llama 3 vocabulary: each printable ASCII character
    is its own token, id ord(c) - 33."""
    return [ord(c) - 33 for c in f"[{int(speaker)}]"]


def segment_ids(ids: Sequence[int], cfg: Dict, speaker: int = 0) -> np.ndarray:
    """A segment's text ids as Sesame's tokenizer gives them for
    "[speaker]text": BOS, the tag, the text's ids, EOS (the configuration's
    `tokenizer` ids: Llama 3's <|begin_of_text|> and <|end_of_text|>)."""
    t = cfg["tokenizer"]
    return np.asarray([int(t["bos"])] + _tag(speaker) + [int(x) for x in ids] + [int(t["eos"])],
                      np.int64)


class SegmentTokenizer:
    """The harness's seeded tokenizer, framing "[speaker]key" as
    `segment_ids` does."""

    def __init__(self, seeded, cfg: Dict):
        self.seeded, self.cfg = seeded, cfg

    def add(self, ids: np.ndarray) -> str:
        return self.seeded.add(ids)

    def encode(self, text: str) -> List[int]:
        m = re.fullmatch(r"\[(\d+)\](.*)", text, re.S)
        speaker, key = (int(m.group(1)), m.group(2)) if m else (0, text)
        return [int(x) for x in segment_ids(self.seeded.encode(key), self.cfg, speaker)]


@dataclass
class Voice:
    codes: np.ndarray  # [frames, Q] Mimi codes
    transcript_ids: np.ndarray  # its transcript, framed by `segment_ids`


@dataclass
class CsmChecked(Checked):
    """`ids` as the traffic drew them (the reference frames them);
    `transcript_ids` the voice's, framed."""

    transcript_ids: Optional[np.ndarray] = None


def _linear(spec, name: str, d_in: int, d_out: int, std: float):
    spec.append((f"{name}.weight", (d_out, d_in), "n", std))


def _transformer(spec, prefix: str, c: Dict, std: float):
    d, f = int(c["hidden_size"]), int(c["intermediate_size"])
    h, kvh = int(c["num_attention_heads"]), int(c["num_key_value_heads"])
    hd = int(c.get("head_dim") or d // h)
    for i in range(int(c["num_hidden_layers"])):
        p = f"{prefix}.layers.{i}"
        for ln in ("input_layernorm", "post_attention_layernorm"):
            spec.append((f"{p}.{ln}.weight", (d,), "c", 1.0))
        _linear(spec, f"{p}.self_attn.q_proj", d, h * hd, std)
        _linear(spec, f"{p}.self_attn.k_proj", d, kvh * hd, std)
        _linear(spec, f"{p}.self_attn.v_proj", d, kvh * hd, std)
        _linear(spec, f"{p}.self_attn.o_proj", h * hd, d, std)
        _linear(spec, f"{p}.mlp.gate_proj", d, f, std)
        _linear(spec, f"{p}.mlp.up_proj", d, f, std)
        _linear(spec, f"{p}.mlp.down_proj", f, d, std)
    spec.append((f"{prefix}.norm.weight", (d,), "c", 1.0))


def csm_spec(c: Dict) -> weights.Spec:
    """CsmForConditionalGeneration's tensors (the codec's aside; the depth
    decoder's embedding tied to the backbone's audio table) at
    `initializer_range`, norms 1."""
    std = float(c["initializer_range"])
    d, q, v = int(c["hidden_size"]), int(c["num_codebooks"]), int(c["vocab_size"])
    dc = c["depth_decoder_config"]
    spec: weights.Spec = [("embed_text_tokens.weight", (int(c["text_vocab_size"]), d), "n", std),
                          ("backbone_model.embed_tokens.embed_audio_tokens.weight", (q * v, d), "n", std)]
    _transformer(spec, "backbone_model", c, std)
    _linear(spec, "lm_head", d, v, std)
    _transformer(spec, "depth_decoder.model", dc, std)
    _linear(spec, "depth_decoder.model.inputs_embeds_projector", d, int(dc["hidden_size"]), std)
    spec.append(("depth_decoder.codebooks_head.weight", (q - 1, int(dc["hidden_size"]), v), "n", std))
    return spec


def specs(cfg: Dict) -> List:
    return [csm_spec(cfg["csm"]), weights.mimi_spec(cfg["mimi"])]


def _zero_unused(sd: Dict[str, np.ndarray], cfg: Dict) -> None:
    """The head rows of ids past the Mimi codebook's, zero (their logit is
    then 0 and stays out of the top k under random weights)."""
    n = int(cfg["mimi"]["codebook_size"])
    sd["lm_head.weight"][n:] = 0.0
    sd["depth_decoder.codebooks_head.weight"][:, :, n:] = 0.0


def build(cfg: Dict, state_dicts, device, tokenizer):
    sd_csm, sd_mimi = state_dicts
    _zero_unused(sd_csm, cfg)
    return CsmTTS.from_state_dicts(sd_csm, sd_mimi, CsmConfig.from_dict(cfg["csm"]),
                                   MimiConfig.from_dict(cfg["mimi"]), device=device,
                                   tokenizer=SegmentTokenizer(tokenizer, cfg))


def voices(traffic, cfg: Dict) -> List[Voice]:
    """The traffic's voices, each with a transcript of `refs["transcript"]`
    ids drawn after them."""
    c = cfg["csm"]
    codes = traffic.voices(int(c["num_codebooks"]), int(cfg["mimi"]["codebook_size"]))
    n = int(traffic.mix["refs"]["transcript"])
    return [Voice(x, segment_ids(traffic.rng.integers(0, int(cfg["text_vocab"]), size=n), cfg))
            for x in codes]


def sample_rate(cfg: Dict) -> int:
    return int(cfg["mimi"]["sampling_rate"])


def checked(records, mix: Dict, voices) -> List[CsmChecked]:
    return [CsmChecked(ids=r.sess.ids, voice=r.sess.voice,
                       ref_tokens=voices[r.sess.voice].codes, seed=r.sess.seed, cap=r.sess.frames,
                       sampling=dict(mix["sampling"]), chunks=list(r.chunk_n),
                       wav=np.concatenate(r.wav),
                       transcript_ids=voices[r.sess.voice].transcript_ids) for r in records]


def reference(state_dicts, cfg: Dict, prec, device, entry, mix: Dict) -> "Reference":
    return Reference(*state_dicts, cfg, prec, device)


class Reference:
    """The reference model and decoder over the harness's weights, on
    `device`, in `prec`. Each session's frames are kept with the decisions
    that set them, so a run that sets one more decision works the session
    out again from that decision's frame."""

    def __init__(self, csm_sd, mimi_sd, cfg: Dict, prec, device):
        _zero_unused(csm_sd, cfg)
        to = lambda sd: {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in sd.items()}
        self.cfg = cfg
        self.model = R.Csm(to(csm_sd), cfg["csm"], prec)
        self.mimi = MimiDecoder(to(mimi_sd), cfg["mimi"], prec)
        self.device = device
        self.hop = int(round(int(cfg["mimi"]["sampling_rate"]) / float(cfg["mimi"]["frame_rate"])))
        self._runs: Dict[tuple, tuple] = {}

    def _prompt(self, s: CsmChecked):
        q = self.model.q
        rows = []
        for ids in (s.transcript_ids, None, segment_ids(s.ids, self.cfg)):
            if ids is None:  # the voice's frames and the end frame
                t = np.zeros((len(s.ref_tokens) + 1, q + 1), np.int64)
                t[:-1, :q], t[-1, :q] = s.ref_tokens, self.model.eos
                m = np.zeros(t.shape, bool)
                m[:, :q] = True
            else:
                t = np.zeros((len(ids), q + 1), np.int64)
                m = np.zeros(t.shape, bool)
                t[:, q], m[:, q] = ids, True
            rows.append((t, m))
        return [torch.from_numpy(np.concatenate(x)).to(self.device) for x in zip(*rows)]

    @torch.inference_mode()
    def run(self, sessions: Sequence[CsmChecked], forces: Optional[Sequence[Dict]] = None,
            only: Optional[Sequence[int]] = None) -> List[Dict]:
        """Each session's waveform, frames, and per decision [frame, codebook]
        its gap, runner-up, edge margin and the token across the edge.
        `forces[i]`: {"code": {(frame, codebook): code}}. The sessions asked
        for are decoded together, frame by frame, each from the first frame
        its decisions differ from its last run's."""
        forces = list(forces) if forces is not None else [{} for _ in sessions]
        only = range(len(sessions)) if only is None else only
        jobs = []
        for i in only:
            s, force = sessions[i], dict(forces[i].get("code", {}))
            key = (s.ids.tobytes(), s.voice, s.seed, s.cap, tuple(sorted(s.sampling.items())))
            base_force, base = self._runs.get(key, ({}, []))
            differ = [k[0] for k, _ in set(force.items()) ^ set(base_force.items())]
            jobs.append({"s": s, "force": force, "key": key,
                         "frames": base[: min(differ, default=len(base))]})
        for sp in {tuple(sorted(j["s"].sampling.items())) for j in jobs}:
            self._decode([j for j in jobs if tuple(sorted(j["s"].sampling.items())) == sp], dict(sp))
        out = []
        for j in jobs:
            self._runs[j["key"]] = (j["force"], j["frames"])
            out.append(self._result(j["frames"]))
        return out

    def _decode(self, jobs: List[Dict], sp: Dict) -> None:
        m, q, dev = self.model, self.model.q, self.device
        row = torch.zeros(1, q + 1, dtype=torch.bool, device=dev)
        row[0, :q] = True
        frame_embed = lambda codes: m.embed(torch.cat([codes, codes[:1] * 0])[None], row)
        for j in jobs:
            j["x"] = torch.cat([m.embed(*self._prompt(j["s"]))]
                               + [frame_embed(r["codes"]) for r in j["frames"]])
            j["ended"] = bool(j["frames"]) and bool((j["frames"][-1]["codes"] == m.eos).all())
        for f in range(min(len(j["frames"]) for j in jobs), max(j["s"].cap for j in jobs)):
            act = [j for j in jobs if not j["ended"] and len(j["frames"]) == f and f < j["s"].cap]
            if not act:
                continue
            lengths = [j["x"].shape[0] for j in act]
            x = torch.nn.utils.rnn.pad_sequence([j["x"] for j in act], batch_first=True)
            h, logits = m.codebook0(x, lengths)
            noise = R.frame_noise([j["s"].seed for j in act], f, q, m.v, dev)
            inputs, out = [h], []
            for i in range(q):
                if i:
                    logits = m.codebook(i, torch.stack(inputs, 1))
                d = R.sample(logits, noise[:, i], float(sp["temperature"]), int(sp["top_k"]))
                forced = [(b, j["force"][f, i]) for b, j in enumerate(act) if (f, i) in j["force"]]
                tok = d[0].clone()
                for b, code in forced:
                    tok[b] = int(code)
                out.append((tok,) + d[1:])
                inputs.append(m.code_embed(i, tok))
            recs = {k: torch.stack([o[n] for o in out], 1) for n, k in
                    enumerate(("codes", "gap", "second", "edge", "other"))}
            ended = (recs["codes"] == m.eos).all(1).tolist()
            for b, j in enumerate(act):
                j["frames"].append({k: v[b] for k, v in recs.items()})
                j["ended"] = ended[b]
                j["x"] = torch.cat([j["x"], frame_embed(recs["codes"][b])])

    def _result(self, frames: List[Dict]) -> Dict:
        m, q = self.model, self.model.q
        n = len(frames) - 1 if frames and bool((frames[-1]["codes"] == m.eos).all()) else len(frames)
        codes = torch.stack([r["codes"] for r in frames[:n]]) if n else torch.zeros(
            (0, q), dtype=torch.int64, device=self.device)
        wav = self.mimi.decode(codes[None])[0] if n else torch.zeros(0)
        host = lambda k: (torch.stack([r[k] for r in frames]).cpu().numpy() if frames
                          else np.zeros((0, q)))
        return {"wav": wav.float().cpu().numpy(), "frames": n, "gap": host("gap"),
                "second": host("second"), "edge": host("edge"), "other": host("other")}

    @staticmethod
    def near_ties(ref: Dict, f: int, tie: float, done) -> List[tuple]:
        """The decisions of frames f - 2..f with a gap under `tie`, smallest
        first: (gap, kind, (frame, codebook), runner-up), kind "code" (the
        score gap) or "edge" (the top-k edge's margin, and the token across
        it)."""
        out = []
        for g in range(max(0, f - REACH), min(f + 1, len(ref["gap"]))):
            for i in range(ref["gap"].shape[1]):
                for kind, gap, alt in (("code", ref["gap"], ref["second"]),
                                       ("edge", ref["edge"], ref["other"])):
                    if math.isfinite(gap[g, i]) and gap[g, i] < tie and (kind, (g, i)) not in done:
                        out.append((float(gap[g, i]), kind, (g, i), int(alt[g, i])))
        return sorted(out, key=lambda c: c[0])

    @staticmethod
    def force(forces: Dict, kind: str, key, code: int) -> Dict:
        """`forces` with decision `key` set to `code` (an edge sets its
        decision's code)."""
        out = {k: dict(v) for k, v in forces.items()}
        out.setdefault("code", {})[key] = code
        return out
