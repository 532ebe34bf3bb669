"""Sopro v1.5 with the Mimi decoder: the family of the configurations whose
"family" is "sopro" (`cudabench/families/__init__.py` lists what a family
module gives).

The program is `sopro_tpu_torch`'s `SoproTTS`, built from the harness's
weights as `from_pretrained` builds it from a checkpoint. The reference
(`cudabench/reference/sopro.py`, `mimi.py`) works a checked session out
again from its inputs: conditioning, every AR step with the sampler and its
random bits, the NAR codes of each frame over the windows the entry's plan
gives (`cudabench/entries/<entry>.py` `plan`: the served chunk grid, or one
window over a synthesize call's frames), frames outside [0, valid) masked,
and one causal Mimi decode of all the codes.

In float32 a sound program diverges from it only at a near-tie, where the
two sides' scores round the other way, or where an AR step's top-k set or
nucleus has an edge within rounding (see `cudabench.reference.sampler`).
The decisions that can reach a frame are the AR steps and NAR heads from two
frames before it to the end of the NAR window that ships it: the NAR's
stages pass a changed code on to earlier frames, one receptive field a
stage.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from cudabench import flops  # noqa: F401  (what the per-layer readers find in rec["flops"])
from cudabench import weights
from cudabench.check import Checked
from cudabench.reference.mimi import MimiDecoder
from cudabench.reference.sopro import Sopro

NAR_BLOCK = 48  # windows per NAR call of the reference
FORCES = {"ar": "ar", "edge": "ar", "nar": "nar"}  # a decision's kind -> what it sets


def specs(cfg: Dict) -> List:
    return [weights.sopro_spec(cfg["sopro"], int(cfg["text_vocab"])),
            weights.mimi_spec(cfg["mimi"])]


def build(cfg: Dict, state_dicts, device, tokenizer):
    from sopro_tpu_torch import hub
    from sopro_tpu_torch import weights as converters
    from sopro_tpu_torch.codec.convert import convert_mimi_state_dict
    from sopro_tpu_torch.codec.mimi_config import MimiConfig
    from sopro_tpu_torch.config import RuntimeConfig, SoproTTSConfig
    from sopro_tpu_torch.engine import Engine
    from sopro_tpu_torch.tts import SoproTTS

    sd_sopro, sd_mimi = state_dicts
    scfg = SoproTTSConfig.from_dict(cfg["sopro"])
    mcfg = MimiConfig.from_dict(cfg["mimi"])
    model = converters.sopro_params_from_jax(hub.sopro_params_from_flat(sd_sopro, scfg), scfg,
                                             device)
    mimi = converters.mimi_params_from_jax(convert_mimi_state_dict(sd_mimi, mcfg), mcfg, device)
    rt = RuntimeConfig(compute_dtype=cfg["compute_dtype"], **cfg.get("runtime", {}))
    return SoproTTS(Engine(model, mimi, rt), scfg, tokenizer, rt)


def voices(traffic, cfg: Dict) -> List[np.ndarray]:
    return traffic.voices(int(cfg["sopro"]["num_codebooks"]), int(cfg["sopro"]["codebook_size"]))


def sample_rate(cfg: Dict) -> int:
    return int(cfg["mimi"]["sampling_rate"])


def checked(records, mix: Dict, voices) -> List[Checked]:
    b = mix.get("batcher", {})
    return [Checked(ids=r.sess.ids, voice=r.sess.voice, ref_tokens=voices[r.sess.voice],
                    seed=r.sess.seed, cap=r.sess.frames, sampling=dict(mix["sampling"]),
                    chunks=list(r.chunk_n), wav=np.concatenate(r.wav),
                    ramp=int(b.get("ramp_frames", 4)),
                    chunk_frames=int(b.get("chunk_frames", 16))) for r in records]


def reference(state_dicts, cfg: Dict, prec, device, entry, mix: Dict) -> "Reference":
    return Reference(*state_dicts, cfg, prec, device, entry.plan, entry.state_frames(mix))


class Reference:
    """The reference model and decoder over the harness's weights (host
    arrays under the published names), on `device`, in `prec`. `plan` is the
    entry's (`plan(s, ctx, state_frames)`); `state_frames` the frames the
    program's plan conditions (its max_frames + 1)."""

    def __init__(self, sopro_sd, mimi_sd, cfg: Dict, prec, device, plan, state_frames: int):
        to = lambda sd: {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in sd.items()}
        self.cfg = cfg
        self.model = Sopro(to(sopro_sd), cfg["sopro"], prec)
        self.mimi = MimiDecoder(to(mimi_sd), cfg["mimi"], prec)
        self.device = device
        self.plan = plan
        self.state_frames = int(state_frames)
        self._ar: Dict[tuple, tuple] = {}
        self.hop = int(round(int(cfg["mimi"]["sampling_rate"]) / float(cfg["mimi"]["frame_rate"])))

    @torch.inference_mode()
    def run(self, sessions: Sequence[Checked], forces: Optional[Sequence[Dict]] = None,
            only: Optional[Sequence[int]] = None) -> List[Dict]:
        """Each session's waveform, and its decisions' gaps and runner-ups,
        as the reference computes them. `forces[i]` sets decisions of
        session i: {"ar": {step: token}, "nar": {(window, position,
        codebook): id}}. `only`: the sessions whose outputs are wanted (all
        by default); the AR decode always takes every session, so each row
        rounds as it did in the first pass."""
        if not sessions:
            return []
        m, dev, sf = self.model, self.device, self.state_frames
        forces = list(forces) if forces is not None else [{} for _ in sessions]
        only = range(len(sessions)) if only is None else only
        refs: Dict[int, Dict] = {}
        conds, kvs = [], []
        for s in sessions:
            if s.voice not in refs:
                refs[s.voice] = m.reference(torch.from_numpy(s.ref_tokens).to(dev))
            c, kv = m.conditioning(torch.from_numpy(s.ids[None]).to(dev), refs[s.voice], sf, 1.0)
            conds.append(c)
            kvs.append(kv)
        ctx = int(m.rf_nar)
        plans = [self.plan(s, ctx, sf) for s in sessions]
        sp = [s.sampling for s in sessions]
        # the AR decode of a session under the same AR decisions is kept:
        # following a NAR near-tie decodes no AR step again
        keys = [(s.ids.tobytes(), s.voice, s.seed, s.cap, tuple(sorted(s.sampling.items())),
                 tuple(p[-1][:2]), frozenset(f.get("ar", {}).items()))
                for s, p, f in zip(sessions, plans, forces)]
        if any(keys[i] not in self._ar for i in only):
            decoded = m.ar_decode(
                conds, kvs, [s.seed for s in sessions],
                [min(sf, max(hi for _, hi, _, _ in p)) for p in plans],
                [x["top_p"] for x in sp], [x["temperature"] for x in sp],
                [0.85 if x["anti_loop"] else x["top_p"] for x in sp],
                [1.2 if x["anti_loop"] else x["temperature"] for x in sp],
                force=[f.get("ar", {}) for f in forces])
            for i, k in enumerate(keys):
                self._ar[k] = tuple(x[i] for x in decoded)
        out = []
        for i in only:
            s, plan = sessions[i], plans[i]
            toks, ar_gap, ar_second, edge_gap, edge_other, first_eos = self._ar[keys[i]]
            limit = min(int(first_eos), s.cap + 1, sf)
            codes, nar = self._codes(conds[i][0], toks, plan, limit, forces[i].get("nar", {}))
            wav = self.mimi.decode(codes[None])[0]
            out.append({"wav": wav.float().cpu().numpy(), "frames": limit, "plan": plan,
                        "ar_gap": ar_gap.cpu().numpy(), "ar_second": ar_second.cpu().numpy(),
                        "edge_gap": edge_gap.cpu().numpy(),
                        "edge_other": edge_other.cpu().numpy(),
                        "nar": nar, "reach": self._reach(plan)})
        return out

    @staticmethod
    def _reach(plan) -> np.ndarray:
        """Per shipped frame, the end of the decisions its codes depend on:
        the end of the NAR window that ships it."""
        return np.array([hi for _, hi, _, n in plan for _ in range(n)])

    def _codes(self, cond, toks, plan, valid: int, force: Dict):
        """The codes of the shipped frames [F, Q], and per window of the
        plan (lo, smallest gap [w], its codebook [w], runner-up [w])."""
        m, dev, sf = self.model, self.device, self.state_frames
        codes = []
        groups: Dict[tuple, List[int]] = {}
        for j, (lo, hi, tail, _) in enumerate(plan):
            groups.setdefault((hi - lo, tail), []).append(j)
        results = {}
        toks = torch.nn.functional.pad(toks[:sf], (0, sf - min(len(toks), sf)))
        pad = lambda x, lo, hi: torch.nn.functional.pad(
            x[max(lo, 0): min(hi, sf)], (0, 0) * (x.dim() - 1) + (max(0, -lo), max(0, hi - sf)))
        for (w, tail), js in groups.items():
            for b0 in range(0, len(js), NAR_BLOCK):
                part = js[b0: b0 + NAR_BLOCK]
                c = torch.stack([pad(cond, plan[j][0], plan[j][1]) for j in part])
                r = torch.stack([pad(toks, plan[j][0], plan[j][1]) for j in part])
                orig = torch.stack([torch.arange(plan[j][0], plan[j][1], device=dev) for j in part])
                mask = (orig >= 0) & (orig < valid)
                fc = None
                if any(j in part for j, _, _ in force):
                    fc = torch.full((len(part), w, m.q), -1, dtype=torch.int64)
                    for (j, p, cb), code in force.items():
                        if j in part:
                            fc[part.index(j), p, cb] = int(code)
                    fc = fc.to(dev)
                cd, (gp, gcb, sec) = m.nar(c, r, mask, tail, fc)
                for k, j in enumerate(part):
                    results[j] = (cd[k], (plan[j][0], gp[k].cpu().numpy(), gcb[k].cpu().numpy(),
                                          sec[k].cpu().numpy()))
        for j, (_, _, _, n) in enumerate(plan):
            codes.append(results[j][0][:n])
        return torch.cat(codes), [results[j][1] for j in range(len(plan))]

    @staticmethod
    def near_ties(ref: Dict, f: int, tie: float, done) -> List[tuple]:
        """The decisions that can reach frame `f` first, with a gap under
        `tie`, smallest gap first: (gap, kind, key, runner-up), kind "ar"
        (key: step), "edge" (key: step; gap: the edge's margin, runner-up:
        the token of the set across it) or "nar" (key: window, position,
        codebook). A decision reaches frame f first when it lies in
        [f - 2, reach(f)): a token sets its own frame's codes, and through
        the NAR's stages those of frames up to a window before it."""
        if not len(ref["reach"]):
            return []
        lo, hi = max(0, f - 2), int(ref["reach"][min(f, len(ref["reach"]) - 1)])
        out = []
        for t in range(lo, min(hi, len(ref["ar_gap"]))):
            if ref["ar_gap"][t] < tie and ("ar", t) not in done:
                out.append((float(ref["ar_gap"][t]), "ar", t, int(ref["ar_second"][t])))
            if ref["edge_gap"][t] < tie and ("edge", t) not in done:
                out.append((float(ref["edge_gap"][t]), "edge", t, int(ref["edge_other"][t])))
        for j, ((_, whi, _, _), (wlo, gap, cb, second)) in enumerate(zip(ref["plan"], ref["nar"])):
            if whi <= lo:
                continue  # a window that ships only frames before f
            for p in range(max(0, lo - wlo), min(len(gap), hi - wlo)):
                key = (j, p, int(cb[p]))
                if gap[p] < tie and ("nar", key) not in done:
                    out.append((float(gap[p]), "nar", key, int(second[p])))
        return sorted(out, key=lambda c: c[0])

    @staticmethod
    def force(forces: Dict, kind: str, key, code: int) -> Dict:
        """`forces` with decision (kind, key) set to `code`: an edge is set
        through its AR step's token."""
        out = {k: dict(v) for k, v in forces.items()}
        out.setdefault(FORCES[kind], {})[key] = code
        return out
