"""The comparison that decides `correct`.

A checked session is one the program finished in the window: its text ids,
voice, seed, sampling settings and cap (all made by the harness), and what
the client received (the chunks of a served session, the waveform of a
synthesize call). The reference (`cudabench.reference`, plain PyTorch in the
configuration's precision) works the session out again from those inputs
and the harness's weights: conditioning, every AR step with the sampler and
its random bits, the NAR codes of each frame over the windows the entry's
plan gives (`cudabench/entries/<entry>.py` `plan`: the served chunk grid,
or one window over a synthesize call's frames), frames outside [0, valid)
masked, and one causal Mimi decode of all the codes.

Per frame (1,920 samples) the error is the RMS of the difference over the
session's RMS. The first frame whose error passes `tau` is where the two
diverge: a sampled or argmax token differs there. In float32 a sound
program does that only at a near-tie, where the two sides' scores round the
other way, or where an AR step's top-k set or nucleus has an edge within
rounding (see `cudabench.reference.sampler`). The check then follows that
decision the other way: it takes the `tries` decisions with the smallest
gaps (each under `tie`: a score gap, or an edge's margin) among the AR steps
and NAR heads that can reach that frame (from two frames before it to the end of
the NAR window that ships it: the NAR's stages pass a changed code on to
earlier frames, one receptive field a stage), sets one at a time to the
reference's runner-up (or the token of the set across the edge), and works the session
out again, with every checked session in the AR decode as in the first
pass, so that nothing but that decision changes. If one of them moves the divergence past that frame,
it stays set and the comparison goes on; if none does, the divergence is
unexplained: a token the reference would not give at any near-tie. Two
numbers, each against its limit:

- `wave_err`: the largest frame error over the compared frames (every
  frame, once the divergences are followed);
- `unexplained`: the checked sessions with a divergence no near-tie
  explains.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from cudabench.reference.mimi import MimiDecoder
from cudabench.reference.sopro import Precision, Sopro

NAR_BLOCK = 48  # windows per NAR call of the reference
MAX_FLIPS = 4  # near-ties followed in one session
FORCES = {"ar": "ar", "edge": "ar", "nar": "nar"}  # a decision's kind -> what it sets


@dataclass
class Checked:
    """One finished session as the client saw it. `chunks`: frames per
    chunk received (one entry: a synthesize call); `wav`: the samples
    received, concatenated."""

    ids: np.ndarray
    voice: int
    ref_tokens: np.ndarray
    seed: int
    cap: int  # a served session's max_frames; a synthesize call's max_frames
    top_p: float
    temperature: float
    anti_loop: bool
    chunks: List[int]
    wav: np.ndarray
    ramp: int = 4
    chunk_frames: int = 16


@dataclass
class Outcome:
    wave_err: float
    unexplained: int
    sessions: List[Dict] = field(default_factory=list)


class Reference:
    """The reference model and decoder over the harness's weights (host
    arrays under the published names), on `device`, in `prec`. `plan` is the
    entry's (`plan(s, ctx, state_frames)`); `state_frames` the frames the
    program's plan conditions (its max_frames + 1)."""

    def __init__(self, sopro_sd, mimi_sd, cfg: Dict, prec: Precision, device, plan,
                 state_frames: int):
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
        # the AR decode of a session under the same AR decisions is kept:
        # following a NAR near-tie decodes no AR step again
        keys = [(s.ids.tobytes(), s.voice, s.seed, s.cap, s.top_p, s.temperature, s.anti_loop,
                 tuple(p[-1][:2]), frozenset(f.get("ar", {}).items()))
                for s, p, f in zip(sessions, plans, forces)]
        if any(keys[i] not in self._ar for i in only):
            decoded = m.ar_decode(
                conds, kvs, [s.seed for s in sessions],
                [min(sf, max(hi for _, hi, _, _ in p)) for p in plans],
                [s.top_p for s in sessions], [s.temperature for s in sessions],
                [0.85 if s.anti_loop else s.top_p for s in sessions],
                [1.2 if s.anti_loop else s.temperature for s in sessions],
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


def compare(served: np.ndarray, ref: Dict, hop: int, tau: float, frames_served: int) -> Dict:
    """One session: served samples against the reference's."""
    f_ref = int(ref["frames"])
    n = min(frames_served, f_ref)
    wr = ref["wav"][: n * hop].astype(np.float64)
    ws = np.asarray(served, np.float64)[: n * hop]
    scale = max(float(np.sqrt(np.mean(wr * wr))) if n else 0.0, 1e-12)
    err = np.sqrt(np.mean((ws - wr).reshape(n, hop) ** 2, axis=1)) / scale if n else np.zeros(0)
    bad = np.nonzero(err > tau)[0]
    div = int(bad[0]) if len(bad) else n
    diverged = len(bad) > 0 or frames_served != f_ref
    return {"frames": f_ref, "compared": div, "wave_err": float(err[:div].max()) if div else 0.0,
            "diverged_at": div if diverged else None, "err": err}


def near_ties(ref: Dict, f: int, tie: float, done) -> List[tuple]:
    """The decisions that can reach frame `f` first, with a gap under `tie`,
    smallest gap first: (gap, kind, key, runner-up), kind "ar" (key: step),
    "edge" (key: step; gap: the edge's margin, runner-up: the token of the
    set across it) or "nar" (key: window, position, codebook). A decision reaches
    frame f first when it lies in [f - 2, reach(f)): a token sets its own
    frame's codes, and through the NAR's stages those of frames up to a
    window before it."""
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


def follow(reference: Reference, served: Sequence[Checked], i: int, ref: Dict,
           forces: List[Dict], tau: float, tie: float, tries: int) -> Dict:
    """Compare session i, following each divergence through a near-tie as
    the module's docstring says; `forces` holds every session's decisions
    set so far, and takes session i's. -> compare's dict with `flips` (the
    gaps of the decisions followed), `trail` (per divergence: its frame and
    each decision tried, [gap, kind, where the divergence went]) and
    `explained` (False: a divergence that no near-tie moved)."""
    s = served[i]
    hop, n = reference.hop, int(sum(s.chunks))
    cur = compare(s.wav, ref, hop, tau, n)
    done, flips, trail = set(), [], []
    while cur["diverged_at"] is not None and len(flips) < MAX_FLIPS and tries > 0:
        f = cur["diverged_at"]
        trail.append([f, []])
        if f >= min(n, int(ref["frames"])):
            break  # the lengths differ where the samples agree
        moved = False
        for gap, kind, key, code in near_ties(ref, f, tie, done)[:tries]:
            trial = {k: dict(v) for k, v in forces[i].items()}
            trial.setdefault(FORCES[kind], {})[key] = code
            out = reference.run(served, forces[:i] + [trial] + forces[i + 1:], only=[i])[0]
            got = compare(s.wav, out, hop, tau, n)
            trail[-1][1].append([gap, kind, got["diverged_at"]])
            if got["diverged_at"] is None or got["diverged_at"] > f:
                forces[i], ref, cur, moved = trial, out, got, True
                done.add((kind, key))
                flips.append(gap)
                break
        if not moved:
            break
    cur.update(flips=flips, trail=trail, explained=cur["diverged_at"] is None)
    return cur


def judge(reference: Reference, served: Sequence[Checked], refs: List[Dict], tau: float,
          tie: float, tries: int) -> Outcome:
    forces: List[Dict] = [{} for _ in served]
    per = [follow(reference, served, i, r, forces, tau, tie, tries) for i, r in enumerate(refs)]
    return Outcome(
        wave_err=max((p["wave_err"] for p in per), default=0.0),
        unexplained=sum(1 for p in per if not p["explained"]),
        sessions=per,
    )


def within(outcome: Outcome, limits: Dict) -> Dict[str, tuple]:
    """name -> (reading, limit, held) for the two numbers."""
    return {
        "wave_err": (outcome.wave_err, limits["wave_err"], outcome.wave_err <= limits["wave_err"]),
        "unexplained": (outcome.unexplained, limits["unexplained"],
                        outcome.unexplained <= limits["unexplained"]),
    }


def set_tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
