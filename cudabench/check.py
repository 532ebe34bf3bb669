"""The comparison that decides `correct`.

A checked session is one the program finished in the window: its text ids,
voice, seed, sampling settings and cap (all made by the harness), and what
the client received (the chunks of a served session, the waveform of a
synthesize call). The configuration's family (`cudabench/families/`) builds
the plain reference, in the configuration's precision, that works the
session out again from those inputs and the harness's weights.

Per frame (`hop` samples) the error is the RMS of the difference over the
session's RMS. The first frame whose error passes `tau` is where the two
diverge: a sampled or argmax token differs there. In float32 a sound
program does that only at a near-tie, where the two sides' scores round the
other way (the family's reference says which decisions can reach a frame,
and with what gaps). The check then follows that decision the other way: it
takes the `tries` decisions with the smallest gaps (each under `tie`) that
can reach that frame, sets one at a time to the reference's runner-up, and
works the session out again, with every checked session in the reference's
batch as in the first pass, so that nothing but that decision changes. If
one of them moves the divergence past that frame, it stays set and the
comparison goes on; if none does, the divergence is unexplained: a token
the reference would not give at any near-tie. Two numbers, each against its
limit:

- `wave_err`: the largest frame error over the compared frames (every
  frame, once the divergences are followed);
- `unexplained`: the checked sessions with a divergence no near-tie
  explains.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import numpy as np
import torch

# the precision callers hand a family's reference
from cudabench.reference.precision import Precision  # noqa: F401

MAX_FLIPS = 4  # near-ties followed in one session


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
    sampling: Dict  # the mix's "sampling", whole
    chunks: List[int]
    wav: np.ndarray
    ramp: int = 4
    chunk_frames: int = 16


@dataclass
class Outcome:
    wave_err: float
    unexplained: int
    sessions: List[Dict] = field(default_factory=list)


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


def follow(reference, served: Sequence[Checked], i: int, ref: Dict,
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
        for gap, kind, key, code in reference.near_ties(ref, f, tie, done)[:tries]:
            trial = reference.force(forces[i], kind, key, code)
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


def judge(reference, served: Sequence[Checked], refs: List[Dict], tau: float,
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
