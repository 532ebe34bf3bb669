"""The one traffic generator: a mix is a JSON file `traffic/<name>.json` of
parameters, read by `load`, and `Traffic` turns it and a seed into the
sessions a run sends.

Keys of a mix:
- "entry": the program's entry the sessions go through: "serve"
  (`ContinuousBatcher.submit` / `SessionHandle.chunks()`) or "synthesize"
  (`SoproTTS.synthesize`);
- "loop": "open" (bursts on a schedule, whatever the system does) or
  "closed" ("clients" clients, each sending its next session when the last
  ended);
- "rate": sessions per second of an open loop; "burst": {"lo", "hi",
  "mean"}, burst sizes geometric on lo..hi with that mean; burst starts a
  Poisson process;
- "lead_s": seconds of traffic before the window opens;
- "text_len": [lo, hi] tokens, uniform; "frames": [lo, hi] session caps in
  frames, log-uniform (equal ends: fixed);
- "refs": {"count", "frames", "zipf"}: reference voices made in set-up and
  the Zipf exponent by which sessions choose one;
- "sampling": {"top_p", "temperature", "anti_loop"};
- "batcher": the `ContinuousBatcher` keywords (serve);
- "check": {"sessions", "keep"}: how many finished sessions the check
  compares, and the share of sessions whose audio a run keeps to draw them
  from;
- "schedule_seed" (open loop): the seed of the arrival schedule;
- "clients", "cycle" (closed loop): each client sends sessions until the
  window closes, repeating one `cycle` of sizes.

Every seed gets the same work. Each drawn size (text length, cap, burst
size, gap) is a fixed set of quantiles of its distribution. An open loop's
schedule (burst starts, sizes, and the length and cap of each session) is
put in order by the mix's `schedule_seed`, so every run offers the same
load at the same times and a tail measures the system, not the order; a
closed-loop client repeats one cycle of quantiles in an order drawn from
the run's seed, each client from a generator of its own, so what a client
sends does not depend on how fast the others go. The seed draws the
contents: text ids, voices, sampling seeds, and which sessions the check
may pick.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
INT32_MAX = 2 ** 31 - 1


def load(name: str, root: Optional[str] = None) -> Dict:
    with open(os.path.join(root or HERE, f"{name}.json")) as f:
        return json.load(f)


def _quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def loguniform(lo: float, hi: float, u: np.ndarray) -> np.ndarray:
    return np.exp(np.log(lo) + u * (np.log(hi) - np.log(lo)))


def truncated_geometric(lo: int, hi: int, mean: float) -> np.ndarray:
    """Probabilities of lo..hi under P(k) ~ r^(k - lo), r chosen so the mean
    is `mean` (bisection)."""
    ks = np.arange(lo, hi + 1)

    def m(r):
        p = r ** (ks - lo)
        return float((p * ks).sum() / p.sum())

    a, b = 1e-9, 1.0 - 1e-9
    if not m(a) <= mean <= m(b):
        raise ValueError(f"burst mean {mean} outside [{m(a)}, {m(b)}]")
    for _ in range(100):
        r = 0.5 * (a + b)
        a, b = (r, b) if m(r) < mean else (a, r)
    p = (0.5 * (a + b)) ** (ks - lo)
    return p / p.sum()


def _inverse_discrete(probs: np.ndarray, lo: int, u: np.ndarray) -> np.ndarray:
    return lo + np.searchsorted(np.cumsum(probs), u, side="right").clip(max=len(probs) - 1)


@dataclass
class Session:
    """One request: when it is due (seconds from the traffic's start, open
    loop), its text ids, cap in frames, voice, sampling seed, and whether the
    run keeps its audio for the check."""

    index: int
    due_s: float
    ids: np.ndarray
    frames: int
    voice: int
    seed: int
    keep: bool


class Traffic:
    def __init__(self, mix: Dict, seed: int, seconds: float, vocab: int):
        self.mix = mix
        self.seconds = float(seconds)
        self.lead = float(mix.get("lead_s", 0.0))
        self.rng = np.random.default_rng(int(seed) & 0xFFFF_FFFF_FFFF)
        self.vocab = int(vocab)
        refs = mix["refs"]
        z = 1.0 / np.arange(1, int(refs["count"]) + 1) ** float(refs["zipf"])
        self.voice_p = z / z.sum()
        self.keep_p = float(mix["check"]["keep"])
        if mix["loop"] == "open":
            self.sessions = self._open()
        else:
            self.clients = [self._stream(int(seed) & 0xFFFF_FFFF_FFFF, c)
                            for c in range(int(mix["clients"]))]

    def _sizes(self, n: int, order, rng=None):
        """n (text length, frames, voice) triples: quantiles, the sizes put
        in order by `order` (a generator), the voices by `rng` (by default
        the run's seed)."""
        u = _quantiles(n)
        lo, hi = self.mix["text_len"]
        lens = np.floor(lo + u * (hi - lo + 1)).astype(int).clip(lo, hi)
        flo, fhi = self.mix["frames"]
        frames = np.rint(loguniform(flo, fhi, u)).astype(int)
        voices = _inverse_discrete(self.voice_p, 0, u)
        rng = rng or self.rng
        return order.permutation(lens), order.permutation(frames), rng.permutation(voices)

    def _make(self, i: int, due: float, ln: int, frames: int, voice: int, rng=None) -> Session:
        rng = rng or self.rng
        return Session(
            index=i, due_s=float(due),
            ids=rng.integers(0, self.vocab, size=int(ln)).astype(np.int32),
            frames=int(frames), voice=int(voice),
            seed=int(rng.integers(0, INT32_MAX)),
            keep=bool(rng.random() < self.keep_p),
        )

    def _open(self) -> List[Session]:
        """Bursts over lead + window: a fixed count, sizes from the
        truncated geometric's quantiles, gaps from the exponential's."""
        span = self.lead + self.seconds
        b = self.mix["burst"]
        order = np.random.default_rng(int(self.mix["schedule_seed"]))
        probs = truncated_geometric(int(b["lo"]), int(b["hi"]), float(b["mean"]))
        n_bursts = max(1, int(round(float(self.mix["rate"]) * span / float(b["mean"]))))
        u = _quantiles(n_bursts)
        sizes = order.permutation(_inverse_discrete(probs, int(b["lo"]), u))
        gaps = order.permutation(-np.log(1.0 - u))
        starts = np.concatenate([[0.0], np.cumsum(gaps)[:-1]]) * span / gaps.sum()
        n = int(sizes.sum())
        lens, frames, voices = self._sizes(n, order)
        out, i = [], 0
        for t, k in zip(starts, sizes):
            for _ in range(int(k)):
                out.append(self._make(i, t, lens[i], frames[i], voices[i]))
                i += 1
        return out

    def _stream(self, seed: int, client: int) -> Iterator[Session]:
        """A closed-loop client's sessions, without end: one cycle of sizes
        in an order drawn from the seed, repeated, each session with ids and
        a sampling seed of its own."""
        rng = np.random.default_rng([seed, client + 1])
        c = int(self.mix["cycle"])
        lens, frames, voices = self._sizes(c, rng, rng)
        i = 0
        while True:
            yield self._make(i, 0.0, lens[i % c], frames[i % c], voices[i % c], rng)
            i += 1

    def voices(self, q: int, v: int) -> List[np.ndarray]:
        """The reference voices' Mimi codes [frames, q]."""
        refs = self.mix["refs"]
        return [self.rng.integers(0, v, size=(int(refs["frames"]), q)).astype(np.int32)
                for _ in range(int(refs["count"]))]
