"""Moshi (Kyutai's moshiko) with the Mimi decoder: the family of the
configurations whose "family" is "moshi" (`cudabench/families/__init__.py`
lists what a family module gives).

The program is `sopro_tpu_torch`'s `MoshiDuplex`, built from the harness's
weights under transformers' `MoshiForConditionalGeneration` names through
`hub.moshi_params_from_flat`, and the codec through the Mimi converter.

Weights. `weights.make` draws every tensor of a spec on the card at once
and holds three copies there while it does (the draw, each tensor scaled,
their concatenation): 92 GB for moshiko's 7.69B float32 parameters, past
an H100's 80 GB. So `specs` gives it the embeddings and norms alone, and
`complete` draws the matrices into the same host state dict in blocks of
`BLOCK` elements, seeded from the drawn text embedding (so from the run's
seed), at the same `initializer_range`. Both the program and the reference
read the completed dict.

Traffic. A conversation (`Conversation`) is Moshi's text ids, Moshi's
codes and the user's, drawn from the seed; a call takes one, a history of
its first `len(s.ids)` frames (the traffic's `text_len`), and the user's
next `s.frames` frames as the stream that arrives while Moshi speaks.

The reference (`cudabench/reference/moshi.py`, `mimi.py`) works a checked
call out again from its inputs and the program's own tokens: one causal
forward of the temporal transformer over the call's positions with the
program's tokens in them (teacher-forced, no cache), then per step each
decision on the program's keyed bits: the text token, and the depformer's
codebooks each over its full forward, within a step on the reference's own
picks. Where a pick differs from the program's it stands; where the first
difference is a text token alone (its audio unchanged), the reference runs
on from its own tokens, one full forward a step, until its audio differs
too, as a reference decoding on its own would. Then one Mimi decode of its
codes. The check compares waveforms (`cudabench/check.py`); where the
reference's text ids differ from the program's and its codes do not, its
waveform ends at the first such frame, which the check reads as a
divergence no near-tie explains. A decision of step g sits in waveform frames g - 1 (codebooks 1..7)
and g (codebook 0) and, through the next step's input, g + 1; so the
decisions that can reach frame f are the nine of each of steps f - 1 -
REACH..f + 1.
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from cudabench import flops_moshi as flops  # noqa: F401  (what the per-layer readers find in rec["flops"])
from cudabench import weights
from cudabench.check import Checked
from cudabench.reference import moshi as R
from cudabench.reference.csm import sample
from cudabench.reference.mimi import MimiDecoder
from sopro_tpu_torch.codec.mimi_config import MimiConfig
from sopro_tpu_torch.models.moshi import MoshiConfig
from sopro_tpu_torch.moshi import MoshiDuplex  # a program without Moshi fails here, before any weight

REACH = 2  # frames after a code whose audio a divergence it caused can first show in
BLOCK = 1 << 26  # elements `complete` draws at a time


@dataclass
class Conversation:
    text: np.ndarray  # [N] Moshi's text ids
    moshi: np.ndarray  # [N, Q] Moshi's codes
    user: np.ndarray  # [N + F, Q] the user's codes, F frames past Moshi's


@dataclass
class MoshiChecked(Checked):
    """`ids` as the traffic drew them (their count is the history's
    frames); `text_out` and `codes_out` what the program decided, frame by
    frame."""

    conv: Optional[Conversation] = None
    text_out: Optional[np.ndarray] = None
    codes_out: Optional[np.ndarray] = None

    @property
    def hist(self) -> int:
        return len(self.ids)


def _layer(spec, p: str, d: int, f2: int, hd: int, heads: int, kvh: int, sets: Optional[int],
           std: float):
    """A decoder layer's tensors; `sets`: each matrix a stack of that many
    weight sets."""
    stack = lambda shape: shape if sets is None else (sets,) + shape
    for ln in ("input_layernorm", "post_attention_layernorm"):
        spec.append((f"{p}.{ln}.weight", (d,), "c", 1.0))
    for x, out in (("q", heads * hd), ("k", kvh * hd), ("v", kvh * hd)):
        spec.append((f"{p}.self_attn.{x}_proj.linear.weight", stack((out, d)), "n", std))
    spec.append((f"{p}.self_attn.o_proj.linear.weight", stack((d, heads * hd)), "n", std))
    spec.append((f"{p}.mlp.fc1.weight", stack((f2, d)), "n", std))
    spec.append((f"{p}.mlp.fc2.weight", stack((d, f2 // 2)), "n", std))


def _widths(c: Dict):
    d, h = int(c["hidden_size"]), int(c["num_attention_heads"])
    return d, int(c["ffn_dim"]), int(c.get("head_dim") or d // h), h, int(c.get("num_key_value_heads") or h)


def moshi_spec(c: Dict) -> weights.Spec:
    """MoshiForConditionalGeneration's tensors (the codec's aside) at
    `initializer_range`, norms 1."""
    std = float(c["initializer_range"])
    q, va, vt = int(c["num_codebooks"]), int(c["audio_vocab_size"]), int(c["vocab_size"])
    dc = c["depth_decoder_config"]
    d, f2, hd, h, kvh = _widths(c)
    dd, df2, dhd, dh, dkvh = _widths(dc)
    spec: weights.Spec = [(f"embed_tokens.{i}.weight", (va + 1, d), "n", std) for i in range(2 * q)]
    spec.append(("decoder.model.embed_tokens.weight", (vt + 1, d), "n", std))
    for i in range(int(c["num_hidden_layers"])):
        _layer(spec, f"decoder.model.layers.{i}", d, f2, hd, h, kvh, None, std)
    spec.append(("decoder.model.norm.weight", (d,), "c", 1.0))
    spec.append(("decoder.lm_head.weight", (vt, d), "n", std))
    spec.append(("depth_decoder.text_embed_tokens.weight", (vt + 1, dd), "n", std))
    spec += [(f"depth_decoder.embed_tokens.{i}.weight", (va + 1, dd), "n", std) for i in range(q - 1)]
    spec.append(("depth_decoder.input_projections.weight", (q, dd, d), "n", std))
    for i in range(int(dc["num_hidden_layers"])):
        _layer(spec, f"depth_decoder.layers.{i}", dd, df2, dhd, dh, dkvh, q, std)
    spec.append(("depth_decoder.lm_heads.weight", (q, va, dd), "n", std))
    return spec


def _bulk(name: str, shape) -> bool:
    """A matrix `complete` draws (every tensor but the embeddings and the
    norms)."""
    return len(shape) >= 2 and "embed_tokens" not in name


def specs(cfg: Dict) -> List:
    drawn = [e for e in moshi_spec(cfg["moshi"]) if not _bulk(e[0], e[1])]
    return [drawn, weights.mimi_spec(cfg["mimi"])]


def complete(sd: Dict[str, np.ndarray], c: Dict, device) -> None:
    """Draw the matrices `specs` leaves out into `sd` (module docstring):
    normal at their std, in `BLOCK`-element draws on `device` from a
    generator seeded by the drawn text embedding's first row. Nothing
    happens if they are there."""
    todo = [e for e in moshi_spec(c) if _bulk(e[0], e[1]) and e[0] not in sd]
    if not todo:
        return
    row = np.ascontiguousarray(sd["decoder.model.embed_tokens.weight"][0])
    gen = torch.Generator(device=device)
    gen.manual_seed(int.from_bytes(hashlib.sha256(row.tobytes()).digest()[:6], "little"))
    host = np.empty(sum(int(np.prod(s)) for _, s, _, _ in todo), np.float32)
    flat, off = torch.from_numpy(host), 0
    for name, shape, _, std in todo:
        n = int(np.prod(shape))
        for a in range(0, n, BLOCK):
            b = min(n, a + BLOCK)
            flat[off + a: off + b].copy_(torch.randn(b - a, generator=gen, device=device) * float(std))
        sd[name] = host[off: off + n].reshape(shape)
        off += n


def build(cfg: Dict, state_dicts, device, tokenizer):
    sd_moshi, sd_mimi = state_dicts
    complete(sd_moshi, cfg["moshi"], device)
    return MoshiDuplex.from_state_dicts(sd_moshi, sd_mimi, MoshiConfig.from_dict(cfg["moshi"]),
                                        MimiConfig.from_dict(cfg["mimi"]), device=device)


def voices(traffic, cfg: Dict) -> List[Conversation]:
    """The traffic's conversations: `refs["count"]` of `refs["frames"]`
    frames, Moshi's codes first (`traffic.voices`), then per conversation
    its text ids and the user's codes, `frames[1]` frames longer."""
    c = cfg["moshi"]
    q, va = int(c["num_codebooks"]), int(c["audio_vocab_size"])
    n, extra = int(traffic.mix["refs"]["frames"]), int(traffic.mix["frames"][1])
    out = []
    for codes in traffic.voices(q, va):
        text = traffic.rng.integers(0, int(c["vocab_size"]), size=n)
        user = traffic.rng.integers(0, va, size=(n + extra, q))
        out.append(Conversation(text.astype(np.int64), codes.astype(np.int64), user.astype(np.int64)))
    return out


def sample_rate(cfg: Dict) -> int:
    return int(cfg["mimi"]["sampling_rate"])


def checked(records, mix: Dict, voices) -> List[MoshiChecked]:
    out = []
    for r in records:
        conv = voices[r.sess.voice]
        out.append(MoshiChecked(ids=r.sess.ids, voice=r.sess.voice, ref_tokens=conv.moshi,
                                seed=r.sess.seed, cap=r.sess.frames, sampling=dict(mix["sampling"]),
                                chunks=list(r.chunk_n), wav=np.concatenate(r.wav), conv=conv,
                                text_out=r.moshi[0], codes_out=r.moshi[1]))
    return out


def reference(state_dicts, cfg: Dict, prec, device, entry, mix: Dict) -> "Reference":
    return Reference(*state_dicts, cfg, prec, device)


class Reference:
    """The reference model and decoder over the harness's weights, on
    `device`, in `prec`. Each session's teacher-forced temporal states are
    kept, so a run that sets one more decision redoes only its decisions,
    any run from its own tokens, and its decode."""

    def __init__(self, moshi_sd, mimi_sd, cfg: Dict, prec, device):
        complete(moshi_sd, cfg["moshi"], device)
        to = lambda sd: {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in sd.items()}
        c = cfg["moshi"]
        self.cfg = cfg
        self.model = R.Moshi(to(moshi_sd), c, prec)
        self.q = int(c["num_codebooks"])
        self.mimi = MimiDecoder(to(mimi_sd), dict(cfg["mimi"], num_quantizers=self.q), prec)
        self.device = device
        self.hop = int(round(int(cfg["mimi"]["sampling_rate"]) / float(cfg["mimi"]["frame_rate"])))
        self._hidden: Dict[tuple, torch.Tensor] = {}

    @staticmethod
    def _key(s: MoshiChecked) -> tuple:
        return (s.voice, s.hist, s.cap, s.text_out.tobytes(), s.codes_out.tobytes())

    def _tokens(self, s: MoshiChecked) -> torch.Tensor:
        """The program's call laid out as positions 0..H + F + 1: the
        history, the program's text and codes for frames H..H + F - 1, the
        user's stream; initial tokens in frame H + F."""
        m, h, f = self.model, s.hist, s.cap
        init = lambda n, v: np.full((n, self.q), v, np.int64)
        text = np.concatenate([s.conv.text[:h], s.text_out, [m.vt]])
        moshi = np.concatenate([s.conv.moshi[:h], s.codes_out, init(1, m.va)])
        user = np.concatenate([s.conv.user[: h + f], init(1, m.va)])
        dev = self.device
        return R.positions(*(torch.from_numpy(np.asarray(x, np.int64)).to(dev) for x in (text, moshi, user)),
                           m.vt, m.va)

    def _teacher_forced(self, sessions: Sequence[MoshiChecked]) -> None:
        """The temporal states of positions H..H + F of each session, its
        positions 0..H + F holding the program's tokens, in one batch."""
        xs = [self.model.embed(self._tokens(s)[: s.hist + s.cap + 1]) for s in sessions]
        lengths = [x.shape[0] for x in xs]
        hs = self.model.temporal(torch.nn.utils.rnn.pad_sequence(xs, batch_first=True), lengths)
        for b, s in enumerate(sessions):
            self._hidden[self._key(s)] = hs[b, s.hist: s.hist + s.cap + 1]

    @torch.inference_mode()
    def run(self, sessions: Sequence[MoshiChecked], forces: Optional[Sequence[Dict]] = None,
            only: Optional[Sequence[int]] = None) -> List[Dict]:
        """Each session's waveform, frames, and per decision [step, d] (d = 0
        the text token, 1 + k codebook k) its gap, runner-up, edge margin
        and the token across the edge (gap inf: no decision). `forces[i]`:
        {"code": {(step, d): token}}."""
        forces = list(forces) if forces is not None else [{} for _ in sessions]
        only = list(range(len(sessions)) if only is None else only)
        todo = [sessions[i] for i in only if self._key(sessions[i]) not in self._hidden]
        if todo:
            self._teacher_forced(todo)
        return [self._session(sessions[i], dict(forces[i].get("code", {}))) for i in only]

    def _decide(self, h: torch.Tensor, steps: List[int], own: torch.Tensor, stats: Dict,
                noise, sp: Dict, force: Dict) -> None:
        """Steps `steps`' decisions after their temporal states h [n, D], each
        depformer step on the steps' own picks before it, into `own` [F + 1,
        1 + Q] and `stats`; step 0's codebooks 1.. stay the history's."""
        m, rows = self.model, torch.tensor(steps, device=self.device)
        logits = lambda d: m.text_logits(h) if d == 0 else m.depth_logits(h, own[rows, :d])
        for d in range(1 + self.q):
            temp, top_k = ((sp["text_temperature"], sp["text_top_k"]) if d == 0
                           else (sp["audio_temperature"], sp["audio_top_k"]))
            tok, *rest = sample(logits(d), noise[d][rows], float(temp), int(top_k))
            for j, g in enumerate(steps):
                if (g, d) in force:
                    tok[j] = int(force[(g, d)])
            live = torch.tensor([g > 0 or d <= 1 for g in steps], device=self.device)
            own[rows, d] = torch.where(live, tok, own[rows, d])
            for name, x in zip(("gap", "second", "edge", "other"), rest):
                stats[name][rows, d] = torch.where(live, x.to(stats[name].dtype),
                                                   stats[name][rows, d])

    def _session(self, s: MoshiChecked, force: Dict) -> Dict:
        m, h, f, q, dev = self.model, s.hist, s.cap, self.q, self.device
        seq = self._tokens(s)
        prog = seq[h + 1: h + f + 2, : 1 + q]
        own = prog.clone()
        inf = torch.full((f + 1, 1 + q), float("inf"), device=dev)
        stats = {"gap": inf.clone(), "edge": inf.clone(), "second": torch.zeros_like(own),
                 "other": torch.zeros_like(own)}
        text_noise = R.call_noise(s.seed, f + 1, 0, 1, m.vt, dev)[:, 0]
        audio_noise = R.call_noise(s.seed, f + 1, 1, q, m.va, dev)
        noise = [text_noise] + [audio_noise[:, k] for k in range(q)]
        self._decide(self._hidden[self._key(s)], list(range(f + 1)), own, stats, noise,
                     s.sampling, force)
        # the program's tokens known: text and codebook 0 of steps 0..F-1,
        # codebooks 1.. of steps 0..F; in the audio: codebook 0 of steps
        # 0..F-1, codebooks 1.. of steps 1..F
        g = torch.arange(f + 1, device=dev)[:, None]
        d = torch.arange(1 + q, device=dev)[None]
        known = (d >= 2) | (g < f)
        audible = known & (d >= 1) & ((d == 1) | (g >= 1))
        differs = (own != prog) & known
        first = int(differs.any(1).int().argmax()) if bool(differs.any()) else None
        if first is not None and not bool((differs[first] & audible[first]).any()):
            for g1 in range(first + 1, f + 1):  # the reference on its own tokens
                tok = seq[: h + g1 + 1].clone()
                tok[h + 1:, : 1 + q] = own[:g1]
                hid = m.temporal(m.embed(tok)[None])[0, -1:]
                self._decide(hid, [g1], own, stats, noise, s.sampling, force)
                if bool(((own[g1] != prog[g1]) & audible[g1]).any()):
                    break
        codes = torch.cat([own[:f, 1:2], own[1:, 2:]], 1)
        wav = self.mimi.decode(codes[None])[0]
        host = lambda k: stats[k].cpu().numpy()
        text_differs = (own[:f, 0] != prog[:f, 0]).cpu()
        if bool(text_differs.any()) and torch.equal(codes, torch.cat([prog[:f, 1:2], prog[1:, 2:]], 1)):
            f = int(text_differs.int().argmax())  # text the audio does not show
        return {"wav": wav.float().cpu().numpy(), "frames": f, "codes": codes, "text": own[:s.cap, 0],
                "gap": host("gap"), "second": host("second"), "edge": host("edge"),
                "other": host("other")}

    @staticmethod
    def near_ties(ref: Dict, f: int, tie: float, done) -> List[tuple]:
        """The decisions of steps f - 1 - REACH..f + 1 with a gap under
        `tie`, smallest first: (gap, kind, (step, d), runner-up), kind "code"
        (the score gap) or "edge" (the top-k edge's margin, and the token
        across it)."""
        out = []
        for g in range(max(0, f - 1 - REACH), min(f + 2, len(ref["gap"]))):
            for d in range(ref["gap"].shape[1]):
                for kind, gap, alt in (("code", ref["gap"], ref["second"]),
                                       ("edge", ref["edge"], ref["other"])):
                    if math.isfinite(gap[g, d]) and gap[g, d] < tie and (kind, (g, d)) not in done:
                        out.append((float(gap[g, d]), kind, (g, d), int(alt[g, d])))
        return sorted(out, key=lambda c: c[0])

    @staticmethod
    def force(forces: Dict, kind: str, key, code: int) -> Dict:
        """`forces` with decision `key` set to `code` (an edge sets its
        decision's token)."""
        out = {k: dict(v) for k, v in forces.items()}
        out.setdefault("code", {})[key] = code
        return out
