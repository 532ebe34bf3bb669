"""A whole run on the CPU at a small size: the reference agrees with the
program's plain path, a fault planted in the timed path makes `correct`
false, a divergence at a near-tie is followed and one at a sure decision is
not, and a cell added as data alone runs."""

import dataclasses
import json
import threading

import pytest
import torch

from cudabench import check, run
from cudabench.tests.small import REPO, checkout, override

CELLS = ["sopro-v1.5-fp32.serve-bursty", "sopro-v1.5-fp32.synth-single",
         "sopro-v1.5-fp32.serve-saturated", "sopro-v1.5-fp32.serve-dp4"]


# the serving cells whose data is ready but which BENCHMARK.json does not hold yet
SERVING = {
    CELLS[0]: ("bursty-8slot", 1), CELLS[2]: ("closed-16", 1), CELLS[3]: ("closed-64-dp4", 4),
}


def drive(capsys, cell, seed=2 ** 31 + 5, root=None, keep=None, tmp=None, seconds=3):
    """One run of `cell` on the CPU at the small size -> its result line.
    A serving cell runs from a checkout whose BENCHMARK.json carries it."""
    if root is None and cell in SERVING:
        with open(f"{REPO}/BENCHMARK.json") as f:
            bench = json.load(f)
        traffic, chips = SERVING[cell]
        bench["workloads"].append({"name": cell, "config": "sopro-v1.5-fp32", "traffic": traffic,
                                   "chips": chips, "why": "a serving cell"})
        root = checkout(tmp, {"BENCHMARK.json": bench})
    root = root or REPO
    torch.manual_seed(0)
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds), "--trace", "0"],
                  device="cpu", root=root, cfg_override=override, keep=keep)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_plain_path(capsys, tmp_path, cell):
    keep = {}
    line = drive(capsys, cell, keep=keep, tmp=tmp_path)
    assert line["correct"] and line["failed"] == 0
    assert line["checked"]["sessions_checked"]["value"] >= 1
    # float32 on both sides, the same ops in another order: rounding alone
    assert keep["outcome"].wave_err < 1e-5
    assert keep["outcome"].unexplained == 0
    assert all(p["diverged_at"] is None and not p["flips"] for p in keep["outcome"].sessions)


def _alter_token(monkeypatch):
    import sopro_tpu_torch.models.sopro as M

    orig = M.ar_loop

    def altered(ctx, cond, state, settings, n_steps, anti_loop):
        toks, ns = orig(ctx, cond, state, settings, n_steps, anti_loop)
        toks = toks.clone()  # each row's first token of the chunk, one id up
        toks[:, 0] = (toks[:, 0] + 1) % int(ctx.cfg.codebook_size)
        return toks, ns
    monkeypatch.setattr(M, "ar_loop", altered)


def _late_token(monkeypatch):
    """Each row's token altered at the last step of every chunk: in a
    synthesize call, only the call's last frames."""
    import sopro_tpu_torch.models.sopro as M

    orig = M.ar_loop

    def altered(ctx, cond, state, settings, n_steps, anti_loop):
        toks, ns = orig(ctx, cond, state, settings, n_steps, anti_loop)
        toks = toks.clone()
        toks[:, -1] = (toks[:, -1] + 1) % int(ctx.cfg.codebook_size)
        return toks, ns
    monkeypatch.setattr(M, "ar_loop", altered)


def _one_bucket(monkeypatch):
    """The first token altered only in synthesize calls whose text is among
    the three shortest lengths of the mix's sixteen (the smallest text
    bucket)."""
    import sopro_tpu_torch.models.sopro as M
    from sopro_tpu_torch.tts import SoproTTS

    short = threading.local()
    synth, loop = SoproTTS.synthesize, M.ar_loop

    def synthesize(self, text, **kw):
        short.on = len(self.tokenizer.encode(text)) <= 6
        try:
            return synth(self, text, **kw)
        finally:
            short.on = False

    def altered(ctx, cond, state, settings, n_steps, anti_loop):
        toks, ns = loop(ctx, cond, state, settings, n_steps, anti_loop)
        if getattr(short, "on", False):
            toks = toks.clone()
            toks[:, 0] = (toks[:, 0] + 1) % int(ctx.cfg.codebook_size)
        return toks, ns
    monkeypatch.setattr(SoproTTS, "synthesize", synthesize)
    monkeypatch.setattr(M, "ar_loop", altered)


def _state_unchanged(monkeypatch):
    """The AR step hands back its random key unchanged: every step draws
    the same bits."""
    import sopro_tpu_torch.sampling as S

    orig = S.split_keys
    monkeypatch.setattr(S, "split_keys", lambda key: (key, orig(key)[1]))


def _half_batch(monkeypatch):
    import sopro_tpu_torch.models.sopro as M

    orig = M.nar_refine

    def half(m, cond, rvq, mask=None, head_tail=None):
        out = orig(m, cond, rvq, mask=mask, head_tail=head_tail)
        b = out.shape[0]
        if b > 1:  # the second half's codes taken from the first half's rows
            out[b // 2:] = out[: b - b // 2][: b // 2]
        return out
    monkeypatch.setattr(M, "nar_refine", half)


def _exchange_left_out(monkeypatch):
    """A mesh tick whose shards' outputs are not gathered: every shard's
    rows read shard 0's."""
    from sopro_tpu_torch.serve.scheduler import ContinuousBatcher

    orig = ContinuousBatcher._process_tick

    def gathered_from_shard0(self, tick):
        if len(tick.parts) > 1 and tick.parts[0] is not None:
            tick.parts = [tick.parts[0] if p is not None else None for p in tick.parts]
        return orig(self, tick)
    monkeypatch.setattr(ContinuousBatcher, "_process_tick", gathered_from_shard0)
    monkeypatch.setattr(run, "WAIT_AFTER_S", 5.0)


FAULTS = ([(c, f) for c in CELLS for f in ("token", "state")]
          + [(c, "half") for c in CELLS if "serve" in c] + [(CELLS[3], "exchange")]
          + [(CELLS[1], "late"), (CELLS[1], "one_bucket")])


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_fault_in_the_timed_path_is_not_correct(capsys, monkeypatch, tmp_path, cell, fault):
    {"token": _alter_token, "state": _state_unchanged, "half": _half_batch,
     "exchange": _exchange_left_out, "late": _late_token,
     "one_bucket": _one_bucket}[fault](monkeypatch)
    keep = {}  # a window long enough for a whole cycle of text lengths
    line = drive(capsys, cell, tmp=tmp_path, keep=keep, seconds=12 if fault == "one_bucket" else 3)
    assert line["correct"] is False
    if fault in ("late", "one_bucket"):  # frames before the fault agree
        assert line["failed"] == 0 and keep["outcome"].wave_err < 1e-5
        assert keep["outcome"].unexplained >= 1
    if fault == "one_bucket":  # one wrong call among those checked is enough
        assert keep["outcome"].unexplained < len(keep["checked"])


@pytest.mark.parametrize("cell", [CELLS[0], CELLS[1]])
def test_a_divergence_is_followed_only_through_a_near_tie(capsys, tmp_path, cell):
    """A program that takes the runner-up at the reference's closest
    decision (what a near-tie does) reads correct; one that takes it at a
    decision the reference is sure of does not."""
    keep = {}
    drive(capsys, cell, keep=keep, tmp=tmp_path)
    ref, s, out = keep["reference"], keep["checked"][0], keep["outs"][0]
    hop, tau = ref.hop, float(keep["limits"]["tau"])
    decisions = ref.near_ties(out, 0, float("inf"), set())
    assert len(decisions) > run.TRIES

    def served_with(decision):
        gap, kind, key, code = decision
        wav = ref.run([s], [ref.force({}, kind, key, code)])[0]["wav"][: int(sum(s.chunks)) * hop]
        return dataclasses.replace(s, wav=wav)

    # the decisions whose runner-up changes what the client gets, closest first
    moving = [(d, w) for d, w in ((d, served_with(d)) for d in decisions)
              if check.compare(w.wav, out, hop, tau, int(sum(s.chunks)))["diverged_at"] is not None]
    assert len(moving) >= 2 and moving[-1][0][0] > 2 * moving[0][0][0]
    (near, closest), (_, sure) = moving[0], moving[-1]
    tie = 2 * near[0] + 1e-6
    o = check.judge(ref, [closest], [out], tau, tie, len(decisions))
    assert o.unexplained == 0 and o.wave_err < 1e-5
    assert o.sessions[0]["flips"] == [near[0]]

    o = check.judge(ref, [sure], [out], tau, tie, len(decisions))
    assert o.unexplained == 1


def test_a_cell_added_as_data_alone_runs(capsys, tmp_path):
    with open(f"{REPO}/BENCHMARK.json") as f:
        bench = json.load(f)
    with open(f"{REPO}/cudabench/traffic/bursty-8slot.json") as f:
        mix = json.load(f)
    with open(f"{REPO}/cudabench/limits/{CELLS[0]}.json") as f:
        limits = json.load(f)
    name = "sopro-v1.5-fp32.test-only"
    bench["workloads"].append({"name": name, "config": "sopro-v1.5-fp32", "traffic": "test-only",
                               "chips": 1, "why": "a test-only mix"})
    bench["per_layer"].append(dict(bench["per_layer"][0], workloads=[name]))
    root = checkout(tmp_path, {"BENCHMARK.json": bench,
                               "cudabench/traffic/test-only.json": dict(mix, rate=3.0),
                               f"cudabench/limits/{name}.json": limits})
    line = drive(capsys, name, root=root)
    assert line["correct"] and line["attempted"] > 0


# "mass": the nucleus's mass without its last token 3e-7 under top_p;
# "nucleus_pair": the first token out of the nucleus tied with its last, so
# both stay in; "top_k_pair": the 50th and 51st tokens tied, so both stay out
@pytest.mark.parametrize("case", ["mass", "nucleus_pair", "top_k_pair"])
def test_an_edge_within_rounding_is_a_near_tie(case):
    """Where a set's edge lies within rounding, the reference sampler
    gives its margin (0 for a tie) and the token that the set across it
    draws; a change of the inputs across that edge draws that token."""
    from cudabench.reference import sampler as S

    v = 80
    logits = torch.linspace(3.0, -3.0, v)
    hist, temp = torch.full((1, S.HIST), -1), torch.ones(1)
    p = torch.softmax(logits[: S.TOP_K].double(), 0).cumsum(0)
    k = int((p <= 0.9).sum()) + 1  # the nucleus's size at top_p 0.9
    if case == "mass":
        top_p, tied = float(p[k - 2]) + 3e-7, None
    elif case == "nucleus_pair":
        top_p, tied = 0.9, (k - 1, k)
    else:
        top_p, tied = 1.0, (S.TOP_K - 1, S.TOP_K)
    if tied:
        logits[tied[1]] = logits[tied[0]]

    def draw(lg, tp, sub):
        return [o[0].item() for o in S.sample(lg[None], hist, sub[None], torch.tensor([tp]), temp)]

    for seed in range(5000):  # a draw in which the edge decides the token
        sub = torch.tensor([seed, 7])
        tok, _, _, margin, other = draw(logits, top_p, sub)
        if margin < 1e-6:
            break
    assert margin < 1e-6 and other != tok
    if case == "mass":
        assert margin > 0
        assert draw(logits, top_p - 2 * margin, sub)[0] == other
        assert draw(logits, top_p + 2 * margin, sub)[0] == tok
    else:
        assert margin == 0
        crossed = []
        for j in tied:
            for d in (-1e-4, 1e-4):
                lg = logits.clone()
                lg[j] += d
                crossed.append(draw(lg, top_p, sub)[0])
        assert other in crossed and set(crossed) <= {tok, other}
