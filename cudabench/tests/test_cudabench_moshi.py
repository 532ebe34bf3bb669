"""The Moshi cell end to end on the CPU at a small size: `run.main` reads
correct with the program's plain path, and three faults planted in the
program each read not correct: every depformer step taking weight set 0,
the acoustic delay dropped, and the user's stream left out of the frame
embedding."""

import json

import pytest
import torch

from cudabench import run
from cudabench.tests.small import MIMI, REPO

CELL = "moshiko-7b-fp32.duplex-single"
# initializer_range well above the published 0.02: at these widths 0.02 leaves
# attention all but uniform and the logits too flat to tell a fault
DEPTH = dict(vocab_size=61, hidden_size=32, input_size=64, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=4, audio_vocab_size=64, head_dim=8,
             initializer_range=0.3, ffn_dim=64, num_codebooks=3)
MOSHI = dict(vocab_size=61, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=4, audio_vocab_size=64, max_position_embeddings=128, head_dim=16,
             initializer_range=0.3, ffn_dim=128, num_codebooks=3)
# Mimi's 4 quantizers, of which Moshi's 3 codebooks are decoded
SMALL_MIMI = dict(MIMI, num_quantizers=4, codebook_size=64)


def override(cfg, mix):
    c = cfg["moshi"]
    cfg = dict(cfg, text_vocab=61, mimi=dict(cfg["mimi"], **SMALL_MIMI),
               moshi=dict(c, **MOSHI, depth_decoder_config=dict(c["depth_decoder_config"], **DEPTH)))
    mix = dict(mix, text_len=[4, 12], refs=dict(mix["refs"], frames=12), frames=[10, 10], lead_s=0.5,
               sampling=dict(mix["sampling"], text_top_k=8, audio_top_k=16),
               check=dict(mix["check"], sessions=3, keep=1.0))
    return cfg, mix


def drive(capsys, keep=None, seed=2 ** 31 + 19):
    torch.manual_seed(0)
    rc = run.main(["--workload", CELL, "--seed", str(seed), "--seconds", "3", "--trace", "0"],
                  device="cpu", root=REPO, cfg_override=override, keep=keep)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_moshi_reference_agrees_with_the_plain_path(capsys):
    keep = {}
    line = drive(capsys, keep)
    assert line["correct"] and line["failed"] == 0
    assert line["checked"]["sessions_checked"]["value"] == 3
    assert keep["outcome"].wave_err < 1e-5 and keep["outcome"].unexplained == 0
    assert set(line["metrics"]) == {"setup_s", "audio_s_per_s", "request_ms_p95"}


def _one_weight_set(monkeypatch):
    """Every depformer step through weight set 0."""
    from sopro_tpu_torch.models import moshi as M

    orig = M.MoshiModel.depth_step
    monkeypatch.setattr(M.MoshiModel, "depth_step", lambda self, k, x, cache: orig(self, 0, x, cache))


def _no_delay(monkeypatch):
    """Codebooks 1.. at the same position as codebook 0."""
    from sopro_tpu_torch import moshi_engine as E

    def flat(text, moshi, user, init_text, init_audio):
        seq = torch.full((text.shape[0] + 1, 1 + 2 * moshi.shape[1]), init_audio, dtype=torch.int64)
        seq[0, 0] = init_text
        seq[1:, 0], seq[1:, 1: 1 + moshi.shape[1]], seq[1:, 1 + moshi.shape[1]:] = text, moshi, user
        return seq.to(text.device)
    monkeypatch.setattr(E, "delay", flat)


def _no_user_stream(monkeypatch):
    """The user's codebooks left out of the frame embedding."""
    from sopro_tpu_torch.models import moshi as M

    def embed(self, tokens):
        q = self.cfg.num_codebooks
        audio = self.p["audio_embed"][torch.arange(q, device=tokens.device), tokens[:, 1: 1 + q]]
        return audio.sum(dim=1) + self.p["text_embed"][tokens[:, 0]]
    monkeypatch.setattr(M.MoshiModel, "embed", embed)


@pytest.mark.parametrize("plant", [_one_weight_set, _no_delay, _no_user_stream])
def test_moshi_planted_fault_is_not_correct(capsys, monkeypatch, plant):
    plant(monkeypatch)
    keep = {}
    line = drive(capsys, keep)
    assert line["correct"] is False and line["failed"] == 0
    assert keep["outcome"].unexplained >= 1


def test_moshi_k3_reader_on_a_synthetic_trace(monkeypatch):
    """`k3_roofline_pct.moshi` reads K3's rows inside each whole `moshi.mimi`
    span alone: `test_cudabench_csm`'s synthetic trace, its backbone spans
    standing for Mimi decodes whose three rows are K3's and its depth spans
    for the depformer's."""
    from types import SimpleNamespace

    from cudabench import flops_moshi, spans, spans_moshi
    from cudabench.run import load_reader
    from cudabench.tests.test_cudabench_csm import _frames_trace

    with open(f"{REPO}/cudabench/configs/moshiko-7b-fp32.json") as f:
        cfg = json.load(f)
    store, tr, off = _frames_trace()
    names = {"csm.backbone": spans_moshi.MIMI, "csm.depth": spans_moshi.DEPTH}
    store = [x._replace(name=names[x.name]) for x in store]
    tr = dict(tr, kernels=[(("conv_wgmma_kernel" if b - a < 5e-4 else n), a, b, d)
                           for n, a, b, d in tr["kernels"]])
    done = [SimpleNamespace(end=off - 1.0, error=None, start=off - 2.0, chunk_n=[100])]
    rec = {"trace": tr, "span": (off - 50.0, off), "cfg": cfg, "mix": {}, "flops": flops_moshi,
           "records": done, "w0": off - 50.0, "w1": off + 3.0, "cell": {"chips": 1}}
    got = spans_moshi.mimi_rows_s(rec, ("conv_wgmma_kernel",), store)
    assert abs(len(got) - 285) <= 2 and all(abs(d - 0.0009 * 1.0001) < 1e-9 for d in got)
    assert set(spans_moshi.mimi_rows_s(rec, ("gemv_kernel",), store)) == {0.0}
    monkeypatch.setattr(spans, "recorded", lambda: store)
    reader = load_reader(REPO, "k3_roofline_pct.moshi")
    want = 100.0 * flops_moshi.k3_bound_s(cfg["mimi"], 100, "float32") / (0.0009 * 1.0001)
    assert abs(reader(rec) - want) < 1e-6 * want
    assert reader(dict(rec, records=[])) is None
    monkeypatch.setattr(spans, "recorded", lambda: [])
    assert reader(rec) is None
