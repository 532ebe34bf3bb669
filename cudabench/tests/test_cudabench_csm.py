"""The CSM cell end to end on the CPU at a small size: `run.main` reads
correct with the program's plain path, and three faults planted in the
program each read not correct: the depth decoder's cache not started afresh
between frames, the codebook offsets into the audio table shifted by one
codebook, and RoPE without the llama3 scaling."""

import json

import pytest
import torch

from cudabench import run
from cudabench.tests.small import MIMI, REPO

CELL = "csm-1b-fp32.synth-single"
# initializer_range well above the published 0.02: at these widths 0.02 leaves
# attention all but uniform, and RoPE without effect
CSM = dict(num_codebooks=4, vocab_size=67, text_vocab_size=300, hidden_size=64, initializer_range=0.3,
           intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, head_dim=16, max_position_embeddings=256)
DEPTH = dict(num_codebooks=4, backbone_hidden_size=64, vocab_size=67, hidden_size=32,
             intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, head_dim=8, max_position_embeddings=5)
# the Mimi codebook 3 ids short of the vocabulary, as 2048 of 2051 are; top-k
# small enough that the zeroed head rows stay out of it
SMALL_MIMI = dict(MIMI, num_quantizers=4, codebook_size=64)
# RoPE long enough against the small widths that the scaling changes the angles
ROPE = {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
        "original_max_position_embeddings": 64}


def override(cfg, mix):
    c = cfg["csm"]
    cfg = dict(cfg, text_vocab=300, tokenizer={"bos": 1, "eos": 2},
               mimi=dict(cfg["mimi"], **SMALL_MIMI),
               csm=dict(c, **CSM, rope_scaling=ROPE,
                        depth_decoder_config=dict(c["depth_decoder_config"], **DEPTH,
                                                  rope_scaling=ROPE)))
    mix = dict(mix, text_len=[4, 20], refs=dict(mix["refs"], frames=10, transcript=6),
               frames=[16, 16], lead_s=0.5, sampling=dict(mix["sampling"], top_k=4),
               check=dict(mix["check"], sessions=3, keep=1.0))
    return cfg, mix


def drive(capsys, keep=None, seed=2 ** 31 + 19):
    torch.manual_seed(0)
    rc = run.main(["--workload", CELL, "--seed", str(seed), "--seconds", "3", "--trace", "0"],
                  device="cpu", root=REPO, cfg_override=override, keep=keep)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_csm_reference_agrees_with_the_plain_path(capsys):
    keep = {}
    line = drive(capsys, keep)
    assert line["correct"] and line["failed"] == 0
    assert line["checked"]["sessions_checked"]["value"] == 3
    assert keep["outcome"].wave_err < 1e-5 and keep["outcome"].unexplained == 0
    assert set(line["metrics"]) == {"setup_s", "audio_s_per_s", "request_ms_p95"}


def _stale_depth_cache(monkeypatch):
    """Each frame's depth passes start after the previous frame's first
    position, which they attend to."""
    from sopro_tpu_torch.models import csm as M

    monkeypatch.setattr(M.KVCache, "reset", lambda self: setattr(self, "filled", min(self.filled, 1)))


def _shifted_offsets(monkeypatch):
    from sopro_tpu_torch.models import csm as M

    orig = M.CsmModel.offsets
    monkeypatch.setattr(M.CsmModel, "offsets",
                        lambda self: torch.roll(orig(self), 1) % (self.cfg.num_codebooks * self.cfg.vocab_size))


def _unscaled_rope(monkeypatch):
    from sopro_tpu_torch.models import csm as M

    orig = M.rope_cos_sin
    monkeypatch.setattr(M, "rope_cos_sin", lambda pos, hd, theta, scaling=None: orig(pos, hd, theta))


@pytest.mark.parametrize("plant", [_stale_depth_cache, _shifted_offsets, _unscaled_rope])
def test_csm_planted_fault_is_not_correct(capsys, monkeypatch, plant):
    plant(monkeypatch)
    keep = {}
    line = drive(capsys, keep)
    assert line["correct"] is False and line["failed"] == 0
    assert keep["outcome"].unexplained >= 1




def _frames_trace(drop_row=None, graph=False):
    """Frames back to back over a 3 s stretch: a `csm.backbone` span of 2 ms
    enqueuing 3 kernels of 0.3 ms, a `csm.depth` span of 8 ms enqueuing 5
    kernels of 1 ms, then the end flag's copy; host profiler seconds are perf
    seconds less 1000, the card's clock drifts against the host's. `graph`:
    the depth span copies three inputs, launches the 5 kernels as one graph
    with a copy node after its second, and copies the codes out, each copy
    10 us on the card; host rows before the profiler's start are left out,
    and device rows enqueued before it too."""
    from sopro_tpu_torch.profiling import Span

    off, window = 1000.0, 3.0
    store, kernels, host = [], [], [("cudaDeviceSynchronize", window - 0.001, window)]
    card = lambda h: 1.0001 * h + 0.002
    t, sid, busy = -0.005, 0, 0.0

    def enqueue(name, at, rows):
        nonlocal busy
        host.append((name, t + at, t + at + 1e-5))
        busy = max(busy, t + at)
        for row, dur in rows:
            if not graph or t + at >= 0.0:
                kernels.append((row, card(busy), card(busy + dur), 0))
            busy += dur

    copy = ("cudaMemcpyAsync", [("Memcpy DtoD (Device -> Device)", 1e-5)])
    while t < window + 0.02:
        ns = lambda x: int(round((off + t + x) * 1e9))
        sid += 2
        store += [Span("csm.backbone", sid, sid, None, 7, ns(0.0), ns(0.002)),
                  Span("csm.depth", sid + 1, sid + 1, None, 7, ns(0.002), ns(0.010))]
        for j in range(3):
            enqueue("cudaLaunchKernel", 0.0002 + 0.0005 * j, [("gemv_kernel", 0.0003)])
        if graph:
            for j in range(3):
                enqueue(copy[0], 0.0021 + 0.0001 * j, copy[1])
            nodes = [("gemv_kernel", 0.001)] * 2 + copy[1] + [("gemv_kernel", 0.001)] * 3
            enqueue("cudaGraphLaunch", 0.0025, nodes)
            enqueue(copy[0], 0.0090, copy[1])
        else:
            for j in range(5):
                enqueue("cudaLaunchKernel", 0.0025 + 0.0015 * j, [("gemv_kernel", 0.001)])
        enqueue("cudaMemcpyAsync", 0.0101, [("Memcpy DtoH (Device -> Pageable)", 1e-5)])
        t += 0.0105
    kernels = [k for k in kernels if k[1] >= 0.0]
    host = [h for h in host if not graph or h[1] >= 0.0]
    if drop_row is not None:
        del kernels[drop_row]
    return store, {"kernels": kernels, "host": host, "window_s": window}, off


def test_csm_frame_readers_on_a_synthetic_trace(monkeypatch):
    """Spans recorded under no root (a call open when the profiler started)
    still pair into frames by thread."""
    from cudabench import flops_csm, spans, spans_csm
    from cudabench.run import load_reader

    with open(f"{REPO}/cudabench/configs/csm-1b-fp32.json") as f:
        cfg = json.load(f)
    with open(f"{REPO}/cudabench/traffic/csm-single.json") as f:
        mix = json.load(f)
    store, tr, off = _frames_trace()
    rec = {"trace": tr, "span": (off - 50.0, off), "cfg": cfg, "mix": mix, "flops": flops_csm,
           "records": [], "w0": off - 50.0, "w1": off + 3.0, "cell": {"chips": 1}}
    got = spans_csm.frames(rec, store)
    assert abs(len(got["frame"]) - 285) <= 2
    assert all(abs(d - 0.0009 * 1.0001) < 1e-9 for *_, d in got[spans_csm.BACKBONE])
    assert all(abs(d - 0.005 * 1.0001) < 1e-9 for *_, d in got[spans_csm.DEPTH])
    assert {n for *_, n in got["frame"]} == {8}
    monkeypatch.setattr(spans, "recorded", lambda: store)
    reader = lambda name: load_reader(REPO, name)
    assert reader("launches_per_frame.csm")(rec) == 8.0
    want = 100.0 * flops_csm.depth_bytes(cfg["csm"]) / flops_csm.PEAK_BYTES / (0.005 * 1.0001)
    assert abs(reader("depth_roofline_pct.csm")(rec) - want) < 1e-6 * want
    assert reader("backbone_roofline_pct.csm")(rec) is None  # no request finished
    _, tr2, _ = _frames_trace(drop_row=500)  # a row missing: the pairing fails its check
    assert reader("depth_roofline_pct.csm")(dict(rec, trace=tr2)) is None
    monkeypatch.setattr(spans, "recorded", lambda: [])
    assert reader("depth_roofline_pct.csm")(rec) is None


def test_csm_frame_readers_pair_graph_launches_with_their_rows(monkeypatch):
    """A graph launch's rows, copy nodes among them, go to the span that
    launched it, the profiler starting while a replay runs."""
    from cudabench import flops_csm, spans, spans_csm
    from cudabench.run import load_reader

    with open(f"{REPO}/cudabench/configs/csm-1b-fp32.json") as f:
        cfg = json.load(f)
    store, tr, off = _frames_trace(graph=True)
    rec = {"trace": tr, "span": (off - 50.0, off), "cfg": cfg, "mix": {}, "flops": flops_csm,
           "records": [], "w0": off - 50.0, "w1": off + 3.0, "cell": {"chips": 1}}
    host = [n for _, n in sorted((a, n) for n, a, _ in tr["host"])
            if n.startswith(spans.WORK + spans_csm.GRAPH)]
    dev = [n for _, n in sorted((a, n) for n, a, *_ in tr["kernels"])]
    assert spans_csm.pairing(spans_csm._kinds(host), spans_csm._kinds(dev))[0] == 6
    got = spans_csm.frames(rec, store)
    assert abs(len(got["frame"]) - 285) <= 2
    assert all(abs(d - 0.0009 * 1.0001) < 1e-9 for *_, d in got[spans_csm.BACKBONE])
    depth_s = (0.005 + 5e-5) * 1.0001
    assert all(abs(d - depth_s) < 1e-9 for *_, d in got[spans_csm.DEPTH])
    assert {n for *_, n in got["frame"]} == {4}
    monkeypatch.setattr(spans, "recorded", lambda: store)
    reader = lambda name: load_reader(REPO, name)
    assert reader("launches_per_frame.csm")(rec) == 4.0
    want = 100.0 * flops_csm.depth_bytes(cfg["csm"]) / flops_csm.PEAK_BYTES / depth_s
    assert abs(reader("depth_roofline_pct.csm")(rec) - want) < 1e-6 * want
    _, tr2, _ = _frames_trace(drop_row=500, graph=True)  # a row missing: the pairing fails its check
    assert reader("depth_roofline_pct.csm")(dict(rec, trace=tr2)) is None
