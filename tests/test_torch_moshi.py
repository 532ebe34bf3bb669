"""Moshi on the port against its plain reference (`cudabench/reference/moshi.py`)
on the CPU, with seeded random weights at a small size (2 temporal and 2
depformer layers, 3 codebooks a stream, a text vocabulary of 61): the
prefill and the cached one-position decoding of the temporal transformer
against the reference's full forward, the depformer with a weight set per
step and its cache started afresh every frame, the acoustic delay and the
initial tokens, the sampler's noise and tokens, a whole
`MoshiDuplex.converse` call, the `hub` converter and a snapshot, and the
reference itself against transformers' `MoshiForConditionalGeneration`. On
the card (`cuda`): the teacher-forced logits at the published widths.

Tolerances. Logits: 1e-5 of their largest magnitude. Both sides compute in
float32 with other kernels and orders (SDPA and fused norms against plain
matmul-softmax, a cache against the whole sequence, one summed gather
against a sum of sixteen), which over these few layers moves a logit by a
few ulps (~1e-7 of its scale); a bfloat16 computation would miss by ~1e-2.
Waveforms: 1e-5 of their peak, the same rounding through the Mimi decoder.
Noise, tokens and positions: exact (the same Threefry bits; the sampled
ids where no score gap is within 1e-4).
"""

import gc
import json
import os
import weakref

import numpy as np
import pytest
import torch

from cudabench import weights as CW
from cudabench.families import moshi as FAM
from cudabench.reference import csm as RC
from cudabench.reference import moshi as R
from cudabench.reference.precision import Precision
from sopro_tpu_torch import hub as H
from sopro_tpu_torch import sampling as S
from sopro_tpu_torch.models import moshi as M
from sopro_tpu_torch.moshi import MoshiDuplex
from sopro_tpu_torch.moshi_engine import delay

Q, VT, VA = 3, 61, 64
# initializer_range 0.3: at these widths the published 0.02 leaves attention
# uniform and the logits too flat to tell a wrong input
DEPTH = dict(vocab_size=VT, hidden_size=32, input_size=64, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=4, audio_vocab_size=VA,
             max_position_embeddings=Q + 1, head_dim=8, initializer_range=0.3, ffn_dim=64,
             rms_norm_eps=1e-8, num_codebooks=Q, sliding_window=Q + 1, hidden_act="silu")
MOSHI = dict(vocab_size=VT, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=4, audio_vocab_size=VA, max_position_embeddings=128,
             rope_theta=10000.0, head_dim=16, initializer_range=0.3, ffn_dim=128,
             rms_norm_eps=1e-8, num_codebooks=Q, sliding_window=128, hidden_act="silu",
             depth_decoder_config=DEPTH)
MIMI = dict(sampling_rate=24000, hidden_size=32, num_filters=4, upsampling_ratios=[4, 3],
            codebook_size=VA, codebook_dim=8, num_quantizers=4,
            vector_quantization_hidden_dimension=8, num_semantic_quantizers=1, upsample_groups=32,
            num_hidden_layers=2, intermediate_size=64, num_attention_heads=2,
            num_key_value_heads=2, head_dim=16, sliding_window=6, frame_rate=1000.0,
            audio_channels=1, num_residual_layers=1, kernel_size=7, last_kernel_size=3,
            residual_kernel_size=3, dilation_growth_rate=2, compress=2, norm_eps=1e-5,
            rope_theta=10000.0, layer_scale_initial_scale=0.01)
CFG = {"moshi": MOSHI, "mimi": MIMI, "text_vocab": VT}
SAMPLING = dict(text_temperature=0.7, text_top_k=8, audio_temperature=0.8, audio_top_k=16)


def _close(a, b, rel=1e-5):
    a, b = (torch.as_tensor(x.cpu() if torch.is_tensor(x) else np.asarray(x), dtype=torch.float64)
            for x in (a, b))
    assert float((a - b).abs().max()) <= rel * float(b.abs().max())


@pytest.fixture(scope="module")
def sds():
    moshi_sd, mimi_sd = CW.make(FAM.specs(CFG), 2 ** 31 + 7, "cpu")
    FAM.complete(moshi_sd, MOSHI, "cpu")
    return moshi_sd, mimi_sd


@pytest.fixture(scope="module")
def duplex(sds):
    return FAM.build(CFG, sds, "cpu", None)


@pytest.fixture(scope="module")
def ref(sds):
    return R.Moshi({k: torch.from_numpy(v) for k, v in sds[0].items()}, MOSHI, Precision())


def _conversation(seed=0, n=12, extra=9):
    rng = np.random.default_rng(seed)
    return FAM.Conversation(rng.integers(0, VT, n), rng.integers(0, VA, (n, Q)),
                            rng.integers(0, VA, (n + extra, Q)))


def _forced(duplex, seed=0, hist=7, frames=6):
    """A history, the user's stream and given text and codes for a call."""
    conv = _conversation(seed)
    history = duplex.prepare_history(conv.text[:hist], conv.moshi[:hist], conv.user[:hist])
    rng = np.random.default_rng(seed + 1)
    return (conv, history, conv.user[hist: hist + frames], rng.integers(0, VT, frames),
            rng.integers(0, VA, (frames, Q)))


def _ref_logits(ref, conv, hist, text, codes, device="cpu"):
    """The reference's logits with every token given: the temporal
    transformer's full forward over positions 0..H + F - 1, each depformer
    step's over positions 0..k."""
    f, q, vt, va = len(text), ref.q, ref.vt, ref.va
    init = lambda v: np.full((1, q), v, np.int64)
    parts = (np.concatenate([conv.text[:hist], text, [vt]]),
             np.concatenate([conv.moshi[:hist], codes, init(va)]),
             np.concatenate([conv.user[: hist + f], init(va)]))
    tokens = R.positions(*(torch.from_numpy(np.asarray(x, np.int64)).to(device) for x in parts), vt, va)
    hs = ref.temporal(ref.embed(tokens[: hist + f])[None])[0, hist:]
    rows = tokens[hist + 1: hist + f + 1]
    return ref.text_logits(hs), torch.stack([ref.depth_logits(hs, rows[:, : k + 1]) for k in range(q)], 1)


def test_prefill_and_cached_decoding_match_the_full_forward(duplex, ref):
    conv, history, user, text, codes = _forced(duplex)
    lt, la = duplex.engine.teacher_forced(history, user, text, codes)
    rt, ra = _ref_logits(ref, conv, 7, text, codes)
    _close(lt, rt)  # step 0 from the prefill, steps 1.. through the temporal cache
    _close(la, ra)  # each codebook through the depformer's cache and its weight set
    assert float(rt.std()) > 1.0 and float(ra.std()) > 1.0  # logits that decide something


def test_depformer_takes_a_weight_set_per_step_and_a_fresh_cache(duplex, ref, monkeypatch):
    from sopro_tpu_torch.models import csm as C

    conv, history, user, text, codes = _forced(duplex, seed=3, frames=4)
    _, ra = _ref_logits(ref, conv, 7, text, codes)
    _, la = duplex.engine.teacher_forced(history, user, text, codes)
    _close(la, ra)
    assert duplex.engine.caches()[1].filled == Q  # the last frame's steps alone
    sets = duplex.engine.model.p["depth"]["layers"][0]["qkv"]
    assert sets.shape == (Q, 3 * 32, 32) and not torch.equal(sets[0], sets[1])
    orig = M.MoshiModel.depth_step
    with monkeypatch.context() as mp:  # every step through weight set 0 is caught
        mp.setattr(M.MoshiModel, "depth_step", lambda self, k, x, cache: orig(self, 0, x, cache))
        _, one = duplex.engine.teacher_forced(history, user, text, codes)
    assert torch.equal(one[:, 0], la[:, 0])
    for k in range(1, Q):
        assert float((one[:, k] - ra[:, k]).abs().max()) > 1e-2 * float(ra.abs().max())
    # the cache holds one frame's steps: one that kept the previous frame's
    # first position would overflow it
    monkeypatch.setattr(C.KVCache, "reset", lambda self: setattr(self, "filled", min(self.filled, 1)))
    with pytest.raises(ValueError, match="past the cache"):
        duplex.engine.teacher_forced(history, user, text, codes)


def test_acoustic_delay_and_initial_tokens():
    rng = np.random.default_rng(2)
    text = torch.from_numpy(rng.integers(0, VT, 4))
    moshi, user = (torch.from_numpy(rng.integers(0, VA, (4, Q))) for _ in range(2))
    seq = delay(text, moshi, user, VT, VA)
    assert seq.shape == (5, 1 + 2 * Q)
    assert seq[0].tolist() == [VT] + [VA] * 2 * Q  # position 0: all initial
    for col, codes in ((1, moshi), (1 + Q, user)):
        assert seq[1, col + 1: col + Q].tolist() == [VA] * (Q - 1)  # codebooks 1.. at position 1
        for p in range(1, 5):
            assert int(seq[p, 0]) == int(text[p - 1]) and int(seq[p, col]) == int(codes[p - 1, 0])
            if p >= 2:
                assert seq[p, col + 1: col + Q].tolist() == codes[p - 2, 1:].tolist()
    assert torch.equal(seq, R.positions(text, moshi, user, VT, VA))
    transformers = pytest.importorskip("transformers")
    # transformers' delay mask over the initial frame and the frames (its
    # codes [B, K, T]), with the same initial token for both ends
    for col, codes in ((1, moshi), (1 + Q, user)):
        ids = torch.cat([torch.full((1, Q), VA), codes]).t()[None]
        _, pattern = transformers.MoshiForConditionalGeneration.build_delay_pattern_mask(
            None, ids, bos_token_id=VA, pad_token_id=VA, max_length=6)
        assert torch.equal(pattern[0, :, :5].t(), seq[:, col: col + Q])


def test_sampler_noise_and_tokens_match_the_reference(duplex):
    nt, na = duplex.engine.noise(2 ** 31 + 99, 70)
    assert torch.equal(nt, R.call_noise(2 ** 31 + 99, 70, 0, 1, VT, "cpu")[:, 0])
    assert torch.equal(na, R.call_noise(2 ** 31 + 99, 70, 1, Q, VA, "cpu"))
    rng = np.random.default_rng(5)
    for g in range(0, 70, 7):
        for noise, k, temp in ((nt[g], 8, 0.7), (na[g, 1], 16, 0.8), (na[g, 2], VA, 1.3)):
            logits = torch.from_numpy(rng.standard_normal(noise.shape[0]).astype(np.float32) * 3)
            tok = S.sample_topk(logits[None], noise[None], temp, k)
            r = RC.sample(logits[None], noise[None], temp, k)
            assert int(tok) == int(r[0][0]) and float(r[1][0]) > 0


def test_converse_matches_the_reference(duplex, sds):
    conv, hist, frames, seed = _conversation(11), 7, 9, 2 ** 31 + 3
    history = duplex.prepare_history(conv.text[:hist], conv.moshi[:hist], conv.user[:hist])
    wav, text, codes = duplex.converse(history, conv.user[hist: hist + frames], max_frames=frames,
                                       seed=seed, **SAMPLING)
    assert wav.shape == (1, frames * duplex.hop_length) and text.shape == (frames,)
    assert codes.shape == (frames, Q)
    reference = FAM.Reference(*sds, CFG, Precision(), "cpu")
    checked = FAM.MoshiChecked(ids=np.zeros(hist), voice=0, ref_tokens=conv.moshi, seed=seed,
                               cap=frames, sampling=SAMPLING, chunks=[frames], wav=wav[0], conv=conv,
                               text_out=text, codes_out=codes)
    out = reference.run([checked])[0]
    assert out["frames"] == frames and float(np.min(out["gap"])) > 1e-4
    assert np.array_equal(out["text"].numpy(), text) and np.array_equal(out["codes"].numpy(), codes)
    _close(wav[0], out["wav"])
    again = duplex.converse(history, conv.user[hist: hist + frames], max_frames=frames, seed=seed,
                            **SAMPLING)
    assert len(again) == 3 and all(np.array_equal(a, b) for a, b in zip(again, (wav, text, codes)))


def test_a_differing_text_token_is_followed_and_forced(duplex, sds, monkeypatch):
    """A program that took another text token at step 3 (as at a near-tie)
    and went on from it: the reference, on its own tokens from there,
    differs in the audio of frame 3 or 4, and with that decision forced to
    the program's token it gives the program's codes again."""
    conv, hist, frames, seed = _conversation(13), 6, 8, 2 ** 31 + 5
    history = duplex.prepare_history(conv.text[:hist], conv.moshi[:hist], conv.user[:hist])
    call = lambda: duplex.converse(history, conv.user[hist: hist + frames], max_frames=frames,
                                   seed=seed, **SAMPLING)
    _, text, _ = call()
    noise = duplex.engine.noise

    def moved(seed, steps):
        nt, na = noise(seed, steps)
        nt[3, int(text[3])] = -1e9  # step 3's text token out of reach
        return nt, na
    monkeypatch.setattr(duplex.engine, "noise", moved)
    wav, other, codes = call()
    assert int(other[3]) != int(text[3]) and np.array_equal(other[:3], text[:3])
    reference = FAM.Reference(*sds, CFG, Precision(), "cpu")
    checked = FAM.MoshiChecked(ids=np.zeros(hist), voice=0, ref_tokens=conv.moshi, seed=seed,
                               cap=frames, sampling=SAMPLING, chunks=[frames], wav=wav[0], conv=conv,
                               text_out=other, codes_out=codes)
    out = reference.run([checked])[0]
    assert int(out["text"][3]) == int(text[3])
    differ = np.nonzero((out["codes"].numpy() != codes).any(1))[0]
    assert len(differ) and int(differ[0]) in (3, 4)
    out = reference.run([checked], [{"code": {(3, 0): int(other[3])}}])[0]
    assert np.array_equal(out["codes"].numpy(), codes) and np.array_equal(out["text"].numpy(), other)
    _close(wav[0], out["wav"])


def test_a_text_id_the_audio_does_not_show_is_unexplained(sds):
    """With the text embeddings zero, Moshi's text ids reach none of its
    audio: a program that reports another text id than it sampled, with its
    own audio, reads as a divergence no near-tie explains, at that frame."""
    from cudabench import check

    zero = ("decoder.model.embed_tokens.weight", "depth_decoder.text_embed_tokens.weight")
    moshi_sd = {k: np.zeros_like(v) if k in zero else v for k, v in sds[0].items()}
    duplex = FAM.build(CFG, (moshi_sd, sds[1]), "cpu", None)
    conv, hist, frames, seed = _conversation(31), 7, 6, 2 ** 31 + 21
    history = duplex.prepare_history(conv.text[:hist], conv.moshi[:hist], conv.user[:hist])
    wav, text, codes = duplex.converse(history, conv.user[hist: hist + frames], max_frames=frames,
                                       seed=seed, **SAMPLING)
    reference = FAM.Reference(moshi_sd, sds[1], CFG, Precision(), "cpu")

    def judged(text_out):
        checked = FAM.MoshiChecked(ids=np.zeros(hist), voice=0, ref_tokens=conv.moshi, seed=seed,
                                   cap=frames, sampling=SAMPLING, chunks=[frames], wav=wav[0],
                                   conv=conv, text_out=text_out, codes_out=codes)
        outs = reference.run([checked])
        return check.judge(reference, [checked], outs, 0.01, 1e-3, 4), outs[0]
    held, out = judged(text)
    assert held.unexplained == 0 and held.wave_err < 1e-5 and out["frames"] == frames
    wrong = text.copy()
    wrong[2] = (wrong[2] + 1) % VT
    held, out = judged(wrong)
    assert out["frames"] == 2 and held.unexplained == 1
    assert np.array_equal(out["codes"].numpy(), codes)  # the audio alone would read correct


def _stand_in_graphs(monkeypatch, eng):
    """The card's path on the CPU, each graph's capture standing in for
    itself (its replay runs the eager steps it would capture) -> the list
    of captures and the list of replays, one entry each."""
    from types import SimpleNamespace

    from sopro_tpu_torch import moshi_engine as E

    captures, replays = [], []

    def capture(run, device, pool=None):
        captures.append(1)
        return SimpleNamespace(replay=lambda: (replays.append(1), run()))
    monkeypatch.setattr(E, "capture", capture)
    monkeypatch.setattr(eng, "graphs", True)
    monkeypatch.setattr(eng, "_steps", None)
    monkeypatch.setattr(eng, "_depths", None)
    return captures, replays


def test_step_and_depth_graphs_and_the_profiler_fallback(duplex, monkeypatch):
    """The static buffers of `StepGraphs` (its position, row, noise and
    temperature) and `DepthGraph` in and out of `seq` around each replay
    give the eager path's tokens; while a profiler runs the steps stay
    eager."""
    from sopro_tpu_torch import moshi_engine as E

    eng = duplex.engine
    conv, frames = _conversation(21), 6
    history = duplex.prepare_history(conv.text[:7], conv.moshi[:7], conv.user[:7])
    call = lambda: duplex.converse(history, conv.user[7: 7 + frames], max_frames=frames,
                                   seed=2 ** 31 + 11, **SAMPLING)
    want = call()
    captures, replays = _stand_in_graphs(monkeypatch, eng)
    for n in (1, 2):  # captured at first use, replayed again
        got = call()
        assert len(replays) == 2 * frames * n  # steps 1..F: a temporal and a depformer replay each
        assert all(np.array_equal(a, b) for a, b in zip(want, got))
    assert len(captures) == 2 and sorted(eng._steps.graphs) == [E.attended(8, 128)]
    monkeypatch.setattr(E, "profiler_running", lambda: True)
    assert np.array_equal(call()[0], want[0]) and len(replays) == 4 * frames
    gc.disable()  # no reference cycle keeps the step graphs, and the model, alive
    try:
        graphs = E.StepGraphs(eng, 8)
        gone = weakref.ref(graphs)
        del graphs
        assert gone() is None
    finally:
        gc.enable()


def test_one_graph_set_serves_every_temperature_and_position(duplex, sds, monkeypatch):
    """Two temperatures and two histories far apart in the cache replay one
    set of graphs: one temporal graph per attended length (a multiple of
    `BUCKET`, here 8 positions) and one depformer graph, each call's tokens
    and waveform the eager path's and the reference's; another top-k makes
    the set anew in place of the old."""
    from sopro_tpu_torch import moshi_engine as E

    eng = duplex.engine
    monkeypatch.setattr(E, "BUCKET", 8)
    conv, frames = _conversation(23, n=60), 6
    calls = [(5, dict(SAMPLING)), (50, dict(SAMPLING, text_temperature=1.3, audio_temperature=0.6))]

    def run(hist, sampling, seed=2 ** 31 + 17):
        history = duplex.prepare_history(conv.text[:hist], conv.moshi[:hist], conv.user[:hist])
        return duplex.converse(history, conv.user[hist: hist + frames], max_frames=frames,
                               seed=seed, **sampling)
    want = [run(*c) for c in calls]
    assert not np.array_equal(want[0][1], want[1][1])
    captures, replays = _stand_in_graphs(monkeypatch, eng)
    for _ in range(2):
        for (hist, sampling), w in zip(calls, want):
            got = run(hist, sampling)
            assert all(np.array_equal(a, b) for a, b in zip(w, got))
    steps, depths = eng._steps, eng._depths
    # positions 6..11 and 51..56: lengths 8, 16, 56 and 64 of the 128
    assert sorted(steps.graphs) == [8, 16, 56, 64] and len(captures) == 4 + 1
    reference = FAM.Reference(*sds, CFG, Precision(), "cpu")
    hist, sampling = calls[1]
    _, text, codes = want[1]
    checked = FAM.MoshiChecked(ids=np.zeros(hist), voice=0, ref_tokens=conv.moshi, seed=2 ** 31 + 17,
                               cap=frames, sampling=sampling, chunks=[frames], wav=want[1][0][0],
                               conv=conv, text_out=text, codes_out=codes)
    out = reference.run([checked])[0]
    assert float(np.min(out["gap"])) > 1e-4 and np.array_equal(out["codes"].numpy(), codes)
    assert np.array_equal(out["text"].numpy(), text)
    _close(want[1][0][0], out["wav"])
    run(hist, dict(sampling, text_top_k=9))
    assert eng._steps is not steps and eng._depths is depths and sorted(eng._steps.graphs) == [56, 64]


def test_a_call_past_the_context_raises(duplex):
    conv = _conversation(1)
    history = duplex.prepare_history(conv.text[:7], conv.moshi[:7], conv.user[:7])
    with pytest.raises(ValueError, match="leaves room"):
        duplex.converse(history, np.zeros((121, Q), np.int64), max_frames=121)
    with pytest.raises(ValueError, match="user's codes"):
        duplex.converse(history, np.zeros((5, Q), np.int64), max_frames=6)


def test_hub_converter_and_snapshot(duplex, sds, tmp_path):
    moshi_sd, mimi_sd = sds
    cfg = M.MoshiConfig.from_dict(MOSHI)
    assert cfg.depth.max_position_embeddings == Q and cfg.temporal.rope_scaling is None
    assert cfg.temporal.intermediate_size == 64 and cfg.temporal.rms_norm_eps == 1e-8
    tree = H.moshi_params_from_flat(moshi_sd, cfg)
    lp, p = tree["temporal"]["layers"][1], "decoder.model.layers.1"
    assert np.array_equal(lp["qkv"], np.concatenate(
        [moshi_sd[f"{p}.self_attn.{x}_proj.linear.weight"] for x in "qkv"]))
    dp, p = tree["depth"]["layers"][0], "depth_decoder.layers.0"
    assert dp["qkv"].shape == (Q, 96, 32) and np.array_equal(
        dp["qkv"][2, 64:], moshi_sd[f"{p}.self_attn.v_proj.linear.weight"][2])
    assert np.array_equal(tree["audio_embed"][Q + 1], moshi_sd[f"embed_tokens.{Q + 1}.weight"])
    assert tree["depth_audio_embed"].shape == (Q - 1, VA + 1, 32) and "norm" not in tree["depth"]
    with pytest.raises(KeyError, match="lm_heads"):
        H.moshi_params_from_flat({k: v for k, v in moshi_sd.items() if "lm_heads" not in k}, cfg)
    flat = dict(moshi_sd, **{H.MOSHI_CODEC_PREFIX + k: v for k, v in mimi_sd.items()})
    H.write_safetensors(os.path.join(tmp_path, "model.safetensors"), flat)
    with open(os.path.join(tmp_path, "config.json"), "w") as f:
        json.dump(dict(MOSHI, audio_encoder_config=MIMI), f)
    loaded = MoshiDuplex.from_pretrained(str(tmp_path), device="cpu")
    assert loaded.cfg == duplex.cfg
    conv = _conversation(4)
    kw = dict(max_frames=4, seed=17, **SAMPLING)
    want = duplex.converse(duplex.prepare_history(conv.text[:5], conv.moshi[:5], conv.user[:5]),
                           conv.user[5:9], **kw)
    got = loaded.converse(loaded.prepare_history(conv.text[:5], conv.moshi[:5], conv.user[:5]),
                          conv.user[5:9], **kw)
    assert np.array_equal(want[0], got[0]) and np.array_equal(want[1], got[1])


def test_reference_matches_transformers(sds, ref):
    transformers = pytest.importorskip("transformers")
    moshi_sd = sds[0]
    hf_cfg = transformers.MoshiConfig(**{k: v for k, v in MOSHI.items() if k != "depth_decoder_config"},
                                      depth_decoder_config=dict(DEPTH),
                                      audio_encoder_config={"model_type": "mimi", **MIMI})
    hf_cfg._attn_implementation = "eager"
    hf_cfg.depth_decoder_config._attn_implementation = "eager"
    torch.manual_seed(0)
    model = transformers.MoshiForConditionalGeneration(hf_cfg).eval()
    missing, unexpected = model.load_state_dict({k: torch.from_numpy(v) for k, v in moshi_sd.items()},
                                                strict=False)
    assert not unexpected and all(k.startswith("audio_encoder.") for k in missing)

    rng = np.random.default_rng(1)
    tokens = R.positions(torch.from_numpy(rng.integers(0, VT, 8)),
                         torch.from_numpy(rng.integers(0, VA, (8, Q))),
                         torch.from_numpy(rng.integers(0, VA, (8, Q))), VT, VA)
    with torch.no_grad():
        embeds = model.decoder.model.embed_tokens(tokens[:, 0]) + sum(
            model.embed_tokens[i](tokens[:, 1 + i]) for i in range(2 * Q))
        out = model.decoder(inputs_embeds=embeds[None], attention_mask=torch.ones(1, 9),
                            use_cache=False)
        hs = out.last_hidden_state[0]
        depth = model.depth_decoder(input_ids=tokens[1:, : Q], last_hidden_state=hs[:-1, None],
                                    attention_mask=torch.ones(8, Q), use_cache=False).logits
        rh = ref.temporal(ref.embed(tokens)[None])[0]
        _close(rh, hs)
        _close(ref.text_logits(rh), out.logits[0])
        for k in range(Q):
            _close(ref.depth_logits(rh[:-1], tokens[1:, : k + 1]), depth[:, k])
    assert float(out.logits.std()) > 1.0 and float(depth.std()) > 1.0


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_teacher_forced_logits_at_published_widths(card):
    """moshiko at its published widths in float32 on the card: the program's
    text logits (the prefill, then the temporal cache) and depformer logits
    (each step through its cache and weight set), on its own sampled tokens
    of 2 calls of the benchmark cell's traffic (100 frames each), against
    the reference's full forward. Tolerance 1e-4 of the largest logit; the
    readings and the bfloat16 reference's are in PERF.md."""
    from cudabench.traffic import Traffic

    root = os.path.join(os.path.dirname(__file__), "..", "cudabench")
    with open(os.path.join(root, "configs", "moshiko-7b-fp32.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(root, "traffic", "moshi-duplex.json")) as f:
        mix = json.load(f)
    seed = 2 ** 31 + 77
    sds = CW.make(FAM.specs(cfg), seed, card)
    duplex = FAM.build(cfg, sds, card, None)
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    traffic = Traffic(mix, seed, 51, int(cfg["text_vocab"]))
    convs = FAM.voices(traffic, cfg)
    stream = traffic.clients[0]
    calls = []
    for s in (next(stream), next(stream)):
        conv, hist = convs[s.voice], len(s.ids)
        history = duplex.prepare_history(conv.text[:hist], conv.moshi[:hist], conv.user[:hist])
        user = conv.user[hist: hist + s.frames]
        _, text, codes = duplex.converse(history, user, max_frames=s.frames, seed=s.seed,
                                         **mix["sampling"])
        calls.append((conv, hist, text, codes,
                      [x.cpu() for x in duplex.engine.teacher_forced(history, user, text, codes)]))
    del duplex, history
    gc.collect()
    torch.cuda.empty_cache()
    for prec in (Precision(), Precision(torch.bfloat16)):
        ref = R.Moshi({k: torch.from_numpy(np.asarray(v)).to(card) for k, v in sds[0].items()},
                      cfg["moshi"], prec)
        for conv, hist, text, codes, (lt, la) in calls:
            with torch.inference_mode():
                rt, ra = (x.cpu() for x in _ref_logits(ref, conv, hist, text, codes, card))
            err = [float((a - b).abs().max() / b.abs().max()) for a, b in ((lt, rt), (la, ra))]
            print(f"teacher-forced logits, {prec.dtype}, error over the largest: text {err[0]:.3g} "
                  f"depformer {err[1]:.3g}")
            if prec.dtype == torch.float32:
                assert max(err) <= 1e-4
            else:
                assert min(err) > 1e-4
        del ref
        torch.cuda.empty_cache()

