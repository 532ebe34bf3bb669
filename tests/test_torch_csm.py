"""CSM on the port against its plain reference (`cudabench/reference/csm.py`)
on the CPU, with seeded random weights at a small size: the prefill and
the cached one-position decoding of both transformers against the
reference's full forward, the depth cache started afresh every frame, the
sampler's noise and tokens, a whole `CsmTTS.synthesize` call, the `hub`
converter and a snapshot, the shared RoPE helper's llama3 scaling, and the
reference itself against transformers' `CsmForConditionalGeneration`. On
the card (`cuda`): the depth passes' CUDA graph against the eager passes and
its rows in a trace, and the teacher-forced logits at the published widths.

Tolerances. Logits: 1e-5 of their largest magnitude. Both sides compute in
float32 with other kernels and orders (SDPA and fused norms against plain
matmul-softmax, a cache against the whole sequence), which over these few
layers moves a logit by a few ulps (~1e-7 of its scale); a bfloat16
computation would miss by ~1e-2. Waveforms: 1e-5 of their peak, the same
rounding through the Mimi decoder. Noise and tokens: exact (the same
Threefry bits; the sampled ids where no score gap is within 1e-4).
"""

import json
import os

import numpy as np
import pytest
import torch

from cudabench import weights as CW
from cudabench.families import csm as FAM
from cudabench.reference import csm as R
from cudabench.reference.precision import Precision
from sopro_tpu_torch import hub as H
from sopro_tpu_torch import sampling as S
from sopro_tpu_torch.codec.mimi_config import MimiConfig
from sopro_tpu_torch.csm import CsmTTS
from sopro_tpu_torch.models.csm import CsmConfig
from sopro_tpu_torch.ops.rope import inv_freq

ROPE = {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
        "original_max_position_embeddings": 64}
DEPTH = dict(num_codebooks=4, backbone_hidden_size=64, vocab_size=67, hidden_size=32,
             intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, head_dim=8, max_position_embeddings=5, rms_norm_eps=1e-5,
             rope_theta=500000.0, rope_scaling=ROPE, initializer_range=0.3)
# initializer_range 0.3: at these widths the published 0.02 leaves attention
# uniform and RoPE without effect, so a wrong position would pass
CSM = dict(num_codebooks=4, vocab_size=67, text_vocab_size=300, hidden_size=64,
           intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, head_dim=16, max_position_embeddings=256, rms_norm_eps=1e-5,
           rope_theta=500000.0, rope_scaling=ROPE, initializer_range=0.3,
           codebook_eos_token_id=0, depth_decoder_config=DEPTH)
MIMI = dict(sampling_rate=24000, hidden_size=32, num_filters=4, upsampling_ratios=[4, 3],
            codebook_size=67, codebook_dim=8, num_quantizers=4,
            vector_quantization_hidden_dimension=8, num_semantic_quantizers=1, upsample_groups=32,
            num_hidden_layers=2, intermediate_size=64, num_attention_heads=2,
            num_key_value_heads=2, head_dim=16, sliding_window=6, frame_rate=1000.0,
            audio_channels=1, num_residual_layers=1, kernel_size=7, last_kernel_size=3,
            residual_kernel_size=3, dilation_growth_rate=2, compress=2, norm_eps=1e-5,
            rope_theta=10000.0, layer_scale_initial_scale=0.01)
CFG = {"csm": CSM, "mimi": MIMI, "text_vocab": 300, "tokenizer": {"bos": 1, "eos": 2}}
SAMPLING = {"top_k": 5, "temperature": 0.9}


def _close(a, b, rel=1e-5):
    a, b = (torch.as_tensor(x.cpu() if torch.is_tensor(x) else np.asarray(x), dtype=torch.float64)
            for x in (a, b))
    assert float((a - b).abs().max()) <= rel * float(b.abs().max())


@pytest.fixture(scope="module")
def sds():
    csm_sd, mimi_sd = CW.make([FAM.csm_spec(CSM), CW.mimi_spec(MIMI)], 2 ** 31 + 7, "cpu")
    return csm_sd, mimi_sd


@pytest.fixture(scope="module")
def tts(sds):
    return CsmTTS.from_state_dicts(*sds, CsmConfig.from_dict(CSM), MimiConfig.from_dict(MIMI),
                                   device="cpu", tokenizer=FAM.SegmentTokenizer(_Seeded(), CFG))


@pytest.fixture(scope="module")
def ref(sds):
    return R.Csm({k: torch.from_numpy(v) for k, v in sds[0].items()}, CSM, Precision())


class _Seeded:

    def encode(self, text):
        return [(7 * b) % 300 for b in text.encode()]


def _prompt(seed=0, ref_frames=6, text=9):
    rng = np.random.default_rng(seed)
    voice = FAM.Voice(rng.integers(0, 67, (ref_frames, 4)),
                      FAM.segment_ids(rng.integers(0, 300, 5), CFG))
    ids = FAM.segment_ids(rng.integers(0, 300, text), CFG)
    return voice, ids


def _ref_logits(ref, tokens, mask, codes):
    """The reference's logits with every code given: its full forward over the
    sequence so far each frame, over positions 0..i each codebook."""
    q = codes.shape[1]
    x = ref.embed(tokens, mask)
    c0, depth = [], []
    row = torch.zeros(1, q + 1, dtype=torch.bool, device=tokens.device)
    row[0, :q] = True
    for f in range(codes.shape[0]):
        h, lg = ref.codebook0(x[None], [x.shape[0]])
        c0.append(lg[0])
        inputs = [h[0], ref.code_embed(0, codes[f, 0])]
        per = []
        for i in range(1, q):
            per.append(ref.codebook(i, torch.stack(inputs)[None])[0])
            inputs.append(ref.code_embed(i, codes[f, i]))
        depth.append(torch.stack(per))
        x = torch.cat([x, ref.embed(torch.cat([codes[f], codes[f, :1] * 0])[None], row)])
    return torch.stack(c0), torch.stack(depth)


def _forced(tts, seed=0, frames=5):
    voice, ids = _prompt(seed)
    eng = tts.engine
    tokens, mask = eng.prompt(ids, eng.prepare_reference(voice.transcript_ids, voice.codes))
    codes = torch.from_numpy(np.random.default_rng(seed + 1).integers(1, 67, (frames, 4)))
    return tokens, mask, codes


def test_prefill_and_cached_decoding_match_the_full_forward(tts, ref):
    tokens, mask, codes = _forced(tts)
    c0, depth = tts.engine.teacher_forced(tokens, mask, codes)
    r0, rd = _ref_logits(ref, tokens, mask, codes)
    _close(c0, r0)  # frame 0 from the prefill, frames 1.. through the backbone's cache
    _close(depth, rd)  # each codebook through the depth decoder's cache
    assert float(r0.std()) > 1.0 and float(rd.std()) > 1.0  # logits that decide something


def test_depth_cache_starts_afresh_every_frame(tts, ref, monkeypatch):
    from sopro_tpu_torch.models import csm as M

    tokens, mask, codes = _forced(tts, seed=3, frames=3)
    _, rd = _ref_logits(ref, tokens, mask, codes)
    _, depth = tts.engine.teacher_forced(tokens, mask, codes)
    _close(depth, rd)
    assert tts.engine.caches()[1].filled == 4  # positions 0..3 of the last frame alone
    # a cache that keeps the previous frame's first position is caught
    monkeypatch.setattr(M.KVCache, "reset", lambda self: setattr(self, "filled", min(self.filled, 1)))
    _, stale = tts.engine.teacher_forced(tokens, mask, codes)
    for f in range(3):
        assert float((stale[f] - rd[f]).abs().max()) > 1e-2 * float(rd.abs().max())


def test_sampler_noise_and_tokens_match_the_reference(tts):
    eng = tts.engine
    noise = eng.gumbel(2 ** 31 + 99, 70)  # past one Threefry block of frames
    for f in (0, 1, 63, 64, 69):
        assert torch.equal(noise[f], R.frame_noise([2 ** 31 + 99], f, 4, 67, "cpu")[0])
    rng = np.random.default_rng(5)
    for f in range(40):
        logits = torch.from_numpy(rng.standard_normal(67).astype(np.float32) * 3)
        for k, temp in ((5, 0.9), (50, 0.9), (67, 1.3)):
            tok = S.sample_topk(logits[None], noise[f, 1][None], temp, k)
            r = R.sample(logits[None], noise[f, 1][None], temp, k)
            assert int(tok) == int(r[0][0]) and float(r[1][0]) > 0


def test_synthesize_matches_the_reference(tts, sds):
    voice, _ = _prompt(seed=11)
    text, seed = "hello, twelve frames", 2 ** 31 + 3
    raw = tts.tokenizer.seeded.encode(text)
    assert tts.text_ids(text) == list(FAM.segment_ids(raw, CFG))  # "[0]text", framed
    reference = FAM.Reference(*sds, CFG, Precision(), "cpu")
    checked = FAM.CsmChecked(ids=np.asarray(raw), voice=0, ref_tokens=voice.codes, seed=seed,
                             cap=12, sampling=SAMPLING, chunks=[12], wav=np.zeros(0),
                             transcript_ids=voice.transcript_ids)
    out = reference.run([checked])[0]
    assert out["frames"] == 12 and float(np.min(out["gap"])) > 1e-4
    ref = tts.prepare_reference(ref_tokens_tq=voice.codes, transcript_ids=voice.transcript_ids)
    wav = tts.synthesize(text, ref=ref, max_frames=12, seed=seed, top_k=5, temperature=0.9)
    assert wav.shape == (1, 12 * tts.hop_length)
    _close(wav[0], out["wav"])
    eng = tts.engine
    codes, n = eng.generate(*eng.prompt(tts.text_ids(text), ref), max_frames=12, seed=seed,
                            temperature=0.9, top_k=5)
    ref_codes = torch.stack([x["codes"] for x in reference._runs[next(iter(reference._runs))][1]])
    assert n == 12 and torch.equal(codes, ref_codes)


def test_an_end_frame_ends_the_utterance(tts, monkeypatch):
    eng = tts.engine
    voice, ids = _prompt(seed=2)
    r = eng.prepare_reference(voice.transcript_ids, voice.codes)
    picks = iter(range(10 ** 6))
    # every code 0 from frame 2 on: frames 0 and 1 are the utterance
    monkeypatch.setattr(S, "sample_topk", lambda logits, g, t, k: torch.full(
        (1,), 0 if next(picks) >= 8 else 5, dtype=torch.int64))
    codes, n = eng.generate(*eng.prompt(ids, r), max_frames=12, seed=9, temperature=0.9, top_k=5)
    assert n == 8 and torch.equal(codes[2], torch.zeros(4, dtype=torch.int64))  # read at frame 8
    picks = iter(range(10 ** 6))
    wav, frames = eng.synthesize(ids, r, max_frames=12, seed=9, temperature=0.9, top_k=5)
    assert frames == 2 and wav.shape == (1, 2 * tts.hop_length)


def test_hub_converter_and_snapshot(tts, sds, tmp_path):
    csm_sd, mimi_sd = sds
    tree = H.csm_params_from_flat(csm_sd, CsmConfig.from_dict(CSM))
    lp = tree["backbone"]["layers"][1]
    p = "backbone_model.layers.1"
    assert np.array_equal(lp["qkv"], np.concatenate(
        [csm_sd[f"{p}.self_attn.{x}_proj.weight"] for x in "qkv"]))
    assert np.array_equal(lp["gate_up"][128:], csm_sd[f"{p}.mlp.up_proj.weight"])
    assert tree["heads"].shape == (3, 32, 67) and tree["depth"]["proj"].shape == (32, 64)
    # a checkpoint holding the tied table under both names, and one holding another
    both = dict(csm_sd, **{"depth_decoder.model.embed_tokens.weight":
                           csm_sd["backbone_model.embed_tokens.embed_audio_tokens.weight"]})
    H.csm_params_from_flat(both, CsmConfig.from_dict(CSM))
    with pytest.raises(ValueError):
        H.csm_params_from_flat(dict(both, **{"depth_decoder.model.embed_tokens.weight":
                                             np.zeros_like(both["depth_decoder.model.embed_tokens.weight"])}),
                               CsmConfig.from_dict(CSM))
    flat = dict(csm_sd, **{H.CSM_CODEC_PREFIX + k: v for k, v in mimi_sd.items()})
    H.write_safetensors(os.path.join(tmp_path, "model.safetensors"), flat)
    with open(os.path.join(tmp_path, "config.json"), "w") as f:
        json.dump(dict(CSM, codec_config=MIMI), f)
    loaded = CsmTTS.from_pretrained(str(tmp_path), device="cpu", tokenizer=tts.tokenizer)
    assert loaded.cfg == tts.cfg
    voice, _ = _prompt(seed=4)
    kw = dict(max_frames=4, seed=17, top_k=5)
    want = tts.synthesize("hi", ref=tts.prepare_reference(ref_tokens_tq=voice.codes, transcript="a"), **kw)
    got = loaded.synthesize("hi", ref=loaded.prepare_reference(ref_tokens_tq=voice.codes, transcript="a"), **kw)
    assert np.array_equal(want, got)


def test_llama3_rope_matches_transformers():
    rope = pytest.importorskip("transformers.modeling_rope_utils")
    from transformers import LlamaConfig

    for scaling in (ROPE, FAM_ROPE):
        cfg = LlamaConfig(hidden_size=2048, num_attention_heads=32, rope_theta=500000.0,
                          rope_scaling=dict(scaling), max_position_embeddings=2048)
        want, _ = rope.ROPE_INIT_FUNCTIONS["llama3"](cfg, "cpu")
        assert torch.equal(inv_freq(64, 500000.0, scaling), want)
        assert torch.equal(R.inv_freq(64, 500000.0, scaling, "cpu"), want)
    assert torch.equal(inv_freq(64, 500000.0, None), R.inv_freq(64, 500000.0, None, "cpu"))


FAM_ROPE = {"rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
            "high_freq_factor": 4.0, "original_max_position_embeddings": 8192}


def test_reference_matches_transformers(sds):
    transformers = pytest.importorskip("transformers")
    csm_sd = sds[0]
    hf_cfg = transformers.CsmConfig(
        **{k: v for k, v in CSM.items() if k != "depth_decoder_config"},
        depth_decoder_config=dict(DEPTH), tie_codebooks_embeddings=True,
        codec_config={"model_type": "mimi", **dict(MIMI, codebook_size=64)})  # unused here
    hf_cfg._attn_implementation = "eager"
    hf_cfg.depth_decoder_config._attn_implementation = "eager"
    torch.manual_seed(0)
    model = transformers.CsmForConditionalGeneration(hf_cfg).eval()
    sd = {k: torch.from_numpy(v) for k, v in csm_sd.items()}
    sd["depth_decoder.model.embed_tokens.weight"] = sd[
        "backbone_model.embed_tokens.embed_audio_tokens.weight"]
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert not unexpected and all(k.startswith("codec_model.") for k in missing)
    ref = R.Csm(sd, CSM, Precision())

    rng = np.random.default_rng(1)
    text = torch.from_numpy(rng.integers(0, 300, 7))
    frames = torch.from_numpy(rng.integers(0, 67, (5, 4)))
    with torch.no_grad():
        # text positions through the text table, audio positions through the summed audio table
        embeds = torch.cat([model.embed_text_tokens(text),
                            model.backbone_model.embed_tokens(frames[None])[0]])
        h = model.backbone_model(inputs_embeds=embeds[None]).last_hidden_state[0]
        hf_c0 = model.lm_head(h[-1])
        codes = torch.from_numpy(rng.integers(0, 67, 4))
        dd = model.depth_decoder(input_ids=torch.cat([codes[:1] * 0, codes[:3]])[None],
                                 backbone_last_hidden_state=h[-1][None]).logits[0]

    tokens = torch.zeros(12, 5, dtype=torch.int64)
    mask = torch.zeros(12, 5, dtype=torch.bool)
    tokens[:7, 4], mask[:7, 4] = text, True
    tokens[7:, :4], mask[7:, :4] = frames, True
    with torch.no_grad():
        rh, r0 = ref.codebook0(ref.embed(tokens, mask)[None], [12])
        _close(rh[0], h[-1])
        _close(r0[0], hf_c0)
        inputs = [rh[0]]
        for i in range(1, 4):
            inputs.append(ref.code_embed(i - 1, codes[i - 1]))
            _close(ref.codebook(i, torch.stack(inputs)[None])[0], dd[i - 1])


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_depth_graph_samples_as_the_eager_passes(sds, card):
    """On the card the depth passes run as one CUDA graph a frame, and
    eagerly under a profiler: the same codes either way. A graph replayed
    under a profiler in the calling thread reaches the trace as one graph
    launch and the same rows every time (`cudabench/spans_csm.py`)."""
    from cudabench import spans, spans_csm, trace
    from sopro_tpu_torch import csm_engine as E

    tts = CsmTTS.from_state_dicts(*sds, CsmConfig.from_dict(CSM), MimiConfig.from_dict(MIMI),
                                  device=card, tokenizer=FAM.SegmentTokenizer(_Seeded(), CFG))
    eng = tts.engine
    voice, ids = _prompt(seed=13)
    r = eng.prepare_reference(voice.transcript_ids, voice.codes)
    kw = dict(max_frames=20, seed=2 ** 31 + 5, temperature=0.9, top_k=5)
    graphed, n = eng.generate(*eng.prompt(ids, r), **kw)
    assert len(eng._graphs) == 1 and n == 20
    with torch.inference_mode():
        noise = eng.gumbel(kw["seed"], 20)
        eager, _ = eng._frames(*eng.prompt(ids, r), 20,
                               lambda f, i, x: S.sample_topk(x, noise[f, i: i + 1], 0.9, 5),
                               lambda c, f: False)
    assert torch.equal(graphed, eager)
    again, _ = eng.generate(*eng.prompt(ids, r), **kw)  # the graph replayed for a second call
    assert torch.equal(again, graphed) and len(eng._graphs) == 1
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        profiled, _ = eng.generate(*eng.prompt(ids, r), **kw)  # eager passes under a profiler
        torch.cuda.synchronize()
    assert torch.equal(profiled, graphed)
    graph = eng._graphs[(0.9, 5)]
    assert isinstance(graph, E.DepthGraph)
    with torch.inference_mode(), torch.profiler.profile(activities=acts) as prof:
        replayed, _ = eng._frames(*eng.prompt(ids, r), 20,
                                  lambda f, i, x: S.sample_topk(x, noise[f, i: i + 1], 0.9, 5),
                                  lambda c, f: False,
                                  lambda f, h, c, out: graph(h, c, noise[f], out))
        torch.cuda.synchronize()
    assert torch.equal(replayed, graphed)
    tr = trace.collect(prof)
    host = [n for _, n in sorted((a, n) for n, a, _ in tr["host"])
            if n.startswith(spans.WORK + spans_csm.GRAPH)]
    dev = [n for _, n in sorted((a, n) for n, a, *_ in tr["kernels"])]
    hk, dk = spans_csm._kinds(host), spans_csm._kinds(dev)
    replays = int((hk == spans_csm.REPLAY).sum())
    assert replays == 20
    rows, s = spans_csm.pairing(hk, dk)
    assert s == 0 and len(dk) == len(hk) - replays + replays * rows


@pytest.mark.cuda
def test_teacher_forced_logits_at_published_widths(card):
    """CSM-1B at its published widths in float32 on the card: the program's
    codebook-0 logits (the prefill, then the backbone's cache) and depth
    logits (the depth decoder's cache), on its own sampled codes of 2 calls
    of the benchmark cell's traffic (100 frames each), against the
    reference's full forward. Tolerance 1e-4 of the largest logit: on an
    H100 the program read 4.7e-6 - 6.0e-6 and the reference in bfloat16
    2.2e-2 - 3.4e-2, so the tolerance sits 16x above the one and 220x below
    the other."""
    from cudabench import run as harness
    from cudabench.traffic import Traffic

    with open(os.path.join(os.path.dirname(__file__), "..", "cudabench", "configs",
                           "csm-1b-fp32.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(os.path.dirname(__file__), "..", "cudabench", "traffic",
                           "csm-single.json")) as f:
        mix = json.load(f)
    seed = 2 ** 31 + 77
    sds = CW.make(FAM.specs(cfg), seed, card)
    tts = FAM.build(cfg, sds, card, harness.SeededTokenizer(int(cfg["text_vocab"])))
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    traffic = Traffic(mix, seed, 51, int(cfg["text_vocab"]))
    voices = FAM.voices(traffic, cfg)
    eng = tts.engine
    ref = R.Csm({k: torch.from_numpy(np.asarray(v)).to(card) for k, v in sds[0].items()},
                cfg["csm"], Precision())
    stream = traffic.clients[0]
    for s in (next(stream), next(stream)):
        v = voices[s.voice]
        tokens, mask = eng.prompt(FAM.segment_ids(s.ids, cfg),
                                  eng.prepare_reference(v.transcript_ids, v.codes))
        codes, _ = eng.generate(tokens, mask, max_frames=100, seed=s.seed,
                                temperature=mix["sampling"]["temperature"],
                                top_k=mix["sampling"]["top_k"])
        c0, depth = eng.teacher_forced(tokens, mask, codes)
        with torch.inference_mode():
            r0, rd = _ref_logits(ref, tokens, mask, codes)
        _close(c0, r0, rel=1e-4)
        _close(depth, rd, rel=1e-4)
