"""CSM on the port against its plain reference (`cudabench/reference/csm.py`)
on the CPU, with seeded random weights at a small size: the prefill and
the cached one-position decoding of both transformers against the
reference's full forward, the depth cache started afresh every frame, the
sampler's noise and tokens, a whole `CsmTTS.synthesize` call, the `hub`
converter and a snapshot, the shared RoPE helper's llama3 scaling, and the
reference itself against transformers' `CsmForConditionalGeneration`; the
depth wrapper (`ops/csm_depth.py`) and the backbone-step wrapper
(`ops/csm_backbone.py`) on CPU tensors, the widths kernels K6 and K7 take,
the heads held as rows. On the card (`cuda`): K6 and K7 against the eager
passes and step, run twice and under a profiler, K6's forced mode's picks and
logits, K7 at the published widths from a cache prefilled to ~300 and to
2,040 positions, and the teacher-forced logits at the published widths.

Tolerances. Logits: 1e-5 of their largest magnitude. Both sides compute in
float32 with other kernels and orders (SDPA and fused norms against plain
matmul-softmax, a cache against the whole sequence), which over these few
layers moves a logit by a few ulps (~1e-7 of its scale); a bfloat16
computation would miss by ~1e-2. Waveforms: 1e-5 of their peak, the same
rounding through the Mimi decoder. Noise and tokens: exact (the same
Threefry bits; the sampled ids where no score gap is within 1e-4).
"""

import dataclasses
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
from sopro_tpu_torch import kernels
from sopro_tpu_torch import sampling as S
from sopro_tpu_torch.codec.mimi_config import MimiConfig
from sopro_tpu_torch.csm import CsmTTS
from sopro_tpu_torch.models.csm import CsmConfig
from sopro_tpu_torch.ops import csm_backbone as K7
from sopro_tpu_torch.ops import csm_depth as K6
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


def _frame_inputs(tts, seed):
    """A backbone state h [1, D], codebook 0's code, a frame's noise [Q, V]
    and forced codes [Q - 1] on the engine's device."""
    eng, rng = tts.engine, np.random.default_rng(seed)
    dev, cfg = eng.device, eng.cfg
    h = torch.from_numpy(rng.standard_normal((1, cfg.backbone.hidden_size)).astype(np.float32)).to(dev)
    c0 = torch.tensor([int(rng.integers(1, cfg.vocab_size))], device=dev)
    forced = torch.from_numpy(rng.integers(1, cfg.vocab_size, cfg.num_codebooks - 1)).to(dev)
    return h, c0, eng.gumbel(2 ** 31 + seed, 1)[0], forced


def _eager_frame(eng, h, c0, noise=None, forced=None):
    """The eager passes (`_depth`) with `sample_topk` on `noise`, or fed
    `forced`: (codes [Q], logits [Q - 1, V])."""
    q = eng.cfg.num_codebooks
    out = torch.zeros(q, dtype=torch.int64, device=h.device)
    logits = []

    def pick(i, x):
        logits.append(x[0].clone())
        return S.sample_topk(x, noise[i: i + 1], 0.9, 5) if forced is None else forced[i - 1: i]
    eng._depth(h, c0, pick, out)
    return out, torch.stack(logits)


def test_depth_wrapper_on_cpu_tensors_takes_the_eager_passes(tts):
    """On CPU tensors `csm_depth` runs `_depth` with `sample_topk`: the same
    codes as the eager passes on the same noise; forced, the eager passes'
    logits, the forced codes fed forward and, with noise, `sample_topk`'s
    picks of those logits. Nothing counts as a K6 launch."""
    eng = tts.engine
    m, dc = eng.model, eng.caches()[1]
    kernels.reset_launches()
    with torch.inference_mode():
        for seed in (0, 1, 2):
            h, c0, noise, forced = _frame_inputs(tts, seed)
            want, _ = _eager_frame(eng, h, c0, noise=noise)
            got = torch.zeros_like(want)
            K6.csm_depth(m, dc, h, c0, got, noise=noise, temperature=0.9, top_k=5)
            assert torch.equal(got, want)
            fed, want_logits = _eager_frame(eng, h, c0, forced=forced)
            lg = torch.zeros_like(want_logits)
            out = torch.zeros_like(want)
            K6.csm_depth(m, dc, h, c0, out, forced=forced, logits=lg)
            assert torch.equal(lg, want_logits) and torch.equal(out, fed)
            assert torch.equal(out[1:], forced) and int(out[0]) == int(c0)
            K6.csm_depth(m, dc, h, c0, out, noise=noise, temperature=0.9, top_k=5, forced=forced,
                         logits=lg)
            assert torch.equal(lg, want_logits)
            picks = [int(S.sample_topk(lg[i - 1: i], noise[i: i + 1], 0.9, 5)) for i in range(1, 4)]
            assert out.tolist() == [int(c0)] + picks
            assert dc.filled == 4
        with pytest.raises(ValueError, match="noise, its forced codes"):
            K6.csm_depth(m, dc, h, c0, out)
    assert kernels.LAUNCHES["csm_depth"] == 0


def _widths(backbone=None, top=None, **depth):
    """CSM-1B's CsmConfig with depth-decoder fields, backbone fields or its
    own changed."""
    cfg = CsmConfig()
    return dataclasses.replace(cfg, depth=dataclasses.replace(cfg.depth, **depth),
                               backbone=dataclasses.replace(cfg.backbone, **(backbone or {})),
                               **(top or {}))


@pytest.mark.parametrize("cfg,top_k,why", [
    (_widths(), 50, None),
    (CsmConfig.from_dict(CSM), 5, None),
    (_widths(), 10 ** 6, None),  # past V: the whole vocabulary, as sample_topk
    (_widths(), 0, "top_k 0"),
    (_widths(head_dim=126), 50, "head_dim 126"),
    (_widths(hidden_size=1000), 50, "depth hidden_size 1000"),
    (_widths(hidden_size=2560, num_attention_heads=20, num_key_value_heads=4), 50,
     "depth hidden_size 2560"),
    (_widths(top={"vocab_size": 4100}), 50, "vocab_size 4100"),
    (_widths(intermediate_size=8704), 50, "depth intermediate_size 8704"),
    (_widths(intermediate_size=4096 + 4), 50, "depth intermediate_size 4100"),
    (_widths(backbone={"hidden_size": 24}), 50, "backbone hidden_size 24"),
    (_widths(num_hidden_layers=9), 50, "9 depth layers"),
    (_widths(num_attention_heads=8, num_key_value_heads=3), 50, "kv heads"),
    (_widths(top={"num_codebooks": 40}), 50, "40 codebooks"),
    (_widths(num_key_value_heads=8), 50, "bytes of shared memory"),
])
def test_k6_width_checks_name_what_they_refuse(cfg, top_k, why):
    """`widths_problem` is a pure function of the widths: None where K6
    takes them (CSM-1B, the toy config above), else what it refuses, which
    `check_widths` raises. CSM-1B's block fits the H100's shared memory."""
    got = K6.widths_problem(cfg, top_k)
    if why is None:
        assert got is None and K6.smem_bytes(cfg) <= K6.MAX_SMEM
        K6.check_widths(cfg, top_k)
    else:
        assert got is not None and why in got, got
        with pytest.raises(ValueError, match="csm_depth: "):
            K6.check_widths(cfg, top_k)
    assert K6.smem_bytes(CsmConfig()) == 227904 and K6.work_floats(CsmConfig()) == 23559


def test_packed_heads_give_the_same_logits(tts, sds):
    """The model holds the codebook heads as rows [Q - 1, V, d], as K6
    streams them: the converter's [Q - 1, d, V] (transformers' layout)
    transposed. Its `codebook_logits` equal each row dotted with the hidden
    state (in float64, in the kernel's row-by-row shape) and the product in
    transformers' layout."""
    m = tts.engine.model
    heads = torch.as_tensor(H.csm_params_from_flat(sds[0], CsmConfig.from_dict(CSM))["heads"])
    packed = m.p["heads"]
    assert packed.is_contiguous() and packed.shape == (3, 67, 32)
    assert torch.equal(packed.transpose(1, 2), heads)
    h = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 32)).astype(np.float32))
    for i in range(1, 4):
        rows = (packed[i - 1].double() * h.double()).sum(-1)
        _close(m.codebook_logits(i, h)[0], rows, rel=1e-6)
        _close(m.codebook_logits(i, h), h @ heads[i - 1], rel=1e-6)


def test_backbone_wrapper_on_cpu_tensors_takes_the_eager_step(tts):
    """On CPU tensors `csm_backbone` runs `step_plain`: the eager step
    (`embed_frame`, `backbone` at one position, `codebook0_logits`) and
    `sample_topk` on codebook 0's noise, bit for bit: the same h, logits,
    code and cache rows; forced, the given code with the same logits. It
    takes exactly one of noise and a forced code. Nothing counts as a K7
    launch."""
    eng = tts.engine
    m, bc = eng.model, eng.caches()[0]
    kernels.reset_launches()
    rng = np.random.default_rng(8)
    with torch.inference_mode():
        bc.reset()
        m.backbone(torch.from_numpy(rng.standard_normal((20, 64)).astype(np.float32)), bc)
        k, v = bc.k.clone(), bc.v.clone()
        noise = eng.gumbel(2 ** 31 + 8, 3)
        for f in range(3):
            prev = torch.from_numpy(rng.integers(0, 67, 4))
            bc.filled = 20 + f
            want_h = m.backbone(m.embed_frame(prev), bc)
            want_lg = m.codebook0_logits(want_h)
            want_c = S.sample_topk(want_lg, noise[f, :1], 0.9, 5)
            want_k, want_v = bc.k.clone(), bc.v.clone()
            for forced in (None, torch.tensor([f + 3])):
                bc.k.copy_(k), bc.v.copy_(v)
                bc.filled = 20 + f
                h, c, lg = torch.zeros(1, 64), torch.zeros(1, dtype=torch.int64), torch.zeros(67)
                kw = dict(noise=noise[f, 0], temperature=0.9, top_k=5) if forced is None else dict(forced=forced)
                K7.csm_backbone(m, bc, prev, h, c, logits=lg, **kw)
                assert bc.filled == 21 + f
                assert torch.equal(h, want_h) and torch.equal(lg, want_lg[0])
                assert torch.equal(c, want_c if forced is None else forced)
                assert torch.equal(bc.k, want_k) and torch.equal(bc.v, want_v)
            k, v = want_k, want_v
        for kw in ({}, dict(noise=noise[0, 0], forced=torch.tensor([1]))):
            with pytest.raises(ValueError, match="one of the two"):
                K7.csm_backbone(m, bc, prev, h, c, **kw)
    assert kernels.LAUNCHES["csm_backbone"] == 0


@pytest.mark.parametrize("cfg,top_k,why", [
    (_widths(), 50, None),
    (CsmConfig.from_dict(CSM), 5, None),
    (_widths(), 10 ** 6, None),  # past V: the whole vocabulary, as sample_topk
    (_widths(), 0, "top_k 0"),
    (_widths(backbone={"head_dim": 126}), 50, "head_dim 126"),
    (_widths(backbone={"head_dim": 128, "num_attention_heads": 16, "num_key_value_heads": 4}), 50,
     "head_dim 128"),
    (_widths(backbone={"hidden_size": 5120}), 50, "backbone hidden_size 5120"),
    (_widths(backbone={"hidden_size": 24}), 50, "backbone hidden_size 24"),
    (_widths(backbone={"intermediate_size": 8704}), 50, "backbone intermediate_size 8704"),
    (_widths(backbone={"intermediate_size": 4100}), 50, "backbone intermediate_size 4100"),
    (_widths(backbone={"num_hidden_layers": 33}), 50, "33 backbone layers"),
    (_widths(backbone={"num_key_value_heads": 3}), 50, "kv heads"),
    (_widths(top={"num_codebooks": 65}), 50, "65 codebooks"),
    (_widths(top={"vocab_size": 4100}), 50, "vocab_size 4100"),
    (_widths(backbone={"max_position_embeddings": 2049}), 50, "a cache of 2049 positions"),
    (_widths(backbone={"num_key_value_heads": 1}), 50, "bytes of shared memory"),
])
def test_k7_width_checks_name_what_they_refuse(cfg, top_k, why):
    """K7's `widths_problem` is a pure function of the widths and the
    cache's positions (the backbone's max_position_embeddings here): None
    where K7 takes them (CSM-1B, the toy config above), else what it
    refuses, which `check_widths` raises. CSM-1B's block fits the H100's
    shared memory."""
    got = K7.widths_problem(cfg, top_k)
    if why is None:
        assert got is None and K7.smem_bytes(cfg) <= K7.MAX_SMEM
        K7.check_widths(cfg, top_k)
    else:
        assert got is not None and why in got, got
        with pytest.raises(ValueError, match="csm_backbone: "):
            K7.check_widths(cfg, top_k)
    assert K7.smem_bytes(CsmConfig()) == 221432 and K7.work_floats(CsmConfig(), 2048) == 85068


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_tts(sds, card):
    return CsmTTS.from_state_dicts(*sds, CsmConfig.from_dict(CSM), MimiConfig.from_dict(MIMI),
                                   device=card, tokenizer=FAM.SegmentTokenizer(_Seeded(), CFG))


@pytest.mark.cuda
def test_k6_samples_as_the_eager_passes(sds, card):
    """On the card each frame's depth passes are one K6 launch and each
    backbone step after the prefill one K7 launch. Their codes equal the
    eager passes' and step's (`_depth`, `step_plain`: cuBLAS, SDPA,
    `sample_topk`) on the same noise up to the first near-tied decision (a
    kept top-two score gap, or the top-k edge's margin, under 1e-4: float32
    sums in another order may resolve it either way). Two calls, and one
    under torch.profiler, give the same codes bit for bit; the profiled one
    shows one K6 launch in each `csm.depth` span, one K7 launch in each
    `csm.backbone` span and nothing else launched there (no cuBLAS or SDPA
    row), and one K6 row a frame and one K7 row a frame after the first on
    the card."""
    from cudabench import trace
    from sopro_tpu_torch.ops.csm_backbone import step_plain

    tts = _card_tts(sds, card)
    eng = tts.engine
    voice, ids = _prompt(seed=13)
    r = eng.prepare_reference(voice.transcript_ids, voice.codes)
    kw = dict(max_frames=20, seed=2 ** 31 + 5, temperature=0.9, top_k=5)
    kernels.reset_launches()
    k6, n = eng.generate(*eng.prompt(ids, r), **kw)
    assert n == 20 and kernels.LAUNCHES["csm_depth"] == n and kernels.LAUNCHES["csm_backbone"] == n - 1
    near = []
    with torch.inference_mode():
        noise = eng.gumbel(kw["seed"], 20)

        def pick(f, i, x):
            _, gap, _, margin, _ = R.sample(x, noise[f, i: i + 1], 0.9, 5)
            near.append(min(float(gap[0]), float(margin[0])) < 1e-4)
            return S.sample_topk(x, noise[f, i: i + 1], 0.9, 5)

        def step(f, prev, h, c):
            lg = torch.zeros(eng.cfg.vocab_size, device=card)
            step_plain(eng.model, eng.caches()[0], prev, h, c, noise=noise[f, 0], temperature=0.9, top_k=5,
                       logits=lg)
            pick(f, 0, lg[None])
        eager, _ = eng._frames(*eng.prompt(ids, r), 20, lambda x: pick(0, 0, x), lambda c, f: False, step,
                               lambda f, h, c, out: eng._depth(h, c, lambda i, x: pick(f, i, x), out))
    first = near.index(True) if True in near else len(near)
    assert first > 0 and torch.equal(k6.flatten()[:first], eager.flatten()[:first]), (first, near)
    again, _ = eng.generate(*eng.prompt(ids, r), **kw)
    assert torch.equal(again, k6)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    kernels.reset_launches()
    with torch.profiler.profile(activities=acts) as prof:
        profiled, _ = eng.generate(*eng.prompt(ids, r), **kw)
        torch.cuda.synchronize()
    assert torch.equal(profiled, k6) and kernels.LAUNCHES["csm_depth"] == 20
    assert kernels.LAUNCHES["csm_backbone"] == 19
    tr = trace.collect(prof)
    for span_name, count in (("csm.depth", 20), ("csm.backbone", 19)):
        spans = [(a, b) for name, a, b in tr["host"] if name == span_name]
        assert len(spans) == count
        for a, b in spans:
            inside = [name for name, x, _ in tr["host"] if a < x < b]
            launches = [x for x in inside if x.startswith(("cudaLaunchKernel", "cuLaunchKernel"))]
            assert len(launches) == 1, inside
            assert not [x for x in inside if any(w in x.lower() for w in
                                                  ("mm", "gemv", "cublas", "scaled_dot", "attention"))]
    for kernel, count in (("csm_depth_kernel", 20), ("csm_backbone_kernel", 19)):
        rows = [name for name, *_ in tr["kernels"] if kernel in name]
        assert len(rows) == count, sorted({name for name, *_ in tr["kernels"]})


@pytest.mark.cuda
@pytest.mark.parametrize("positions", [300, 2040])
def test_k7_steps_as_the_eager_step_at_published_widths(card, positions):
    """K7 at CSM-1B's widths (the backbone's weights, the audio table and
    `lm_head` drawn from a seed, `bench_csm.csm_model`) over 8 steps from a
    backbone cache prefilled eagerly to `positions` (the cell's prompts,
    and the cache's end), against `step_plain` on the same codes and noise:
    codebook-0 logits (forced) within 1e-4 of their peak, likewise the
    final norm's output and the cache rows the steps write; picks equal up
    to the first near-tie, and equal to `sample_topk` of K7's own logits;
    a second run equal bit for bit (`bench_csm.backbone_record`). On an H100
    the errors read 1.8e-6 - 2.8e-6 of the peak."""
    from sopro_tpu_torch import bench_csm as BC

    model = BC.csm_model(CsmConfig(), card, 23)
    rec = BC.backbone_record(model, positions, 0, 1, 29)
    print("K7 at", positions, "positions:", rec)
    assert rec["picks_equal"] and rec["picks_equal_until"] > 0, rec
    assert rec["picks_are_sample_topk"] and rec["repeats"], rec
    for key in ("forced_logits_rel_err", "h_rel_err", "cache_rel_err"):
        assert rec[key] <= 1e-4, rec


@pytest.mark.cuda
def test_k6_forced_picks_are_sample_topk_of_its_logits(sds, card):
    """K6 forced (teacher forcing, with the frame's noise): its logits are
    the eager forced passes' within 1e-5 of their peak, repeat bit for bit,
    and its picks are `sample_topk` of its own logits on the same noise, bit
    for bit (on the CPU, whose division by the temperature is IEEE's, as
    K6's). The shared memory it launches with is `smem_bytes`'s. CUDA
    tensors without the engine's `DepthKernel` raise."""
    tts = _card_tts(sds, card)
    eng = tts.engine
    m, dc, kernel = eng.model, eng.caches()[1], eng.depth_kernel()
    assert kernel._args.Q == 4
    with torch.inference_mode():
        for seed in range(6):
            h, c0, noise, forced = _frame_inputs(tts, seed)
            _, want = _eager_frame(eng, h, c0, forced=forced)
            out = torch.zeros(4, dtype=torch.int64, device=card)
            lg = torch.zeros_like(want)
            K6.csm_depth(m, dc, h, c0, out, noise=noise, temperature=0.9, top_k=5, forced=forced,
                         logits=lg, kernel=kernel)
            _close(lg, want)
            out2, lg2 = torch.zeros_like(out), torch.zeros_like(lg)
            K6.csm_depth(m, dc, h, c0, out2, noise=noise, temperature=0.9, top_k=5, forced=forced,
                         logits=lg2, kernel=kernel)
            assert torch.equal(out2, out) and torch.equal(lg2, lg)
            picks = [int(S.sample_topk(lg[i - 1: i].cpu(), noise[i: i + 1].cpu(), 0.9, 5))
                     for i in range(1, 4)]
            assert out.tolist() == [int(c0)] + picks
            fed = torch.zeros_like(out)
            K6.csm_depth(m, dc, h, c0, fed, forced=forced, kernel=kernel)
            assert fed.tolist() == [int(c0)] + forced.tolist()
        with pytest.raises(ValueError, match="need `kernel`"):
            K6.csm_depth(m, dc, h, c0, fed, forced=forced)


@pytest.mark.cuda
def test_teacher_forced_logits_at_published_widths(card):
    """CSM-1B at its published widths in float32 on the card: the program's
    codebook-0 logits (the prefill, then the backbone's cache) and depth
    logits (K6 in forced mode), on its own sampled codes of 2 calls of the
    benchmark cell's traffic (100 frames each), against the reference's
    full forward. Tolerance 1e-4 of the largest logit: on an H100 the
    program read 4.3e-6 - 6.7e-6 and the reference in bfloat16 2.2e-2 -
    3.4e-2, so the tolerance sits 15x above the one and 220x below the
    other."""
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
        print("teacher-forced logits, error over the largest: codebook 0",
              float((c0 - r0).abs().max() / r0.abs().max()), "depth",
              float((depth - rd).abs().max() / rd.abs().max()))
        _close(c0, r0, rel=1e-4)
        _close(depth, rd, rel=1e-4)
