"""The slice under RuntimeConfig(compute_dtype="bfloat16") on the CPU (the
kernels' plain versions): every serving entry point gives float32 (or
pcm16) output of whole frames; a near-greedy request's AR tokens equal the
JAX package's (its K1 interpreted, in bfloat16) up to the first near-tie;
and the policy itself -- the cast, the dtypes accepted, checkpoints written
in float32 and read back under bfloat16, the training guard.

Bars: AR tokens equal up to the first step whose plain penalized top-2
margin is within 5e-2 of the peak logit (the two packages' conditioning
differs by up to 9.1e-3 of its peak in bfloat16, tests/test_torch_bf16_modules.py);
measured here: equal throughout.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from sopro_tpu.config import RuntimeConfig as JRuntime
from sopro_tpu.engine import Engine as JEngine
from sopro_tpu.tokenizer import SimpleCharTokenizer as JTok
from sopro_tpu.tts import SoproTTS as JTTS

from sopro_tpu_torch import hub as H
from sopro_tpu_torch import kernels
from sopro_tpu_torch import weights as W
from sopro_tpu_torch.codec.mimi_config import MimiConfig
from sopro_tpu_torch.config import RuntimeConfig, SoproTTSConfig
from sopro_tpu_torch.engine import Engine
from sopro_tpu_torch.ops.ar_loop import ARLoopContext
from sopro_tpu_torch.serve import ContinuousBatcher
from sopro_tpu_torch.tokenizer import SimpleCharTokenizer
from sopro_tpu_torch.tts import SoproTTS

from chip_smoke import first_divergence
from tests.test_torch_cuda import CFG, SMALL_MIMI, TRAIN_CFG
from tests.test_torch_ops import make_trees, to_jax
from tests.test_torch_streaming import audible_decoder

torch.set_num_threads(1)

BF16 = RuntimeConfig(compute_dtype="bfloat16")
MAX_FRAMES = 20
REF = np.random.default_rng(12).integers(0, 32, (40, 8)).astype(np.int32)


@pytest.fixture(scope="module")
def pair():
    """(JAX SoproTTS with K1 interpreted, port SoproTTS), both bfloat16, on
    the same small trees."""
    tree, mimi, jcfg, tcfg, jm, tm = make_trees(seed=6)
    audible_decoder(mimi)
    port = SoproTTS(Engine(W.sopro_params_from_jax(tree, tcfg, "cpu"),
                           W.mimi_params_from_jax(mimi, tm, "cpu"), BF16),
                    tcfg, SimpleCharTokenizer(), BF16)
    jrt = JRuntime(compute_dtype="bfloat16", use_pallas_resident=True)
    jtts = JTTS(JEngine(to_jax(tree), jcfg, to_jax(mimi), jm, jrt), jcfg, JTok(), jrt)
    return jtts, port


def _frames_ok(wav, hop, dtype=np.float32):
    assert wav.dtype == dtype and wav.ndim == 2 and wav.shape[0] == 1
    assert wav.shape[1] > 0 and wav.shape[1] % hop == 0
    assert np.isfinite(wav.astype(np.float32)).all()


def test_bf16_entry_points_run(pair):
    """synthesize (fused and adaptive, float32 and pcm16), synthesize_batch,
    synthesize_long and stream in bfloat16: float32 output of whole frames;
    the stream's chunks add up to the request's token count; nothing is
    launched on the CPU."""
    _, port = pair
    hop = port.engine.mimi_cfg.hop_length
    kw = dict(ref_tokens_tq=REF, max_frames=MAX_FRAMES, seed=3)
    kernels.reset_launches()
    for fused in (True, False):
        _frames_ok(port.synthesize("hello there", fused=fused, **kw), hop)
    _frames_ok(port.synthesize("hello there", pcm16=True, **kw), hop, np.int16)
    for wav in port.synthesize_batch(["hello there", "a second one"], ref_tokens_tq=REF,
                                     max_frames=MAX_FRAMES, seeds=[3, 4]):
        _frames_ok(wav, hop)
    _frames_ok(port.synthesize_long("One. Two is here. Three.", ref_tokens_tq=REF,
                                    max_frames=MAX_FRAMES, max_chars=12), hop)
    chunks = list(port.stream("hello there", chunk_frames=6, **kw))
    frames = len(port.generate_tokens("hello there", port.prepare_reference(ref_tokens_tq=REF),
                                      max_frames=MAX_FRAMES, seed=3))
    assert sum(c.shape[1] for c in chunks) == frames * hop
    for c in chunks:
        _frames_ok(c, hop)
    assert not any(kernels.LAUNCHES.values()) and not any(kernels.LAUNCHES_BF16.values())


def test_bf16_per_step_route_runs(pair):
    """The per-step route (K5's plain version) in bfloat16 gives the K1
    route's tokens at near-greedy settings (the same step)."""
    _, port = pair
    rt = RuntimeConfig(compute_dtype="bfloat16", use_pallas_ar=True, use_pallas_resident=False)
    step = SoproTTS(Engine(port.engine.model, port.engine.mimi, rt), port.cfg, port.tokenizer, rt)
    ref = port.prepare_reference(ref_tokens_tq=REF)
    kw = dict(max_frames=MAX_FRAMES, seed=5, temperature=1e-4, anti_loop=False)
    np.testing.assert_array_equal(step.generate_tokens("hello there", ref, **kw),
                                  port.generate_tokens("hello there", ref, **kw))


@pytest.mark.parametrize("text,seed", [("hello there", 3), ("a second, longer request", 5)])
def test_bf16_tokens_match_jax(pair, monkeypatch, text, seed):
    """A near-greedy request's AR tokens (codebook 1 of the token matrix)
    against JAX `generate_tokens` (its K1 in bfloat16, interpreted): equal
    up to the first near-tie of the port's own logits. The NAR ids after
    them differ where XLA's and torch's bfloat16 roundings tip a near-tie
    (tests/test_torch_bf16_modules.py holds them stage by stage)."""
    jtts, port = pair
    logits = []
    plain_step = ARLoopContext.step

    def recording_step(self, x, bufs):
        out = plain_step(self, x, bufs)
        logits.append(out[0].float())
        return out

    monkeypatch.setattr(ARLoopContext, "step", recording_step)
    kw = dict(max_frames=MAX_FRAMES, seed=seed, temperature=1e-4, anti_loop=False)
    want = jtts.generate_tokens(text, jtts.prepare_reference(ref_tokens_tq=REF), **kw)
    got = port.generate_tokens(text, port.prepare_reference(ref_tokens_tq=REF), **kw)
    n = min(len(got), len(want))
    assert n > 0
    first_divergence(torch.from_numpy(np.array(want[:n, 0]))[None], torch.from_numpy(got[:n, 0])[None],
                     logits, 0, "AR tokens against JAX's", tol=5e-2)


def test_bf16_continuous_batcher(pair):
    """Three sessions on two slots of the serving batcher in bfloat16: each
    session's waveform is float32 of whole frames and as long as its own
    `generate_tokens` says."""
    _, port = pair
    hop = port.engine.mimi_cfg.hop_length
    ref = port.prepare_reference(ref_tokens_tq=REF)
    b = ContinuousBatcher(port, slots=2, chunk_frames=4, text_bucket=16, max_frames=MAX_FRAMES)
    try:
        texts, seeds = ("alpha one", "beta two two", "gamma three"), (11, 22, 33)
        handles = [b.submit(t, ref, seed=s) for t, s in zip(texts, seeds)]
        outs = []
        for h in handles:
            chunks = []
            while (c := h.out.get(timeout=600)) is not None:
                chunks.append(c)
            assert h.error is None
            outs.append(np.concatenate(chunks, axis=1))
    finally:
        b.stop()
    for text, seed, wav in zip(texts, seeds, outs):
        _frames_ok(wav, hop)
        toks = port.generate_tokens(text, ref, max_frames=MAX_FRAMES, seed=seed)
        assert wav.shape[1] == len(toks) * hop


def test_bf16_batch_lengths_stay_exact_past_256_frames():
    """A bfloat16 batch of rows that run to 301 frames comes back 301
    frames long: the packed lengths travel in float32 (the JAX batch plan
    packs them in the waveform's bfloat16, where 301 rounds to 300,
    ROADMAP C7)."""
    cfg = SoproTTSConfig(**dict(CFG, pos_emb_max=512))
    tts = SoproTTS.from_random(cfg, mimi_cfg=MimiConfig(**SMALL_MIMI), device="cpu", runtime=BF16)
    with torch.no_grad():
        tts.engine.model.ar.p["head"]["b"][cfg.eos_id] = -1e9  # no row stops early
    wavs = tts.synthesize_batch(["hello there", "a second one"], ref_tokens_tq=REF,
                                max_frames=300, seeds=[1, 2])
    assert [w.shape[1] for w in wavs] == [301 * tts.engine.mimi_cfg.hop_length] * 2


def test_bf16_cast_covers_every_float_leaf():
    """Every floating parameter and buffer of the model and the codec is
    bfloat16 after the engine's cast, the small ones too (x-attn gates, NAR
    mixes, codebook weights); integer leaves keep their dtype; the kernel
    caches come from the cast weights."""
    tts = SoproTTS.from_random(SoproTTSConfig(**CFG), mimi_cfg=MimiConfig(**SMALL_MIMI),
                               device="cpu", runtime=BF16)
    model, mimi = tts.engine.model, tts.engine.mimi
    for mod in (model, mimi):
        for name, t in list(mod.named_parameters()) + list(mod.named_buffers()):
            if t.is_floating_point():
                assert t.dtype == torch.bfloat16, name
    p = model.shared.p
    for leaf in (p["ref_cb_weights"], p["nar_prev_cb_weights"], model.token2sv.p["cb_weights"],
                 *(m for m in model.nar.p["mix"].values()),
                 *(x["gate"] for x in model.ar.p["xattn"] if x is not None)):
        assert leaf.dtype == torch.bfloat16
    assert tts.engine.dtype == torch.bfloat16
    assert model.ar.stacked()["glu_w"].dtype == torch.bfloat16
    assert mimi.packed_decoder()["k3"][0]["hi"].dtype == torch.bfloat16


def test_bf16_engine_casts_a_copy():
    """A bfloat16 Engine casts copies, as the JAX engine casts into new
    arrays: the model and codec it was given stay float32, so a float32
    engine on them still computes in float32."""
    tree, mimi, _, tcfg, _, tm = make_trees(seed=6)
    model, codec = W.sopro_params_from_jax(tree, tcfg, "cpu"), W.mimi_params_from_jax(mimi, tm, "cpu")
    eng = Engine(model, codec, BF16)
    assert eng.model is not model and eng.mimi is not codec
    for mod in (model, codec):
        assert {t.dtype for t in mod.parameters() if t.is_floating_point()} == {torch.float32}
    assert {t.dtype for t in eng.model.parameters() if t.is_floating_point()} == {torch.bfloat16}
    assert Engine(model, codec).dtype == torch.float32


def test_bf16_dtypes_accepted_and_refused():
    """compute_dtype and param_dtype take "float32" and "bfloat16"; float16
    raises (the JAX package defines no float16 policy)."""
    for name in ("compute_dtype", "param_dtype"):
        assert getattr(RuntimeConfig(**{name: "bfloat16"}), name) == "bfloat16"
        with pytest.raises(ValueError, match=name):
            RuntimeConfig(**{name: "float16"})


def test_bf16_save_pretrained_writes_float32(tmp_path):
    """save_pretrained of a bfloat16 tts writes F32 tensors that equal the
    bfloat16 weights, as the JAX package's save does."""
    tts = SoproTTS.from_random(SoproTTSConfig(**CFG), mimi_cfg=MimiConfig(**SMALL_MIMI),
                               device="cpu", runtime=BF16)
    path = tts.save_pretrained(str(tmp_path / "sopro"))
    with open(path, "rb") as f:
        header, _ = H._read_header(f)
    assert {v["dtype"] for k, v in header.items() if k != "__metadata__"} == {"F32"}
    flat = H.load_flat_safetensors(path)
    want = H.sopro_params_to_flat(W.sopro_tree(tts.engine.model), tts.cfg)
    assert set(flat) == set(want)
    for k, v in want.items():
        assert np.array_equal(flat[k], v), k
        assert np.array_equal(v, torch.from_numpy(v).to(torch.bfloat16).float().numpy()), k


def test_bf16_from_pretrained_equals_from_random(tmp_path):
    """from_pretrained(runtime=bfloat16) of a snapshot of from_random's
    weights (the Sopro tree through save_pretrained, the Mimi tree in HF
    names) is the same bfloat16 model: equal weights and the same
    waveform."""
    import chip_smoke

    cfg, mcfg = SoproTTSConfig(**CFG), MimiConfig(**SMALL_MIMI)
    fresh = SoproTTS.from_random(cfg, seed=4, mimi_cfg=mcfg, device="cpu", runtime=BF16)
    sopro_dir, mimi_dir = str(tmp_path / "sopro"), str(tmp_path / "mimi")
    SoproTTS.from_random(cfg, seed=4, mimi_cfg=mcfg, device="cpu").save_pretrained(sopro_dir)
    os.makedirs(mimi_dir)
    H.write_safetensors(os.path.join(mimi_dir, "model.safetensors"),
                        chip_smoke.mimi_checkpoint_state_dict(W.init_mimi_params(4, mcfg), mcfg))
    with open(os.path.join(mimi_dir, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(mcfg), f)
    loaded = SoproTTS.from_pretrained(sopro_dir, mimi_repo_id=mimi_dir, runtime=BF16, device="cpu",
                                      tokenizer=SimpleCharTokenizer(), on_unconsumed="raise")
    for a, b in ((fresh.engine.model, loaded.engine.model), (fresh.engine.mimi, loaded.engine.mimi)):
        pa, pb = dict(a.named_parameters()), dict(b.named_parameters())
        assert set(pa) == set(pb)
        for k in pa:
            assert pb[k].dtype == pa[k].dtype and torch.equal(pa[k], pb[k]), k
    kw = dict(ref_tokens_tq=REF, max_frames=MAX_FRAMES, seed=2)
    np.testing.assert_array_equal(loaded.synthesize("hello there", **kw),
                                  fresh.synthesize("hello there", **kw))


def test_train_step_refuses_a_bf16_model():
    """The JAX training graph has no dtype policy: make_train_step on a
    model cast to bfloat16 raises ValueError."""
    from sopro_tpu_torch import train as T

    model = W.sopro_params_from_jax(W.init_sopro_params(0, SoproTTSConfig(**TRAIN_CFG), 64),
                                    SoproTTSConfig(**TRAIN_CFG), "cpu").to(torch.bfloat16)
    with pytest.raises(ValueError, match="float32"):
        T.make_train_step(model, T.make_optimizer(model))
