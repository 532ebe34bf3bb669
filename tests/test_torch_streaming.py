"""The port's streaming path against the JAX package on the CPU: the stream
conv primitives, `mimi_decode_step` on both SEANet routes, kernel K4's plain
version against the Pallas chunk kernel in interpret mode, NAR `head_tail`,
and `stream()` chunk by chunk; plus the last-chunk window of a max-length
stream, where the JAX package clamps its window start.

Tolerances: waveforms within 1e-4 of their peak (fp32 stacks summed in a
different order), ids and tokens exact. The Mimi decoder's weights are
rescaled (`audible_decoder`) so that waveforms follow the tokens: at the
init's N(0, 0.02) they are ~1e-6 in size and the conv biases set them.

The JAX package streams through its per-conv SEANet route on the CPU, the
port through the packed route (K4's plain version over [emb_hist ++
chunk], the history rows before the stream's start dropped), so every
comparison of a stream also holds the two routes against each other, with
the decoder's conv biases filled.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sopro_tpu.codec import streaming as JS
from sopro_tpu.codec.convert import init_mimi_params as j_init_mimi
from sopro_tpu.codec.mimi_config import MimiConfig as JMimiCfg
from sopro_tpu.codec.pallas_vocoder import pack_seanet_decoder as j_pack, seanet_decode_pallas_chunk
from sopro_tpu.engine import Engine as JEngine
from sopro_tpu.models import sopro as JM
from sopro_tpu.streaming import SoproTTSStreamer as JStreamer, StreamConfig as JStreamConfig
from sopro_tpu.tokenizer import SimpleCharTokenizer as JTok
from sopro_tpu.tts import SoproTTS as JTTS

from sopro_tpu_torch import kernels
from sopro_tpu_torch import weights as W
from sopro_tpu_torch.codec import streaming as TS
from sopro_tpu_torch.codec.mimi_config import MimiConfig, required_halo
from sopro_tpu_torch.codec.vocoder import pack_seanet_decoder, seanet_decode_chunk
from sopro_tpu_torch.engine import Engine
from sopro_tpu_torch.models import sopro as M
from sopro_tpu_torch.streaming import SoproTTSStreamer, StreamConfig
from sopro_tpu_torch.tokenizer import SimpleCharTokenizer
from sopro_tpu_torch.tts import SoproTTS

from tests.test_torch_ops import STACK_TOL, close, make_trees, t2n, to_jax

torch.set_num_threads(1)

TEXT = "hello there"
REF = np.random.default_rng(12).integers(0, 32, (40, 8)).astype(np.int32)


def peak_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=STACK_TOL * float(np.abs(want).max()))


def audible_decoder(mimi) -> None:
    """Rescale the upsampler's and the SEANet decoder's N(0, 0.02) weights
    to std 1/sqrt(fan-in), so the waveform follows the codes (a few tenths
    in size) instead of the filled conv biases."""
    def rescale(p):
        if isinstance(p, list):
            for v in p:
                rescale(v)
        elif isinstance(p, dict):
            if "w" in p:
                p["w"] = p["w"] / (0.02 * np.sqrt(np.prod(p["w"].shape[:-1])))
            for v in p.values():
                if isinstance(v, (dict, list)):
                    rescale(v)

    rescale(mimi["upsample"])
    rescale(mimi["decoder"])


def build_pair(seed=6, eos_bias=None):
    """(JAX SoproTTS, port SoproTTS) on the same small trees."""
    tree, mimi, jcfg, tcfg, jm, tm = make_trees(seed=seed)
    audible_decoder(mimi)
    if eos_bias is not None:
        tree["ar"]["head"]["b"][tcfg.eos_id] = eos_bias
    port = SoproTTS(Engine(W.sopro_params_from_jax(tree, tcfg, "cpu"),
                           W.mimi_params_from_jax(mimi, tm, "cpu")), tcfg, SimpleCharTokenizer())
    jtts = JTTS(JEngine(to_jax(tree), jcfg, to_jax(mimi), jm), jcfg, JTok())
    return jtts, port


@pytest.fixture(scope="module")
def pair():
    return build_pair()


@pytest.fixture(scope="module")
def mimi_trees():
    """(numpy Mimi tree with filled biases, JAX cfg, port cfg)."""
    _, mimi, _, _, jm, tm = make_trees()
    audible_decoder(mimi)
    return mimi, jm, tm


# --------------------------------------------------------------------------
# stream primitives and mimi_decode_step
# --------------------------------------------------------------------------


@pytest.mark.parametrize("spec", [
    {"in": 6, "out": 4, "k": 4, "stride": 2, "groups": 1},  # dense polyphase
    {"in": 6, "out": 6, "k": 6, "stride": 3, "groups": 6},  # depthwise polyphase
    {"in": 6, "out": 4, "k": 5, "stride": 2, "groups": 2},  # generic transpose conv
])
def test_stream_convt_matches_jax(spec):
    rng = np.random.default_rng(spec["k"])
    p = {"w": rng.standard_normal((spec["k"], spec["in"] // spec["groups"], spec["out"])).astype(np.float32),
         "b": rng.standard_normal(spec["out"]).astype(np.float32)}
    x = rng.standard_normal((2, 7, spec["in"])).astype(np.float32)
    jp, tp = to_jax(p), W.to_torch(p, "cpu")
    jc = jnp.zeros((2, spec["k"] - spec["stride"], spec["out"]))
    tc = torch.zeros(2, spec["k"] - spec["stride"], spec["out"])
    for lo, hi in ((0, 3), (3, 5), (5, 7)):  # a chunk must cover the overlap k - s
        jy, jc = JS.stream_convt(jp, jnp.asarray(x[:, lo:hi]), jc, spec)
        ty, tc = TS.stream_convt(tp, torch.from_numpy(x[:, lo:hi]), tc, spec)
        close(t2n(ty), jy)
        close(t2n(tc), jc)


def test_stream_conv_matches_jax():
    rng = np.random.default_rng(3)
    spec = {"in": 5, "out": 3, "k": 3, "stride": 1, "dilation": 2}
    p = {"w": rng.standard_normal((3, 5, 3)).astype(np.float32),
         "b": rng.standard_normal(3).astype(np.float32)}
    x = rng.standard_normal((2, 9, 5)).astype(np.float32)
    jc, tc = jnp.zeros((2, 4, 5)), torch.zeros(2, 4, 5)
    for lo, hi in ((0, 2), (2, 7), (7, 9)):
        jy, jc = JS.stream_conv(to_jax(p), jnp.asarray(x[:, lo:hi]), jc, spec)
        ty, tc = TS.stream_conv(W.to_torch(p, "cpu"), torch.from_numpy(x[:, lo:hi]), tc, spec)
        close(t2n(ty), jy)
        close(t2n(tc), jc)


def _leaves(state):
    return [x for leaf in state for x in (leaf if isinstance(leaf, tuple) else (leaf,))]


def _state_close(tstate, jstate, skip=()):
    for name, t, j in zip(TS.MimiStreamState._fields, tstate, jstate):
        if name in skip:
            continue
        pairs = zip(t, j) if isinstance(t, tuple) else [(t, j)]
        for a, b in pairs:
            if a.dtype in (torch.int32, torch.int64):
                np.testing.assert_array_equal(t2n(a), np.asarray(b), err_msg=name)
            else:
                close(t2n(a), b, STACK_TOL)


@pytest.mark.parametrize("route", ["per_conv", "packed"])
def test_mimi_decode_step_matches_jax(mimi_trees, route):
    """Chunk by chunk (chunk sizes 3, 1, 4: a size change, a history of 6
    real rows of the 9-row halo, and a chunk of 8 tokens past the 6-slot
    sliding window), B=2, the second row frozen in the middle chunk:
    waveforms and every state leaf against the JAX package's per-conv
    route."""
    tree, jm, tm = mimi_trees
    jp = to_jax(tree)
    codec = W.mimi_params_from_jax(tree, tm, "cpu")
    packed = codec.packed_decoder() if route == "packed" else None
    codes = np.random.default_rng(4).integers(0, 32, (2, 8, 8)).astype(np.int32)
    js, ts = JS.init_mimi_stream_state(jm, 2), TS.init_mimi_stream_state(tm, 2, "cpu")
    _state_close(ts, js)
    lo = 0
    for n, mask in ((3, None), (1, [True, False]), (4, None)):
        jmask = None if mask is None else jnp.asarray(mask)
        tmask = None if mask is None else torch.tensor(mask)
        chunk = codes[:, lo: lo + n]
        jw, js_new = JS.mimi_decode_step(jp, jm, jnp.asarray(chunk), js, mask=jmask)
        tw, ts_new = TS.mimi_decode_step(codec.p, tm, torch.from_numpy(chunk), ts,
                                         mask=tmask, packed=packed)
        assert tw.shape == (2, n * tm.hop_length)
        rows = slice(None) if mask is None else slice(0, 1)
        peak_close(t2n(tw)[rows], np.asarray(jw)[rows])
        if route == "packed":  # the per-conv caches stay as they were
            assert not any(c.any() for c in ts_new.conv_caches)
            _state_close(ts_new, js_new, skip=("conv_caches",))
        else:
            _state_close(ts_new, js_new)
        if mask is not None:
            for new, old in zip(_leaves(ts_new), _leaves(ts)):
                assert torch.equal(new[1], old[1])
        js, ts = js_new, ts_new
        lo += n


def test_reset_stream_rows_matches_jax(mimi_trees):
    filled, jm, tm = mimi_trees
    codec = W.mimi_params_from_jax(filled, tm, "cpu")
    codes = np.random.default_rng(5).integers(0, 32, (2, 3, 8)).astype(np.int32)
    _, js = JS.mimi_decode_step(to_jax(filled), jm, jnp.asarray(codes), JS.init_mimi_stream_state(jm, 2))
    _, ts = TS.mimi_decode_step(codec.p, tm, torch.from_numpy(codes), TS.init_mimi_stream_state(tm, 2, "cpu"))
    rows = np.array([False, True])
    _state_close(TS.reset_stream_rows(ts, torch.from_numpy(rows)),
                 JS.reset_stream_rows(js, jnp.asarray(rows)))


# --------------------------------------------------------------------------
# kernel K4's plain version against the Pallas chunk kernel
# --------------------------------------------------------------------------

# the smallest Mimi the TPU kernel takes: 2 * num_filters fills 128 lanes,
# four upsampling stages of the production ratios; the rest tiny
PALLAS_MIMI = dict(
    hidden_size=32, num_filters=64, codebook_size=16, codebook_dim=8, num_quantizers=2,
    vector_quantization_hidden_dimension=8, upsample_groups=32, num_hidden_layers=1,
    intermediate_size=32, num_attention_heads=2, num_key_value_heads=2, head_dim=16,
)


def test_seanet_chunk_plain_matches_pallas_interpret():
    """ext [B=2, halo + 4, 32] with real (nonzero) history: the port's K4 on
    CPU tensors (seanet_apply over ext, last 4 * 960 samples) against
    `seanet_decode_pallas_chunk(..., interpret=True)`, with filled biases;
    the CPU route launches nothing."""
    jm, tm = JMimiCfg(**PALLAS_MIMI), MimiConfig(**PALLAS_MIMI)
    tree = jax.tree.map(np.array, j_init_mimi(2, jm))
    W.fill_zero_inits(None, tree, 3)
    ext = np.random.default_rng(7).standard_normal((2, required_halo(tm) + 4, 32)).astype(np.float32)
    want = np.asarray(seanet_decode_pallas_chunk(j_pack(to_jax(tree)["decoder"], jm), jm,
                                                 jnp.asarray(ext), interpret=True))
    kernels.reset_launches()
    got = seanet_decode_chunk(pack_seanet_decoder(W.to_torch(tree["decoder"], "cpu"), tm), tm,
                              torch.from_numpy(ext))
    assert kernels.LAUNCHES["seanet_chunk"] == 0
    assert got.shape == want.shape == (2, 4 * 960)
    np.testing.assert_allclose(t2n(got), want, rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------------------
# NAR head_tail
# --------------------------------------------------------------------------


def test_nar_refine_head_tail_matches_jax():
    tree, _, jcfg, tcfg, _, _ = make_trees(seed=8)
    model = W.sopro_params_from_jax(tree, tcfg, "cpu")
    rng = np.random.default_rng(8)
    cond = rng.standard_normal((1, 19, 64)).astype(np.float32)
    rvq = rng.integers(0, 32, (1, 19)).astype(np.int32)
    mask = (np.arange(19) >= 5)[None]  # a window that starts before frame 0
    want = np.asarray(JM.nar_refine(to_jax(tree), jcfg, jnp.asarray(cond), jnp.asarray(rvq),
                                    mask=jnp.asarray(mask), head_tail=6))
    got = t2n(M.nar_refine(model, torch.from_numpy(cond), torch.from_numpy(rvq),
                           mask=torch.from_numpy(mask), head_tail=6))
    np.testing.assert_array_equal(got, want)
    last = tcfg.stage_indices()[tcfg.stage_order()[-1]]
    assert not got[:, :-6][..., last].any()


# --------------------------------------------------------------------------
# the stream plan and the facade
# --------------------------------------------------------------------------


def _drive(eng, start_kw, step_kw, port: bool):
    """Run a stream through the engine -> [(wav, valid, done, tokens)]."""
    ids, ref = start_kw.pop("ids"), start_kw.pop("ref")
    wav, valid, done, carry, ctx, cond, mstate = eng.stream_start_fused(ids, ref, **start_kw)
    tokens = (lambda c: t2n(c.tokens)) if port else (lambda c: np.asarray(c.tokens))
    out = [(wav, valid, done, tokens(carry))]
    emitted = valid
    while not done:
        wav, valid, done, carry, mstate = eng.stream_step_fused(carry, ctx, cond, mstate, emitted, **step_kw)
        out.append((wav, valid, done, tokens(carry)))
        emitted = max(emitted, valid)
    return out


def test_stream_engine_matches_jax(pair):
    """stream_start_fused / stream_step_fused step by step: the AR tokens so
    far, valid, done and each chunk's waveform (S = 24 frames, chunk 6: no
    window reaches past S)."""
    jtts, port = pair
    sampling = dict(top_p=0.9, temperature=1.05, anti_loop=True, min_gen=3)
    start = dict(max_frames=23, chunk=6, style_strength=1.0, seed=3, **sampling)
    step = dict(chunk=6, nar_ctx=port.cfg.rf_nar(), **sampling)
    ids = port.encode_text(TEXT)
    want = _drive(jtts.engine, dict(start, ids=ids, ref=jtts.prepare_reference(ref_tokens_tq=REF)),
                  step, port=False)
    got = _drive(port.engine, dict(start, ids=ids, ref=port.prepare_reference(ref_tokens_tq=REF)),
                 step, port=True)
    assert len(got) == len(want) > 1
    for (gw, gv, gd, gt), (ww, wv, wd, wt) in zip(got, want):
        assert (gv, gd) == (wv, wd)
        np.testing.assert_array_equal(gt, wt)
        assert gw.shape == ww.shape == (1, 6 * port.engine.mimi_cfg.hop_length)
        peak_close(gw, ww)


@pytest.mark.parametrize("chunk_frames,max_frames", [(4, 23), (6, 17)])
def test_stream_matches_jax(pair, chunk_frames, max_frames):
    jtts, port = pair
    kw = dict(ref_tokens_tq=REF, max_frames=max_frames, seed=5, chunk_frames=chunk_frames)
    want = list(jtts.stream(TEXT, **kw))
    got = list(port.stream(TEXT, **kw))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        peak_close(g, w)


def test_streamer_default_chunk_and_ttfa(pair):
    """SoproTTSStreamer with StreamConfig's default chunk (16) and the
    default NAR context, against the JAX package's streamer."""
    jtts, port = pair
    assert StreamConfig().chunk_frames == JStreamConfig().chunk_frames == 16
    kw = dict(ref_tokens_tq=REF, max_frames=31, seed=2)
    streamer = SoproTTSStreamer(port)
    got = list(streamer.stream(TEXT, **kw))
    want = list(JStreamer(jtts).stream(TEXT, **kw))
    assert streamer.last_ttfa_s is not None and streamer.last_ttfa_s > 0
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        peak_close(g, w)


def test_single_chunk_stream_equals_synthesize(pair):
    _, port = pair
    kw = dict(ref_tokens_tq=REF, max_frames=23, seed=3)
    chunks = list(port.stream(TEXT, chunk_frames=24, **kw))
    want = port.synthesize(TEXT, **kw)
    assert len(chunks) == 1 and chunks[0].shape == want.shape
    peak_close(chunks[0], want)


def test_final_chunk_window_of_a_max_length_stream():
    """No row stops (EOS logit pushed to -1e4) and S = 21 frames is no
    multiple of the chunk (6), so the last chunk's NAR window reaches past
    frame S-1. The port's last chunk holds frames [emitted, S), refined from
    the window of original frames [emitted+cf-w, emitted+cf) built here by
    explicit zero-padded indexing, and vocoded from the stream state before
    that chunk. The JAX package's last chunk is instead the one refined from
    the window clamped back to [S-w, S) under the unclamped window's mask:
    this records its fault without changing it."""
    jtts, port = build_pair(seed=9, eos_bias=-1e4)
    eng, cf, max_frames = port.engine, 6, 20
    s, hop = max_frames + 1, eng.mimi_cfg.hop_length
    w = cf + port.cfg.rf_nar()
    sampling = dict(top_p=0.9, temperature=1.05, anti_loop=True, min_gen=3)
    ref = port.prepare_reference(ref_tokens_tq=REF)
    wav, valid, done, carry, ctx, cond, mstate = eng.stream_start_fused(
        port.encode_text(TEXT), ref, max_frames=max_frames, chunk=cf, style_strength=1.0,
        seed=4, **sampling)
    chunks, emitted = [wav[:, : valid * hop]], valid
    while True:
        before = (emitted, mstate)
        wav, valid, done, carry, mstate = eng.stream_step_fused(
            carry, ctx, cond, mstate, emitted, chunk=cf, nar_ctx=w - cf, **sampling)
        chunks.append(wav[:, : (valid - emitted) * hop])
        emitted = valid
        if done:
            break
    assert valid == s and emitted == s and (s % cf) != 0

    e0, m0 = before
    cond_np, toks_np = t2n(cond), t2n(carry.tokens)
    mask = (np.arange(e0 + cf - w, e0 + cf) >= 0)[None]  # every frame < S is valid

    def last_chunk(orig, mask=mask):
        """Refine the window of original frames `orig` (zero outside
        [0, S)) under `mask` and vocode its last cf frames from m0."""
        inside = ((orig >= 0) & (orig < s))[None]
        pick = np.clip(orig, 0, s - 1)
        win = np.where(inside[..., None], cond_np[:, pick], 0.0).astype(np.float32)
        rvq = np.where(inside, toks_np[:, pick], 0).astype(np.int32)
        with torch.inference_mode():
            toks = M.nar_refine(eng.model, torch.from_numpy(win), torch.from_numpy(rvq),
                                mask=torch.from_numpy(mask & inside), head_tail=cf)
            out, _ = TS.mimi_decode_step(eng.mimi.p, eng.mimi_cfg, toks[:, w - cf:], m0,
                                         packed=eng.mimi.packed_decoder())
        return t2n(out)[:, : (s - e0) * hop]

    want = last_chunk(np.arange(e0 + cf - w, e0 + cf))
    assert chunks[-1].shape == want.shape == (1, (s - e0) * hop)
    peak_close(chunks[-1], want)

    jchunks = list(jtts.stream(TEXT, ref_tokens_tq=REF, max_frames=max_frames, seed=4,
                               chunk_frames=cf, min_gen_frames=3))
    assert [c.shape for c in jchunks] == [c.shape for c in chunks]
    for g, j in zip(chunks[:-1], jchunks[:-1]):
        peak_close(g, j)
    jmask = mask & (np.arange(e0 + cf - w, e0 + cf) < s)[None]  # from the unclamped start
    peak_close(jchunks[-1], last_chunk(np.arange(s - w, s), jmask))
    with pytest.raises(AssertionError):
        peak_close(jchunks[-1], want)
