"""The batch and long-form paths against the JAX package on the CPU:
`synthesize_batch`, `synthesize_long` and `split_sentences`.

Same weights (the JAX package's init, zero-inits filled, the head's EOS bias
raised by the same value in both trees so that rows stop at different
frames), same texts, reference tokens and seeds. Bars: per-row lengths
equal, tokens exact (through `generate_tokens`, which runs `nar_refine`),
waveforms within 1e-4 of their peak (fp32 stacks summed in another order),
duplicated (text, seed) rows identical.
"""

import numpy as np
import pytest
import torch

from sopro_tpu.engine import Engine as JEngine
from sopro_tpu.tokenizer import SimpleCharTokenizer as JTok
from sopro_tpu.tts import SoproTTS as JTTS, split_sentences as j_split

from sopro_tpu_torch import weights as W
from sopro_tpu_torch.engine import Engine
from sopro_tpu_torch.tokenizer import SimpleCharTokenizer
from sopro_tpu_torch.tts import SoproTTS, split_sentences

from tests.test_torch_ops import make_trees, to_jax

torch.set_num_threads(1)

MAX_FRAMES = 24
EOS_BIAS = 0.1  # rows of BATCHES stop at 25, 4 and 10 frames
# texts of at most 32 characters: the small config's text table has 40 rows
BATCHES = {
    "one-bucket": (("hello there", "short one", "a third row"), (3, 4, 5)),
    "two-buckets-dup": (("hello there", "a second, longer request", "hello there"), (3, 5, 3)),
}


def build_pair(runtime=None, jruntime=None, seed=6):
    """(JAX SoproTTS, port SoproTTS, reference tokens) on the same weights."""
    tree, mimi, jcfg, tcfg, jm, tm = make_trees(seed=seed)
    tree["ar"]["head"]["b"][tcfg.eos_id] += EOS_BIAS
    jtts = JTTS(JEngine(to_jax(tree), jcfg, to_jax(mimi), jm, jruntime), jcfg, JTok(), jruntime)
    port = SoproTTS(
        Engine(W.sopro_params_from_jax(tree, tcfg, "cpu"), W.mimi_params_from_jax(mimi, tm, "cpu"),
               runtime),
        tcfg, SimpleCharTokenizer(), runtime,
    )
    ref = np.random.default_rng(12).integers(0, 32, (40, 8)).astype(np.int32)
    return jtts, port, ref


@pytest.fixture(scope="module")
def pair():
    return build_pair()


def assert_rows_close(got, want):
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-4 * max(float(np.abs(w).max()), 1e-30), rtol=0)


@pytest.mark.parametrize("name", list(BATCHES))
def test_synthesize_batch_matches_jax(pair, name):
    jtts, port, ref = pair
    texts, seeds = BATCHES[name]
    jref, pref = jtts.prepare_reference(ref_tokens_tq=ref), port.prepare_reference(ref_tokens_tq=ref)
    want = jtts.synthesize_batch(texts, ref=jref, max_frames=MAX_FRAMES, seeds=seeds)
    got = port.synthesize_batch(texts, ref=pref, max_frames=MAX_FRAMES, seeds=seeds)
    assert all(g.dtype == np.float32 for g in got)
    assert_rows_close(got, want)
    hop = port.engine.mimi_cfg.hop_length
    lengths = [g.shape[1] // hop for g in got]
    assert len(set(lengths)) > 1 and 0 < min(lengths) < MAX_FRAMES + 1, lengths
    for text, seed, n in zip(texts, seeds, lengths):
        toks = port.generate_tokens(text, pref, max_frames=MAX_FRAMES, seed=seed)
        np.testing.assert_array_equal(
            toks, jtts.generate_tokens(text, jref, max_frames=MAX_FRAMES, seed=seed))
        assert toks.shape[0] == n
    if name == "two-buckets-dup":
        np.testing.assert_array_equal(got[0], got[2])
        # sub-batches of 2 rows (the second padded to its own bucket) give the same rows
        grouped = port.synthesize_batch(texts, ref=pref, max_frames=MAX_FRAMES, seeds=seeds,
                                        pipeline_group=2)
        assert_rows_close(grouped, got)


def test_synthesize_batch_pcm16(pair):
    """pcm16 rows are the float rows rounded on the device as the JAX
    package rounds them (round-half-even of clip(x) * 32767), and agree
    with JAX's pcm16 rows within one step."""
    jtts, port, ref = pair
    texts, seeds = BATCHES["one-bucket"]
    kw = dict(ref_tokens_tq=ref, max_frames=MAX_FRAMES, seeds=seeds)
    flt = port.synthesize_batch(texts, **kw)
    pcm = port.synthesize_batch(texts, pcm16=True, **kw)
    for p, f in zip(pcm, flt):
        assert p.dtype == np.int16
        np.testing.assert_array_equal(p, np.round(np.clip(f, -1.0, 1.0) * 32767.0).astype(np.int16))
    for p, j in zip(pcm, jtts.synthesize_batch(texts, pcm16=True, **kw)):
        assert p.shape == j.shape and int(np.abs(p.astype(np.int32) - j).max(initial=0)) <= 1


LONG_TEXT = "Hi there. How are you today? Fine; thanks!\nBye now, see you."


@pytest.mark.parametrize("text,max_chars", [(LONG_TEXT, 20), ("Just one short line.", 30)],
                         ids=["three-chunks", "one-chunk"])
def test_synthesize_long_matches_jax(pair, text, max_chars):
    jtts, port, ref = pair
    kw = dict(ref_tokens_tq=ref, max_frames=MAX_FRAMES, seed=2, max_chars=max_chars, gap_ms=5.0)
    want = jtts.synthesize_long(text, **kw)
    got = port.synthesize_long(text, **kw)
    assert got.dtype == np.float32 and got.shape == want.shape and got.shape[1] > 0
    np.testing.assert_allclose(got, want, atol=1e-4 * float(np.abs(want).max()), rtol=0)
    chunks = split_sentences(text, max_chars=max_chars)
    if len(chunks) > 1:
        rows = port.synthesize_batch(chunks, ref_tokens_tq=ref, max_frames=MAX_FRAMES,
                                     seeds=[2 + i for i in range(len(chunks))])
        gap = int(round(5.0 / 1000.0 * 24000))
        assert got.shape[1] == sum(r.shape[1] for r in rows) + gap * (len(chunks) - 1)


SPLIT_CASES = [
    ("", 350), ("   \n ", 350), ("One sentence without a stop", 350),
    ("First. Second! Third? Fourth; fifth", 350), ("First. Second! Third? Fourth; fifth", 12),
    ("line one\nline two\n\n  line three.", 350),
    ("a very long sentence, with commas, that must be cut at a comma or a space", 20),
    ("averyveryverylongwordwithoutanyspaceatall and more", 10),
    ("Mr. Smith went to Washington. He arrived!  Then,\tsomething else happened...", 25),
]


@pytest.mark.parametrize("text,max_chars", SPLIT_CASES)
def test_split_sentences_matches_jax(text, max_chars):
    assert split_sentences(text, max_chars=max_chars) == j_split(text, max_chars=max_chars)
