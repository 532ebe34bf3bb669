"""The slice end to end on the CPU: the port's `SoproTTS.synthesize` against
the JAX package's `SoproTTS(...).synthesize(..., fused=True)` on the same
weights, text, reference tokens and seed -- same length, token matrix equal
to JAX `generate_tokens`, waveform within 1e-4 -- and repeatability.
The same slice on the card is in test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from sopro_tpu.engine import Engine as JEngine
from sopro_tpu.tokenizer import SimpleCharTokenizer as JTok
from sopro_tpu.tts import SoproTTS as JTTS

from sopro_tpu_torch import weights as W
from sopro_tpu_torch.codec.mimi_config import MimiConfig
from sopro_tpu_torch.config import SoproTTSConfig
from sopro_tpu_torch.engine import Engine
from sopro_tpu_torch.tokenizer import SimpleCharTokenizer
from sopro_tpu_torch.tts import SoproTTS

from tests.test_torch_cuda import CFG, SMALL_MIMI
from tests.test_torch_ops import make_trees, to_jax

torch.set_num_threads(1)

MAX_FRAMES = 24
TEXTS = ("hello there", "a second, longer request")  # bucket 32 <= max_text_len + 8


def _build(device):
    tree, mimi, jcfg, tcfg, jm, tm = make_trees(seed=6)
    port = SoproTTS(
        Engine(W.sopro_params_from_jax(tree, tcfg, device),
               W.mimi_params_from_jax(mimi, tm, device)),
        tcfg, SimpleCharTokenizer(),
    )
    return tree, mimi, jcfg, jm, port


@pytest.fixture(scope="module")
def pair():
    tree, mimi, jcfg, jm, port = _build("cpu")
    jtts = JTTS(JEngine(to_jax(tree), jcfg, to_jax(mimi), jm), jcfg, JTok())
    ref = np.random.default_rng(12).integers(0, 32, (40, 8)).astype(np.int32)
    return jtts, port, ref


@pytest.mark.parametrize("text,seed", [(TEXTS[0], 3), (TEXTS[1], 5)])
def test_synthesize_matches_jax(pair, text, seed):
    jtts, port, ref = pair
    kw = dict(max_frames=MAX_FRAMES, seed=seed)
    jref = jtts.prepare_reference(ref_tokens_tq=ref)
    want = jtts.synthesize(text, ref=jref, fused=True, **kw)
    want_toks = jtts.generate_tokens(text, jref, **kw)
    pref = port.prepare_reference(ref_tokens_tq=ref)
    got = port.synthesize(text, ref=pref, **kw)
    got_toks = port.generate_tokens(text, pref, **kw)
    assert got_toks.shape[0] > 0
    np.testing.assert_array_equal(got_toks, want_toks)
    assert got.shape == want.shape == (1, got_toks.shape[0] * port.engine.mimi_cfg.hop_length)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_synthesize_repeats_exactly(pair):
    _, port, ref = pair
    a = port.synthesize(TEXTS[1], ref_tokens_tq=ref, max_frames=MAX_FRAMES, seed=9)
    b = port.synthesize(TEXTS[1], ref_tokens_tq=ref, max_frames=MAX_FRAMES, seed=9)
    assert np.isfinite(a).all() and a.shape[1] > 0
    np.testing.assert_array_equal(a, b)


def test_from_random_cuda_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        SoproTTS.from_random(device="cuda")


def test_from_random_defaults_to_cuda():
    """Called as the JAX package's `SoproTTS.from_random(cfg)` is, the port
    builds on the card: here, with no GPU, that is the RuntimeError of an
    explicit device="cuda"; device="cpu" still builds on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cuda'"):
        SoproTTS.from_random(SoproTTSConfig(**CFG), mimi_cfg=MimiConfig(**SMALL_MIMI))
    tts = SoproTTS.from_random(SoproTTSConfig(**CFG), mimi_cfg=MimiConfig(**SMALL_MIMI),
                               device="cpu")
    assert tts.engine.device.type == "cpu"
