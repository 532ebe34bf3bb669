"""The adaptive synthesize plan, the plan the auto rule picks, the per-step
AR route selected by the knobs, and `encode_speaker`, against the JAX
package on the CPU (weights, texts and seeds as in test_torch_batch.py).

With `RuntimeConfig(use_pallas_ar=True, use_pallas_resident=False)` the JAX
package runs its per-step Pallas kernel K5 (interpreted off the TPU) and
the port its K5 route (the plain step on the CPU). Bars: tokens exact,
waveforms within 1e-4 of their peak, the speaker embedding within 1e-5.
"""

import numpy as np
import pytest
import torch

from sopro_tpu.config import RuntimeConfig as JRuntime

from sopro_tpu_torch.config import RuntimeConfig
from sopro_tpu_torch.ops.ar_loop import ARLoopContext
from sopro_tpu_torch.ops.ar_step import ARStepContext

from tests.test_torch_batch import BATCHES, MAX_FRAMES, assert_rows_close, build_pair

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    return build_pair()


@pytest.mark.parametrize("text,seed", [("hello there", 3), ("a second, longer request", 5)])
def test_adaptive_plan_matches_jax(pair, text, seed):
    """`synthesize(fused=False)`: AR decode, then NAR + Mimi decode over the
    length's frame bucket (64 of 71 frames for the row that stops early);
    equal to JAX, and to the fused plan here."""
    jtts, port, ref = pair
    kw = dict(ref_tokens_tq=ref, max_frames=70, seed=seed)
    want = jtts.synthesize(text, fused=False, **kw)
    got = port.synthesize(text, fused=False, **kw)
    assert_rows_close([got], [want])
    assert_rows_close([port.synthesize(text, fused=True, **kw)], [got])
    pcm = port.synthesize(text, fused=False, pcm16=True, **kw)
    jpcm = jtts.synthesize(text, fused=False, pcm16=True, **kw)
    assert pcm.dtype == np.int16 and pcm.shape == jpcm.shape
    assert int(np.abs(pcm.astype(np.int32) - jpcm).max()) <= 1
    jref, pref = jtts.prepare_reference(ref_tokens_tq=ref), port.prepare_reference(ref_tokens_tq=ref)
    toks = port.generate_tokens(text, pref, max_frames=70, seed=seed)
    np.testing.assert_array_equal(toks, jtts.generate_tokens(text, jref, max_frames=70, seed=seed))
    assert got.shape[1] == toks.shape[0] * port.engine.mimi_cfg.hop_length
    np.testing.assert_allclose(port.engine.decode(toks), jtts.engine.decode(toks),
                               atol=1e-4 * float(np.abs(want).max()), rtol=0)


class _Picked(Exception):
    pass


def _plan(tts, max_frames):
    """Which plan `synthesize(fused=None)` enters at `max_frames`."""
    eng = tts.engine

    def stop(name):
        def f(*a, **k):
            raise _Picked(name)
        return f

    eng.synthesize_fused, eng.ar_generate_device = stop("fused"), stop("adaptive")
    try:
        tts.synthesize("hello there", ref=tts.prepare_reference(ref_tokens_tq=np.zeros((8, 8), np.int32)),
                       max_frames=max_frames)
    except _Picked as e:
        return str(e)
    finally:
        del eng.synthesize_fused, eng.ar_generate_device


@pytest.mark.parametrize("max_frames,plan", [(64, "adaptive"), (300, "fused")])
def test_auto_rule_picks_the_jax_plan(pair, max_frames, plan):
    jtts, port, _ = pair
    assert _plan(jtts, max_frames) == _plan(port, max_frames) == plan


def test_encode_speaker_matches_jax(pair):
    jtts, port, ref = pair
    got = port.encode_speaker(ref_tokens_tq=ref)
    want = jtts.encode_speaker(ref_tokens_tq=ref)
    assert got.shape == want.shape == (port.cfg.sv_student_dim,)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_per_step_route_by_knob_matches_jax():
    """The knobs that send JAX through K5 send the port through its K5
    route: `synthesize` (fused and adaptive) and a B = 2 `synthesize_batch`
    give JAX's tokens and waveforms; a B = 3 call takes the plain loop on
    the CPU (on CUDA it raises: tests/test_torch_ar_step.py)."""
    jtts, port, ref = build_pair(
        RuntimeConfig(use_pallas_ar=True, use_pallas_resident=False),
        JRuntime(use_pallas_ar=True, use_pallas_resident=False),
    )
    eng = port.engine
    assert eng.use_pallas_ar and not eng.use_pallas_resident
    txt, mask = torch.zeros(2, 16, port.cfg.d_model), torch.ones(2, 16, dtype=torch.bool)
    assert isinstance(eng._ar_kv(txt, mask, True), ARStepContext)
    assert isinstance(eng._ar_kv(txt[[0, 1, 1]], mask[[0, 1, 1]], True), ARLoopContext)
    jref, pref = jtts.prepare_reference(ref_tokens_tq=ref), port.prepare_reference(ref_tokens_tq=ref)
    kw = dict(max_frames=MAX_FRAMES, seed=5)
    for fused in (True, False):
        assert_rows_close([port.synthesize("a second, longer request", ref=pref, fused=fused, **kw)],
                          [jtts.synthesize("a second, longer request", ref=jref, fused=fused, **kw)])
    np.testing.assert_array_equal(port.generate_tokens("hello there", pref, **kw),
                                  jtts.generate_tokens("hello there", jref, **kw))
    texts, seeds = BATCHES["two-buckets-dup"][0][:2], BATCHES["two-buckets-dup"][1][:2]
    assert_rows_close(
        port.synthesize_batch(texts, ref=pref, max_frames=MAX_FRAMES, seeds=seeds),
        jtts.synthesize_batch(texts, ref=jref, max_frames=MAX_FRAMES, seeds=seeds),
    )
