"""K5 (the per-step AR kernel's plain version, `ops/ar_step.py`) and the
per-step route against the JAX package on the CPU, and the engine's rule
that picks K1, K5 or the plain loop.

JAX runs its Pallas step `ar_step_pallas` in interpret mode. Tolerances as
tests/test_pallas_ar.py holds that kernel against the XLA step: logits
within 1e-5 (abs and rel), ring buffers within 1e-6 (the new entry is one
GLU output; the rest are copies). Tokens, t and first_eos exact: both
packages run the same Threefry stream through the same sampler ops.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sopro_tpu.engine import Engine as JEngine
from sopro_tpu.config import RuntimeConfig as JRuntime
from sopro_tpu.models import generator as JG
from sopro_tpu.models import sopro as JM
from sopro_tpu.ops.pallas_ar import PallasARContext, ar_step_pallas, stack_ar_params
from sopro_tpu.ops.pallas_ar_loop import ResidentLoopContext

from sopro_tpu_torch import weights as W
from sopro_tpu_torch.codec.mimi import MimiCodec
from sopro_tpu_torch.config import RuntimeConfig
from sopro_tpu_torch.engine import Engine, ar_route
from sopro_tpu_torch.models import sopro as TM
from sopro_tpu_torch.ops.ar_loop import ARLoopContext
from sopro_tpu_torch.ops.ar_step import ARStepContext, ar_step

from tests.test_torch_ops import make_trees, t2n, to_jax

torch.set_num_threads(1)

# four AR blocks with dilations 1, 2, 4, 1 and two text attentions
AR_OVER = dict(n_layers_ar=4, ar_dilation_cycle=(1, 2, 4, 1))
L = 12
S = 21


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.fixture(scope="module")
def setup():
    tree, mimi, jcfg, tcfg, _, _ = make_trees(seed=9, **AR_OVER)
    tree["ar"]["head"]["b"][tcfg.eos_id] += 2.5  # rows stop at different frames
    return to_jax(tree), W.sopro_params_from_jax(tree, tcfg, "cpu"), jcfg, tcfg


def _text(b, rows_valid, seed=3):
    rng = np.random.default_rng(seed)
    txt = rng.standard_normal((b, L, 64)).astype(np.float32)
    mask = np.arange(L)[None, :] < np.asarray(rows_valid)[:, None]
    return txt, mask


@pytest.mark.parametrize("rows_valid", [(9,), (7, 0)], ids=["B1-padded", "B2-padded-and-empty"])
def test_ar_step_matches_jax_pallas_step(setup, rows_valid):
    """K5's CPU route against JAX `ar_step_pallas` (interpret mode) over 8
    chained steps from a random ring buffer: a partly padded text row, and
    at B = 2 a row whose mask is all False (it attends to key 0)."""
    jp, model, jcfg, tcfg = setup
    b = len(rows_valid)
    txt, mask = _text(b, rows_valid)
    kvs = JG.build_text_kv_caches(jp["ar"], jcfg, jnp.asarray(txt), jnp.asarray(mask))
    kv_k = jnp.stack([kv["k"] for kv in kvs if kv is not None])
    kv_v = jnp.stack([kv["v"] for kv in kvs if kv is not None])
    stacked = stack_ar_params(jp["ar"], jcfg)
    ctx = TM.ar_step_context(model, _t(txt), _t(mask))
    assert isinstance(ctx, ARStepContext) and tuple(ctx.kv_k.shape) == tuple(kv_k.shape)
    rng = np.random.default_rng(sum(rows_valid))
    bufs = (rng.standard_normal((4, b, 17, 64)) * 0.5).astype(np.float32)
    jbufs, tbufs = jnp.asarray(bufs), _t(bufs)
    for step in range(8):
        x = rng.standard_normal((b, 64)).astype(np.float32)
        jl, jbufs = ar_step_pallas(stacked, jcfg, jnp.asarray(x), jbufs, kv_k, kv_v,
                                   jnp.asarray(mask), interpret=True)
        tl, tbufs = ar_step(ctx, _t(x), tbufs)
        assert tl.shape == (b, tcfg.ar_vocab) and tl.dtype == torch.float32
        np.testing.assert_allclose(t2n(tl), np.asarray(jl), rtol=1e-5, atol=1e-5,
                                   err_msg=f"logits, step {step}")
        np.testing.assert_allclose(t2n(tbufs), np.asarray(jbufs), rtol=1e-6, atol=1e-6,
                                   err_msg=f"bufs, step {step}")


@pytest.mark.parametrize("rows_valid,seed", [((9,), 4), ((9, 5), 8)], ids=["B1", "B2"])
def test_per_step_route_matches_jax(setup, rows_valid, seed):
    """The port's `ar_generate` through an ARStepContext (K5 steps, the
    sampler between them, per-row freeze) against JAX `ar_generate` with a
    PallasARContext: t, tokens and first_eos exact; the rows stop at
    different frames."""
    jp, model, jcfg, tcfg = setup
    b = len(rows_valid)
    txt, mask = _text(b, rows_valid, seed=5)
    cond = (np.random.default_rng(6).standard_normal((b, S, 64)) * 0.5).astype(np.float32)
    kvs = JG.build_text_kv_caches(jp["ar"], jcfg, jnp.asarray(txt), jnp.asarray(mask))
    jctx = PallasARContext(
        stacked=stack_ar_params(jp["ar"], jcfg),
        kv_k=jnp.stack([kv["k"] for kv in kvs if kv is not None]),
        kv_v=jnp.stack([kv["v"] for kv in kvs if kv is not None]), mask=jnp.asarray(mask),
    )
    jset = JM.default_ar_settings(min_gen_frames=2)
    want = JM.ar_generate(jp, jcfg, jnp.asarray(cond), jnp.asarray(txt), jnp.asarray(mask),
                          jax.random.PRNGKey(seed), jset, S, kv_caches=jctx)
    got = TM.ar_generate(model, _t(cond), _t(txt), _t(mask), seed,
                         TM.ARSettings(min_gen_frames=2), S,
                         ctx=TM.ar_step_context(model, _t(txt), _t(mask)))
    np.testing.assert_array_equal(t2n(got.t), np.asarray(want.t))
    np.testing.assert_array_equal(t2n(got.tokens), np.asarray(want.tokens))
    np.testing.assert_array_equal(t2n(got.first_eos), np.asarray(want.first_eos))
    assert int(got.t.min()) < S, "no row stopped early"
    if b == 2:
        assert int(got.t[0]) != int(got.t[1]), "the rows stopped at the same frame"
    # the same steps through the plain loop's context give the same carry
    plain = TM.ar_generate(model, _t(cond), _t(txt), _t(mask), seed,
                           TM.ARSettings(min_gen_frames=2), S)
    for f in ("tokens", "t", "first_eos", "stopped", "hist", "key", "bufs"):
        assert torch.equal(getattr(got, f), getattr(plain, f)), f


def _jax_kind(ctx):
    if isinstance(ctx, ResidentLoopContext):
        return "ar_loop"
    return "ar_step" if isinstance(ctx, PallasARContext) else "plain"


@pytest.mark.parametrize("use_resident", [True, False])
@pytest.mark.parametrize("use_step", [True, False])
def test_ar_selection_matches_jax(setup, use_resident, use_step):
    """Over resident x both knobs x B in {1, 2, 3}, the port's `_ar_kv`
    picks the context kind that JAX `Engine._ar_kv` picks (K1 fits in both
    at this size when its knob is on)."""
    jp, model, jcfg, tcfg = setup
    jeng = JEngine(jp, jcfg, None, None,
                   JRuntime(use_pallas_resident=use_resident, use_pallas_ar=use_step))
    eng = Engine(model, MimiCodec({}, None),
                 RuntimeConfig(use_pallas_resident=use_resident, use_pallas_ar=use_step))
    for b in (1, 2, 3):
        txt, mask = _text(b, [L] * b)
        assert eng.resident_eligible(b, L) == jeng.resident_eligible(b, L, 401) == use_resident
        for resident in (True, False):
            jctx = jeng._ar_kv(jp, jnp.asarray(txt), jnp.asarray(mask), resident=resident)
            ctx = eng._ar_kv(_t(txt), _t(mask), resident)
            kind = _jax_kind(jctx)
            assert isinstance(ctx, ARStepContext if kind == "ar_step" else ARLoopContext)
            assert ar_route("cpu", b=b, resident=resident, eligible=use_resident,
                            use_step=use_step) == kind


def test_ar_route_on_cuda_raises_where_no_kernel_is_selected():
    """On a CUDA device the plain loop is never picked: the rule raises,
    naming both knobs; a CPU device takes the plain loop instead."""
    for b, resident, eligible, use_step in (
        (1, True, False, False), (1, False, True, False), (3, True, False, True),
        (3, False, True, True),
    ):
        with pytest.raises(ValueError, match="use_pallas_resident.*use_pallas_ar"):
            ar_route("cuda", b=b, resident=resident, eligible=eligible, use_step=use_step)
        assert ar_route("cpu", b=b, resident=resident, eligible=eligible,
                        use_step=use_step) == "plain"
    assert ar_route("cuda", b=3, resident=True, eligible=True, use_step=False) == "ar_loop"
    assert ar_route("cuda", b=2, resident=False, eligible=True, use_step=True) == "ar_step"


def test_default_knobs_follow_the_device(setup):
    """None means on for a CUDA device: on the CPU both knobs are off and
    every call takes the plain loop; K1's shared-memory limit grows with
    the text bucket and the full width fits the 2048 bucket."""
    from sopro_tpu_torch.config import SoproTTSConfig
    from sopro_tpu_torch.ops.ar_loop import SMEM_PER_BLOCK, smem_bytes

    _, model, _, _ = setup
    eng = Engine(model, MimiCodec({}, None))
    assert not eng.use_pallas_ar and not eng.use_pallas_resident
    txt, mask = _text(3, [L] * 3)
    assert isinstance(eng._ar_kv(_t(txt), _t(mask), True), ARLoopContext)
    full = SoproTTSConfig()
    assert smem_bytes(full, 2048) - smem_bytes(full, 64) == 4 * (2048 - 64)
    assert smem_bytes(full, 2048) <= SMEM_PER_BLOCK < smem_bytes(full, 40000)
