"""The torch port's primitives against the JAX package on the CPU, plus the
port's package hygiene. Also the weight builders the other test_torch_*
files import (the small configs live in test_torch_cuda.py, which imports
no JAX).

Inputs come from numpy seeds; weights from the JAX package's own init
functions, with every zero-initialised leaf replaced by random values
(`sopro_tpu_torch.weights.fill_zero_inits`), so gates, FiLM and head
offsets are really compared. Tolerances: 1e-5 abs/rel for single fp32 ops
(the two frameworks sum in different orders, a few ulps), 1e-4 for stacks.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sopro_tpu.config import SoproTTSConfig as JCfg
from sopro_tpu.codec.convert import init_mimi_params as j_init_mimi
from sopro_tpu.codec.mimi_config import MimiConfig as JMimiCfg
from sopro_tpu.models.sopro import init_sopro_model
from sopro_tpu.ops import attention as JA
from sopro_tpu.ops import blocks as JB
from sopro_tpu.ops import embeddings as JE

from sopro_tpu_torch import kernels
from sopro_tpu_torch import weights as W
from sopro_tpu_torch.codec.mimi_config import MimiConfig
from sopro_tpu_torch.config import SoproTTSConfig
from sopro_tpu_torch.ops import attention as TA
from sopro_tpu_torch.ops import blocks as TB
from sopro_tpu_torch.ops import embeddings as TE

from tests.test_torch_cuda import CFG, SMALL_MIMI, TEXT_VOCAB

torch.set_num_threads(1)


ATOL = RTOL = 1e-5
STACK_TOL = 1e-4


def make_trees(seed: int = 4, **cfg_over):
    """(numpy Sopro tree, numpy Mimi tree, JAX cfg, port cfg, JAX Mimi cfg,
    port Mimi cfg) from the JAX init functions with zero-inits filled."""
    jcfg, tcfg = JCfg(**dict(CFG, **cfg_over)), SoproTTSConfig(**dict(CFG, **cfg_over))
    jm, tm = JMimiCfg(**SMALL_MIMI), MimiConfig(**SMALL_MIMI)
    tree = jax.tree.map(np.array, init_sopro_model(jax.random.PRNGKey(seed), jcfg, TEXT_VOCAB))
    mimi = jax.tree.map(np.array, j_init_mimi(seed, jm))
    W.fill_zero_inits(tree, mimi, seed + 100)
    return tree, mimi, jcfg, tcfg, jm, tm


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def t2n(x):
    return x.detach().cpu().numpy()


def close(got, want, tol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol)


@pytest.fixture(scope="module")
def trees():
    return make_trees()


def _ssm(tree):
    return tree["ar"]["blocks"][0]


def test_elementary_ops_match_jax(trees):
    tree = trees[0]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    p = _ssm(tree)
    jp, tp = to_jax(p), W.to_torch(p, "cpu")
    xt = torch.from_numpy(x)
    close(t2n(TB.rmsnorm(tp["norm"], xt)), JB.rmsnorm(jp["norm"], x))
    close(t2n(TB.glu(tp["glu"], xt)), JB.glu(jp["glu"], x))
    close(t2n(TB.gelu(xt)), JB.gelu(x))
    close(t2n(TB.linear(tp["ff1"], xt)), JB.linear(jp["ff1"], x))
    ln = {"scale": rng.standard_normal(64).astype(np.float32),
          "bias": rng.standard_normal(64).astype(np.float32)}
    close(t2n(TB.layernorm(W.to_torch(ln, "cpu"), xt)), JB.layernorm(to_jax(ln), x))
    pool = tree["token2sv"]["pool"]
    h = rng.standard_normal((2, 9, 192)).astype(np.float32)
    mask = np.arange(9)[None, :] < np.array([[9], [5]])
    close(
        t2n(TB.attentive_stats_pool(W.to_torch(pool, "cpu"), torch.from_numpy(h),
                                    torch.from_numpy(mask))),
        JB.attentive_stats_pool(to_jax(pool), h, mask),
    )


@pytest.mark.parametrize("dilation,causal", [(1, False), (2, True), (3, False)])
def test_dwconv_and_ssmlite_match_jax(trees, dilation, causal):
    p = _ssm(trees[0])
    jp, tp = to_jax(p), W.to_torch(p, "cpu")
    rng = np.random.default_rng(dilation)
    x = rng.standard_normal((2, 13, 64)).astype(np.float32)
    mask = np.arange(13)[None, :] < np.array([[13], [8]])
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    close(
        t2n(TB.dwconv1d(tp["dw"], xt, kernel_size=5, dilation=dilation, causal=causal)),
        JB.dwconv1d(jp["dw"], x, kernel_size=5, dilation=dilation, causal=causal),
    )
    close(
        t2n(TB.ssmlite(tp, xt, kernel_size=5, dilation=dilation, causal=causal, mask=mt)),
        JB.ssmlite(jp, x, kernel_size=5, dilation=dilation, causal=causal, mask=mask),
        STACK_TOL,
    )


def test_dwconv_step_equals_sequence_in_torch(trees):
    """dwconv1d_step / ssmlite_step run step by step equal the causal
    full-sequence op, also with a buffer longer than the receptive field
    (the packed ring-buffer layout)."""
    tp = W.to_torch(_ssm(trees[0]), "cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 11, 64)).astype(np.float32))
    for dil, ctx in ((1, 5), (2, 9), (2, 13)):
        full = TB.dwconv1d(tp["dw"], x, kernel_size=5, dilation=dil, causal=True)
        seq = TB.ssmlite(tp, x, kernel_size=5, dilation=dil, causal=True)
        buf = torch.zeros(2, ctx, 64)
        buf2 = torch.zeros(2, ctx, 64)
        for t in range(11):
            y, buf = TB.dwconv1d_step(tp["dw"], x[:, t], buf, kernel_size=5, dilation=dil)
            close(t2n(y), t2n(full[:, t]))
            z, buf2 = TB.ssmlite_step(tp, x[:, t], buf2, kernel_size=5, dilation=dil)
            close(t2n(z), t2n(seq[:, t]), STACK_TOL)


def test_attention_matches_jax(trees):
    tree = trees[0]
    rng = np.random.default_rng(2)
    ctx = rng.standard_normal((2, 7, 64)).astype(np.float32)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    # row 1 has no valid key: the all-padded-row fixup attends to key 0
    mask = np.array([[True] * 4 + [False] * 3, [False] * 7])
    xt, ct, mt = torch.from_numpy(x), torch.from_numpy(ctx), torch.from_numpy(mask)
    for p, heads in ((tree["ar"]["xattn"][1], 4), (tree["ref_xattn"][0], 2)):
        jp, tp = to_jax(p), W.to_torch(p, "cpu")
        jkv = JA.build_kv_cache(jp, ctx, heads=heads, mask=jnp.asarray(mask))
        tkv = TA.build_kv_cache(tp, ct, heads=heads, mask=mt)
        close(t2n(tkv["k"]), jkv["k"])
        close(t2n(tkv["v"]), jkv["v"])
        close(t2n(TA.text_xattn(tp, xt, tkv, heads=heads)),
              JA.text_xattn(jp, x, jkv, heads=heads))
        close(t2n(TA.ref_xattn(tp, xt, tkv, heads=heads, gmax=0.35)),
              JA.ref_xattn(jp, x, jkv, heads=heads, gmax=0.35))


def test_embeddings_match_jax(trees):
    tree = trees[0]
    np.testing.assert_array_equal(TE.sinusoidal_table(64, 40), JE.sinusoidal_table(64, 40))
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 32, (2, 6, 8)).astype(np.int32)
    p = tree["cb_embed"]
    jspec, tspec = JE.CodebookEmbeddingSpec(8, 32), TE.CodebookEmbeddingSpec(8, 32)
    tp, jp = W.to_torch(p, "cpu"), to_jax(p)
    tt = torch.from_numpy(toks)
    close(t2n(TE.cb_embed_tokens(tp, tspec, tt[..., 0], 3)),
          JE.cb_embed_tokens(jp, jspec, toks[..., 0], 3))
    wq = rng.standard_normal(8).astype(np.float32)
    for cbs, w in ((list(range(8)), wq), ([0, 2, 5], wq), ([1, 4], None)):
        sub = toks[..., : len(cbs)]
        close(
            t2n(TE.cb_sum_embed_subset(tp, tspec, torch.from_numpy(sub), cbs,
                                       None if w is None else torch.from_numpy(w))),
            JE.cb_sum_embed_subset(jp, jspec, sub, cbs, w),
        )


def test_import_leaves_jax_out():
    """The port imports neither JAX nor the JAX package."""
    code = (
        "import sys, sopro_tpu_torch.tts, sopro_tpu_torch.engine, "
        "sopro_tpu_torch.codec.vocoder, sopro_tpu_torch.ops.ar_loop, sopro_tpu_torch.ops.ar_step, "
        "sopro_tpu_torch.ops.nar_heads, sopro_tpu_torch.streaming, "
        "sopro_tpu_torch.codec.streaming, sopro_tpu_torch.audio\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'sopro_tpu' or m.startswith('sopro_tpu.')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_cpu_wrappers_run_plain_and_count_nothing(trees):
    """Each kernel wrapper on CPU tensors runs its plain version and leaves
    its launch counter at 0."""
    from sopro_tpu_torch.codec.mimi import seanet_apply
    from sopro_tpu_torch.codec.mimi_config import decoder_plan, required_halo
    from sopro_tpu_torch.codec.vocoder import (
        pack_seanet_decoder, seanet_decode, seanet_decode_chunk,
    )
    from sopro_tpu_torch.models import sopro as M
    from sopro_tpu_torch.ops.ar_loop import ar_loop, ar_loop_plain
    from sopro_tpu_torch.ops.ar_step import ar_step, ar_step_plain
    from sopro_tpu_torch.ops.nar_heads import nar_heads_argmax, nar_heads_argmax_plain

    tree, mimi, _, tcfg, _, tm = trees
    kernels.reset_launches()
    rng = np.random.default_rng(5)
    z = torch.from_numpy(rng.standard_normal((1, 9, 32)).astype(np.float32))
    hid = torch.from_numpy(rng.standard_normal((3, 32)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 32, 40)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((3, 40)).astype(np.float32))
    assert torch.equal(nar_heads_argmax(z, hid, w, b), nar_heads_argmax_plain(z, hid, w, b))

    dec = W.to_torch(mimi["decoder"], "cpu")
    emb = torch.from_numpy(rng.standard_normal((1, 6, 32)).astype(np.float32))
    assert torch.equal(seanet_decode(pack_seanet_decoder(dec, tm), tm, emb),
                       seanet_apply(dec, decoder_plan(tm), emb)[..., 0])
    ext = torch.from_numpy(rng.standard_normal((2, required_halo(tm) + 4, 32)).astype(np.float32))
    assert torch.equal(seanet_decode_chunk(pack_seanet_decoder(dec, tm), tm, ext),
                       seanet_apply(dec, decoder_plan(tm), ext)[:, -4 * 12:, 0])

    model = W.sopro_params_from_jax(tree, tcfg, "cpu")
    txt = torch.from_numpy(rng.standard_normal((1, 6, 64)).astype(np.float32))
    mask = torch.ones((1, 6), dtype=torch.bool)
    ctx = M.ar_context(model, txt, mask)
    cond = torch.from_numpy(rng.standard_normal((1, 8, 64)).astype(np.float32) * 0.1)
    carry = M.init_ar_carry(tcfg, 1, 8, 3, "cpu")
    state = {k: getattr(carry, k) for k in ("t", "last", "streak", "stopped",
                                            "first_eos", "key", "hist", "bufs")}
    sett = M.ARSettings().per_row(1, "cpu")
    got, _ = ar_loop(ctx, cond, state, sett, 8, True)
    want, _ = ar_loop_plain(ctx, cond, state, sett, 8, True)
    assert torch.equal(got, want)
    sctx = M.ar_step_context(model, txt, mask)
    x = cond[:, 0]
    for g, w in zip(ar_step(sctx, x, state["bufs"]), ar_step_plain(sctx, x, state["bufs"])):
        assert torch.equal(g, w)
    assert kernels.LAUNCHES == {"ar_loop": 0, "ar_step": 0, "nar_heads": 0, "seanet": 0,
                                "seanet_chunk": 0}
