"""The torch port's model pieces against the JAX package on the CPU:
conditioning (text encoder, Token2SV, FiLM, reference, per-frame cond), the
AR step and the plain AR loop (the CPU route of kernel K1), and the NAR
heads (the CPU route of kernel K2) and refine.

Bars: 1e-4 for stacks; AR and NAR tokens exact. The AR loop runs the same
Threefry stream as the JAX package, so sampled tokens match at production
settings too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sopro_tpu.models import generator as JG
from sopro_tpu.models import sopro as JM
from sopro_tpu.models import speaker as JSPK
from sopro_tpu.models import text as JTXT
from sopro_tpu.ops.pallas_nar import nar_heads_argmax as j_nar_heads

from sopro_tpu_torch import weights as W
from sopro_tpu_torch.models import generator as TG
from sopro_tpu_torch.models import sopro as TM
from sopro_tpu_torch.ops.nar_heads import nar_heads_argmax

from tests.test_torch_ops import STACK_TOL, close, make_trees, t2n, to_jax

torch.set_num_threads(1)

S = 25


@pytest.fixture(scope="module")
def setup():
    tree, mimi, jcfg, tcfg, jm, tm = make_trees(min_gen_frames=4)
    model = W.sopro_params_from_jax(tree, tcfg, "cpu")
    rng = np.random.default_rng(11)
    inputs = {
        "ids": rng.integers(3, 259, (1, 16)).astype(np.int32),
        "text_mask": np.arange(16)[None] < 11,
        "ref": rng.integers(0, 32, (1, 32, 8)).astype(np.int32),
        "ref_mask": np.arange(32)[None] < 27,
        "txt": rng.standard_normal((1, 12, 64)).astype(np.float32),
        "txt_mask": np.arange(12)[None] < 9,
        "cond": (rng.standard_normal((1, S, 64)) * 0.1).astype(np.float32),
    }
    return to_jax(tree), model, jcfg, tcfg, inputs


def _t(x):
    return torch.from_numpy(np.array(x))


def test_conditioning_matches_jax(setup):
    jp, model, jcfg, tcfg, x = setup
    ids, tmask, ref, rmask = x["ids"], x["text_mask"], x["ref"], x["ref_mask"]
    js, jpool = JTXT.text_encoder(jp["text_enc"], jcfg, ids, jnp.asarray(tmask))
    ts, tpool = model.text_enc(_t(ids), _t(tmask))
    close(t2n(ts), js, STACK_TOL)
    close(t2n(tpool), jpool, STACK_TOL)

    close(t2n(model.token2sv(_t(ref), _t(rmask))),
          JSPK.token2sv(jp["token2sv"], ref, jcfg.codebook_size, mask=jnp.asarray(rmask)),
          STACK_TOL)
    base = np.random.default_rng(3).standard_normal((1, 5, 64)).astype(np.float32)
    spk = np.random.default_rng(4).standard_normal((1, 16)).astype(np.float32)
    close(t2n(model.spk_film(_t(base), _t(spk), 0.7)),
          JSPK.speaker_film(jp["spk_film"], base, spk, strength=0.7), STACK_TOL)

    jref = JM.prepare_reference(jp, jcfg, jnp.asarray(ref), mask=jnp.asarray(rmask))
    tref = TM.prepare_reference(model, _t(ref), mask=_t(rmask))
    close(t2n(tref.sv_ref), jref.sv_ref, STACK_TOL)
    close(t2n(tref.ref_seq), jref.ref_seq, STACK_TOL)
    for a, b in zip(tref.ref_kv, jref.ref_kv):
        close(t2n(a["k"]), b["k"], STACK_TOL)
        close(t2n(a["v"]), b["v"], STACK_TOL)
    jc = JM.prepare_conditioning(jp, jcfg, jnp.asarray(ids), jnp.asarray(tmask), jref,
                                 max_frames=S - 1, style_strength=1.0)
    tc = TM.prepare_conditioning(model, _t(ids), _t(tmask), tref, max_frames=S - 1,
                                 style_strength=1.0)
    close(t2n(tc["txt_seq"]), jc["txt_seq"], STACK_TOL)
    close(t2n(tc["cond_ar"]), jc["cond_ar"], STACK_TOL)


def test_ar_step_matches_jax(setup):
    jp, model, jcfg, tcfg, x = setup
    rng = np.random.default_rng(5)
    jkv = JG.build_text_kv_caches(jp["ar"], jcfg, x["txt"], jnp.asarray(x["txt_mask"]))
    tkv = TG.build_text_kv_caches(model.ar.p, tcfg, _t(x["txt"]), _t(x["txt_mask"]))
    jstate = JG.init_ar_conv_state(jcfg, 1)
    bufs = TG.init_ar_conv_state(tcfg, 1)
    for _ in range(6):
        xb = rng.standard_normal((1, 64)).astype(np.float32)
        jl, jstate = JG.ar_step(jp["ar"], jcfg, xb, jstate, jkv)
        tl, bufs = TG.ar_step(model.ar.p, tcfg, _t(xb), bufs, tkv)
        close(t2n(tl), jl, STACK_TOL)
    # the packed buffer keeps older history too; each block reads its tail
    for i, jb in enumerate(jstate):
        close(t2n(bufs[i, :, -jb.shape[1]:]), jb, STACK_TOL)


SETTINGS = {
    "near_greedy": dict(top_p=0.9, temperature=1e-4, anti_loop=False),
    "production": dict(top_p=0.9, temperature=1.05, anti_loop=True),
}


@pytest.mark.parametrize("name", list(SETTINGS))
@pytest.mark.parametrize("seed", [7, 11])
def test_plain_ar_loop_tokens_match_jax(setup, name, seed):
    """The plain loop (K1's CPU route) gives JAX ar_generate's tokens,
    t, first_eos and stop flag."""
    jp, model, jcfg, tcfg, x = setup
    s = SETTINGS[name]
    jset = JM.ARSettings(
        top_p=jnp.float32(s["top_p"]), temperature=jnp.float32(s["temperature"]),
        recovery_top_p=jnp.float32(0.85), recovery_temp=jnp.float32(1.2),
        min_gen_frames=jnp.int32(4), anti_loop=s["anti_loop"],
    )
    jc = JM.ar_generate(jp, jcfg, jnp.asarray(x["cond"]), jnp.asarray(x["txt"]),
                        jnp.asarray(x["txt_mask"]), jax.random.PRNGKey(seed), jset, S)
    tc = TM.ar_generate(model, _t(x["cond"]), _t(x["txt"]), _t(x["txt_mask"]), seed,
                        TM.ARSettings(min_gen_frames=4, **s), S)
    np.testing.assert_array_equal(t2n(tc.tokens), np.asarray(jc.tokens))
    assert int(tc.t[0]) == int(jc.t[0])
    assert int(tc.first_eos[0]) == int(jc.first_eos[0])
    assert bool(tc.stopped[0]) == bool(jc.stopped[0])
    np.testing.assert_array_equal(t2n(tc.hist), np.asarray(jc.hist))


def test_ar_two_chunks_equal_one_run(setup):
    _, model, _, tcfg, x = setup
    cond, txt, mask = _t(x["cond"]), _t(x["txt"]), _t(x["txt_mask"])
    sett = TM.ARSettings(min_gen_frames=4)
    full = TM.ar_generate(model, cond, txt, mask, 3, sett, S)
    ctx = TM.ar_context(model, txt, mask)
    carry = TM.init_ar_carry(tcfg, 1, S, 3, "cpu")
    carry = TM.ar_chunk(carry, cond, ctx, sett, 9)
    carry = TM.ar_chunk(carry, cond, ctx, sett, S)
    for f in ("tokens", "t", "first_eos", "stopped", "hist", "key", "streak", "last", "bufs"):
        assert torch.equal(getattr(carry, f), getattr(full, f)), f


@pytest.mark.parametrize("b,t,h,hd,v", [(2, 37, 3, 64, 256), (1, 21, 4, 32, 2048)])
def test_nar_heads_match_jax_kernel(b, t, h, hd, v):
    rng = np.random.default_rng(b * 1000 + t)
    z = rng.standard_normal((b, t, hd)).astype(np.float32)
    hid = rng.standard_normal((h, hd)).astype(np.float32)
    w = (rng.standard_normal((h, hd, v)) * 0.05).astype(np.float32)
    bias = (rng.standard_normal((h, v)) * 0.05).astype(np.float32)
    want = j_nar_heads(jnp.asarray(z), jnp.asarray(hid), jnp.asarray(w), jnp.asarray(bias),
                       interpret=True)
    got = nar_heads_argmax(_t(z), _t(hid), _t(w), _t(bias))
    assert got.dtype == torch.int32 and tuple(got.shape) == (b, t, h)
    np.testing.assert_array_equal(t2n(got), np.asarray(want))


def test_nar_heads_tie_to_lowest_index():
    b, t, h, hd, v = 1, 8, 2, 8, 128
    z, hid = torch.zeros(b, t, hd), torch.zeros(h, hd)
    w, bias = torch.zeros(h, hd, v), torch.zeros(h, v)
    assert torch.all(nar_heads_argmax(z, hid, w, bias) == 0)
    bias[:, 37] = 1.0
    bias[:, 90] = 1.0
    got = nar_heads_argmax(z, hid, w, bias)
    want = j_nar_heads(jnp.zeros((b, t, hd)), jnp.zeros((h, hd)), jnp.zeros((h, hd, v)),
                       jnp.asarray(bias.numpy()), interpret=True)
    assert torch.all(got == 37)
    np.testing.assert_array_equal(t2n(got), np.asarray(want))


def test_nar_refine_matches_jax(setup):
    jp, model, jcfg, tcfg, x = setup
    rng = np.random.default_rng(8)
    cond = rng.standard_normal((1, S, 64)).astype(np.float32)
    rvq1 = rng.integers(0, 33, (1, S)).astype(np.int32)
    mask = np.arange(S)[None] < 19
    want = JM.nar_refine(jp, jcfg, jnp.asarray(cond), jnp.asarray(rvq1), mask=jnp.asarray(mask))
    got = TM.nar_refine(model, _t(cond), _t(rvq1), mask=_t(mask))
    np.testing.assert_array_equal(t2n(got), np.asarray(want))
