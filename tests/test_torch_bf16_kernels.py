"""The kernels' plain versions in bfloat16 -- what the port runs on the CPU
under RuntimeConfig(compute_dtype="bfloat16"), and what chip_smoke.py holds
each bfloat16 kernel against on the card -- against the JAX package's
Pallas kernels in bfloat16, interpret mode, on the same bfloat16 inputs.

Both sides round at the same points (the TPU kernels' `astype` calls) and
differ only in float32 summation order, so a value can land one bfloat16
step (2^-8 relative) away and carry that on. Bars, with the worst values
measured on this CPU:
- K2: ids equal wherever the float64 top-2 margin of the rounded z + hid
  exceeds 1e-4 (measured: 0 of 862 ids differ);
- K3 / K4: waveforms within 1e-2 of their peak, a little over two bfloat16
  steps at the peak (measured: 7.1e-3 and 7.7e-3 of peak);
- K5: per step on the same state, float32 logits and bfloat16 ring buffers
  within 1e-2 of their peak (measured: 1.4e-7 and 0);
- K1: tokens equal up to the first step whose plain penalized top-2 margin
  is within 1e-2 of the peak logit (measured: equal over all 20 steps), the
  ring buffers then within 1e-2 of their peak (measured: 6.6e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sopro_tpu.codec.convert import init_mimi_params as j_init_mimi
from sopro_tpu.codec.mimi_config import MimiConfig as JMimiCfg
from sopro_tpu.codec.pallas_vocoder import (
    pack_seanet_decoder as j_pack, seanet_decode_pallas, seanet_decode_pallas_chunk,
)
from sopro_tpu.models import generator as JG
from sopro_tpu.ops.pallas_ar import HEAD_PAD, ar_step_pallas, pad_kv_heads, stack_ar_params
from sopro_tpu.ops.pallas_ar_loop import ResidentLoopContext, ar_loop_pallas
from sopro_tpu.ops.pallas_nar import nar_heads_argmax as j_nar_heads

from sopro_tpu_torch import kernels
from sopro_tpu_torch import weights as W
from sopro_tpu_torch.codec.mimi_config import MimiConfig, required_halo
from sopro_tpu_torch.codec.vocoder import pack_seanet_decoder, seanet_decode, seanet_decode_chunk
from sopro_tpu_torch.models import sopro as TM
from sopro_tpu_torch.models.base import tree_map
from sopro_tpu_torch.ops.ar_loop import ARLoopContext, ar_loop_plain
from sopro_tpu_torch.ops.ar_step import ARStepContext, ar_step
from sopro_tpu_torch.ops.nar_heads import nar_heads_argmax

from chip_smoke import RecordingContext, first_divergence
from tests.test_torch_cuda import BF16_TOL
from tests.test_torch_ops import make_trees
from tests.test_torch_streaming import PALLAS_MIMI, audible_decoder

torch.set_num_threads(1)

AR_OVER = dict(n_layers_ar=4, ar_dilation_cycle=(1, 2, 4, 1))  # tests/test_torch_ar_step.py


def jbf(x):
    """numpy -> JAX bfloat16 (round to nearest even)."""
    return jnp.asarray(np.asarray(x, np.float32)).astype(jnp.bfloat16)


def tbf(x):
    """numpy -> torch bfloat16 (round to nearest even)."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32))).to(torch.bfloat16)


def f32(x):
    """A JAX or torch array of any float dtype -> numpy float32."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def jtree_bf16(tree):
    return jax.tree.map(
        lambda a: jnp.asarray(a).astype(jnp.bfloat16) if np.issubdtype(np.asarray(a).dtype, np.floating)
        else jnp.asarray(a), tree)


def within(got, want, tol=BF16_TOL):
    """max |got - want| / peak |want|, asserted <= tol; returned."""
    got, want = f32(got), f32(want)
    assert got.shape == want.shape
    rel = float(np.abs(got - want).max()) / float(np.abs(want).max())
    assert rel <= tol, rel
    return rel


@pytest.mark.parametrize("b,t,h,hd,v", [(2, 37, 3, 64, 256), (1, 40, 16, 256, 2048)])
def test_nar_heads_plain_matches_pallas_bf16(b, t, h, hd, v):
    """K2: ids of the port's plain version against `nar_heads_argmax`
    (interpret) on the same bfloat16 z, hid, W, b: z + hid rounded to
    bfloat16, float32 products and bias; equal away from near-ties."""
    rng = np.random.default_rng(b * 1000 + t)
    z = rng.standard_normal((b, t, hd))
    hid = rng.standard_normal((h, hd)) * 0.1
    w = rng.standard_normal((h, hd, v)) * 0.05
    bias = rng.standard_normal((h, v)) * 0.05
    want = np.asarray(j_nar_heads(jbf(z), jbf(hid), jbf(w), jbf(bias), interpret=True))
    kernels.reset_launches()
    got = nar_heads_argmax(tbf(z), tbf(hid), tbf(w), tbf(bias))
    assert not any(kernels.LAUNCHES_BF16.values())
    assert got.dtype == torch.int32 and tuple(got.shape) == (b, t, h)
    zh = (tbf(z)[:, :, None] + tbf(hid)[None, None]).double()
    logits = torch.einsum("bthd,hdv->bthv", zh, tbf(w).double()) + tbf(bias).double()[None, None]
    top2 = torch.topk(logits, 2, dim=-1).values
    differ = got.numpy() != want
    assert not (differ & (top2[..., 0] - top2[..., 1] > 1e-4).numpy()).any()


def _pallas_decoder(filled: bool):
    """The smallest Mimi the TPU's SEANet kernel takes (PALLAS_MIMI), its
    weights rescaled to audible (`audible_decoder`), its conv biases filled
    or left at the init's zeros, in bfloat16 on both sides."""
    jm, tm = JMimiCfg(**PALLAS_MIMI), MimiConfig(**PALLAS_MIMI)
    tree = jax.tree.map(np.array, j_init_mimi(2, jm))
    if filled:
        W.fill_zero_inits(None, tree, 3)
    audible_decoder(tree)
    jdec = jtree_bf16(tree["decoder"])
    tdec = tree_map(lambda t: t.to(torch.bfloat16), W.to_torch(tree["decoder"], "cpu"))
    return jm, tm, jdec, pack_seanet_decoder(tdec, tm)


def test_seanet_plain_matches_pallas_bf16():
    """K3: the port's plain SEANet (every conv rounded after its float32
    bias, ELUs and residual adds rounded) against `seanet_decode_pallas`
    (interpret) on the same bfloat16 embeddings: a bfloat16 waveform. The
    conv biases stay zero: the TPU kernel decodes from a zero history of
    embeddings, which is the causal zero padding only when no conv has a
    bias (ROADMAP C)."""
    jm, tm, jdec, packed = _pallas_decoder(filled=False)
    emb = np.random.default_rng(4).standard_normal((2, 13, tm.hidden_size))
    want = seanet_decode_pallas(j_pack(jdec, jm), jm, jbf(emb), interpret=True)
    got = seanet_decode(packed, tm, tbf(emb))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 13 * 960)
    within(got, want)


@pytest.fixture(scope="module")
def pallas_decoder():
    return _pallas_decoder(filled=True)


@pytest.mark.parametrize("b,m25", [(1, 4), (2, 12)])
def test_seanet_chunk_plain_matches_pallas_bf16(pallas_decoder, b, m25):
    """K4: one stream chunk with `halo` frames of real history, the port's
    plain version against `seanet_decode_pallas_chunk` (interpret)."""
    jm, tm, jdec, packed = pallas_decoder
    ext = np.random.default_rng(b * 10 + m25).standard_normal(
        (b, required_halo(tm) + m25, tm.hidden_size))
    want = seanet_decode_pallas_chunk(j_pack(jdec, jm), jm, jbf(ext), interpret=True)
    got = seanet_decode_chunk(packed, tm, tbf(ext))
    assert got.dtype == torch.bfloat16 and got.shape == (b, m25 * 960)
    within(got, want)


@pytest.fixture(scope="module")
def ar_setup():
    tree, _, jcfg, tcfg, _, _ = make_trees(seed=9, **AR_OVER)
    jp = jtree_bf16(tree)
    model = W.sopro_params_from_jax(tree, tcfg, "cpu").to(torch.bfloat16)
    rng = np.random.default_rng(3)
    b, l = 2, 12
    txt = rng.standard_normal((b, l, 64))
    mask = np.arange(l)[None, :] < np.array([9, 5])[:, None]
    kvs = JG.build_text_kv_caches(jp["ar"], jcfg, jbf(txt), jnp.asarray(mask))
    kv_k = jnp.stack([kv["k"] for kv in kvs if kv is not None])
    kv_v = jnp.stack([kv["v"] for kv in kvs if kv is not None])
    return tree, jp, model, jcfg, tcfg, kv_k, kv_v, mask


def test_ar_step_plain_matches_pallas_bf16(ar_setup):
    """K5: the port's plain step (`models/generator.py::ar_step`, K1/K5's
    rounding points) against `ar_step_pallas` (interpret) at B = 2 over 6
    steps, each side given the same bfloat16 x, ring buffers and text KV."""
    _, jp, model, jcfg, tcfg, kv_k, kv_v, mask = ar_setup
    ctx = ARStepContext(cfg=tcfg, p_ar=model.ar.p, stacked=None, kv_k=tbf(f32(kv_k)),
                        kv_v=tbf(f32(kv_v)), mask=torch.from_numpy(mask),
                        emb=TM._prev_token_table(model))
    stacked = stack_ar_params(jp["ar"], jcfg)
    rng = np.random.default_rng(5)
    bufs = f32(jbf(rng.standard_normal((4, 2, 17, 64)) * 0.5))
    for _ in range(6):
        x = rng.standard_normal((2, 64))
        jl, jb = ar_step_pallas(stacked, jcfg, jbf(x), jbf(bufs), kv_k, kv_v, jnp.asarray(mask),
                                interpret=True)
        tl, tb = ar_step(ctx, tbf(x), tbf(bufs))
        assert tl.dtype == torch.float32 and tb.dtype == torch.bfloat16
        within(tl, jl)
        within(tb, jb)
        bufs = f32(jb)


def test_ar_loop_plain_matches_pallas_bf16(ar_setup):
    """K1: 20 near-greedy steps of the port's plain loop against
    `ar_loop_pallas` (interpret) from the same bfloat16 state, conditioning,
    text KV and previous-token table: tokens equal up to the first near-tie,
    then t and the ring buffers."""
    tree, jp, model, jcfg, tcfg, kv_k, kv_v, mask = ar_setup
    n, s, b = 20, 24, 1
    cond = np.random.default_rng(6).standard_normal((b, s, 64)) * 0.5
    a, _, h, l, hd = kv_k.shape
    emb = TM._prev_token_table(model)
    jctx = ResidentLoopContext(
        stacked=stack_ar_params(jp["ar"], jcfg),
        kv_k=pad_kv_heads(kv_k[:, :b]).reshape(a, b * h, l, HEAD_PAD),
        kv_v=pad_kv_heads(kv_v[:, :b]).reshape(a, b * h, l, HEAD_PAD),
        mask=jnp.asarray(mask[:b]), emb=jbf(f32(emb)),
    )
    zeros = lambda dt: np.zeros((b,), dt)
    state = {"t": zeros(np.int32), "last": zeros(np.int32), "streak": zeros(np.int32),
             "stopped": zeros(np.int32), "first_eos": np.full((b,), s, np.int32),
             "key": np.array([[0, 7]] * b, np.uint32), "hist": np.full((b, 50), -1, np.int32)}
    bufs = np.zeros((4, b, 17, 64), np.float32)
    sett = {"top_p": np.full((b,), 0.9, np.float32), "temperature": np.full((b,), 1e-4, np.float32),
            "recovery_top_p": np.full((b,), 0.85, np.float32),
            "recovery_temp": np.full((b,), 1.2, np.float32), "min_gen": np.full((b,), 4, np.int32)}
    jtok, jst = ar_loop_pallas(
        jctx, jcfg, jbf(cond.reshape(b * s, 64)),
        dict({k: jnp.asarray(v) for k, v in state.items()}, bufs=jbf(bufs)),
        {k: jnp.asarray(v) for k, v in sett.items()}, n, s, False, interpret=True)
    kv, ai = [], 0
    for xp in model.ar.p["xattn"]:
        kv.append(None if xp is None else {"k": tbf(f32(kv_k[ai, :b])), "v": tbf(f32(kv_v[ai, :b])),
                                          "mask": torch.from_numpy(mask[:b])})
        ai += xp is not None
    rec = RecordingContext(ARLoopContext(cfg=tcfg, p_ar=model.ar.p, stacked=None, kv=kv,
                                         mask=torch.from_numpy(mask[:b]), emb=emb))
    tstate = {k: torch.from_numpy(v.astype(np.int64) if k == "key" else v) for k, v in state.items()}
    tstate["bufs"] = tbf(bufs)
    ttok, tst = ar_loop_plain(rec, tbf(cond), tstate, {k: torch.from_numpy(v) for k, v in sett.items()},
                              n, False)
    steps = int(tst["t"][0])
    jt = np.array(jtok)[0, :steps]
    first_divergence(torch.from_numpy(jt)[None], ttok[:, :steps], rec.logits, 0,
                     "K1 bf16 against the JAX kernel")
    if np.array_equal(ttok[0, :steps].numpy(), jt):
        assert steps == int(np.asarray(jst["t"])[0])
        within(tst["bufs"], jst["bufs"])
