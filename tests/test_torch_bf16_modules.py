"""The port's modules under RuntimeConfig(compute_dtype="bfloat16") against
the JAX package's XLA path under its own bfloat16 policy, on the CPU: the
same float32 trees, each cast to bfloat16 by its own package's engine.

XLA keeps excess precision inside its fusions and rounds to bfloat16 at
other places than eager torch, which rounds after every op, so floats are
held within 5e-2 of their peak (a few bfloat16 steps, 2^-8 each, summed
over a block stack), and ids and codes equal wherever the deciding top-2
margin exceeds 5e-2 of the peak score. Each test's docstring gives the
worst value measured on this CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sopro_tpu.codec import mimi_jax as JMI
from sopro_tpu.config import RuntimeConfig as JRuntime
from sopro_tpu.engine import Engine as JEngine
from sopro_tpu.models import nar as JN
from sopro_tpu.models import sopro as JM

from sopro_tpu_torch import weights as W
from sopro_tpu_torch.codec import mimi as TMI
from sopro_tpu_torch.codec.mimi_config import downsample_spec, encoder_plan
from sopro_tpu_torch.config import RuntimeConfig
from sopro_tpu_torch.engine import Engine
from sopro_tpu_torch.models import nar as TN
from sopro_tpu_torch.models import sopro as TM

from tests.test_torch_bf16_kernels import f32
from tests.test_torch_encode import _audible_encoder
from tests.test_torch_ops import make_trees, to_jax
from tests.test_torch_streaming import audible_decoder

torch.set_num_threads(1)

TOL = 5e-2
BF16 = "bfloat16"


def rel(got, want) -> float:
    """max |got - want| / peak |want| (any float dtypes)."""
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


def ids_agree(got, want, scores, tol=TOL) -> int:
    """Asserts ids `got` equal `want` wherever the top-2 margin of `scores`
    ([..., V], the side that produced `want`) exceeds tol of its peak;
    returns the number that differ."""
    s = f32(scores).astype(np.float64)
    top2 = -np.sort(-s, axis=-1)[..., :2]
    near = (top2[..., 0] - top2[..., 1]) <= tol * np.abs(s).max()
    differ = np.asarray(got) != np.asarray(want)
    assert not (differ & ~near).any()
    return int(differ.sum())


@pytest.fixture(scope="module")
def engines():
    tree, mimi, jcfg, tcfg, jm, tm = make_trees(seed=6)
    audible_decoder(mimi)
    _audible_encoder(mimi)
    jeng = JEngine(to_jax(tree), jcfg, to_jax(mimi), jm, JRuntime(compute_dtype=BF16))
    eng = Engine(W.sopro_params_from_jax(tree, tcfg, "cpu"), W.mimi_params_from_jax(mimi, tm, "cpu"),
                 RuntimeConfig(compute_dtype=BF16))
    ref = np.random.default_rng(12).integers(0, 32, (40, 8)).astype(np.int32)
    ids = np.asarray([ord(c) for c in "a second, longer request"], np.int32)
    return jeng, eng, jcfg, tcfg, jm, tm, ref, ids


def test_prepare_reference_bf16(engines):
    """Token2SV, the reference encoder and the ref x-attn KV (worst
    measured: 4.8e-3 of peak)."""
    jeng, eng, *_, ref, _ = engines
    jr, pr = jeng.prepare_reference(ref), eng.prepare_reference(ref)
    assert pr.ref_seq.dtype == torch.bfloat16
    worst = max(rel(pr.sv_ref, jr.sv_ref), rel(pr.ref_seq, jr.ref_seq),
                *(rel(p[k], j[k]) for p, j in zip(pr.ref_kv, jr.ref_kv) for k in ("k", "v")))
    assert worst <= TOL, worst


def test_prepare_conditioning_bf16(engines):
    """The text encoder, the speaker FiLM and the ref x-attn over the
    prepared reference (worst measured: 9.1e-3 of peak)."""
    jeng, eng, *_, ref, ids = engines
    jp = jeng.prepare_conditioning(ids, jeng.prepare_reference(ref), max_frames=20,
                                   style_strength=1.0)
    pp = eng.prepare_conditioning(ids, eng.prepare_reference(ref), max_frames=20,
                                  style_strength=1.0)
    assert pp["cond_ar"].dtype == torch.bfloat16
    worst = max(rel(pp["txt_seq"], jp["txt_seq"]), rel(pp["cond_ar"], jp["cond_ar"]))
    assert worst <= TOL, worst


def test_nar_stage_logits_bf16(engines):
    """Every NAR stage's logits, teacher-forced: both packages on JAX's
    conditioning and on JAX's ids of the earlier codebooks (worst measured:
    6.0e-3 of peak; 1 id differs, at a near-tie)."""
    jeng, eng, jcfg, tcfg, *_, ref, ids = engines
    jp = jeng.prepare_conditioning(ids, jeng.prepare_reference(ref), max_frames=20,
                                   style_strength=1.0)
    cond = jp["cond_ar"]
    rvq1 = np.random.default_rng(3).integers(0, 32, (1, cond.shape[1])).astype(np.int32)
    jids = np.asarray(JM.nar_refine(jeng.params, jcfg, cond, jnp.asarray(rvq1)))
    tcond = torch.from_numpy(f32(cond)).to(torch.bfloat16)
    spec, jspec = TM.cb_spec(tcfg), JM.cb_spec(jcfg)
    prev_cbs, worst, differ = [0], 0.0, 0
    for stage in tcfg.stage_order():
        idx = tcfg.stage_indices()[stage]
        prev = jids[..., prev_cbs]
        jemb = JM.cb_sum_embed_subset(jeng.params["cb_embed"], jspec, jnp.asarray(prev), prev_cbs,
                                      cb_weights=jeng.params["nar_prev_cb_weights"])
        jl = JN.nar_forward_stage(jeng.params["nar"], jcfg, stage, cond, jemb)
        p = eng.model.shared.p
        temb = TM.cb_sum_embed_subset(p["cb_embed"], spec, torch.from_numpy(prev), prev_cbs,
                                      cb_weights=p["nar_prev_cb_weights"])
        tl = TN.nar_forward_stage(eng.model.nar.p, tcfg, stage, tcond, temb)
        worst = max(worst, rel(tl, jl))
        differ += ids_agree(f32(tl).argmax(-1), jids[..., idx], jl)
        prev_cbs = prev_cbs + list(idx)
    assert worst <= TOL, worst


def test_mimi_decode_bf16(engines):
    """RVQ dequant, upsample, decoder transformer and SEANet from the same
    codes: the port's decode (K3's plain version) against JAX's XLA decode
    (worst measured: 8.2e-3 of peak)."""
    jeng, eng, *_ = engines
    codes = np.random.default_rng(9).integers(0, 32, (17, 8)).astype(np.int32)
    got, want = eng.decode(codes), jeng.decode(codes)
    assert got.dtype == np.float32 and got.shape == want.shape == (1, 17 * eng.mimi_cfg.hop_length)
    assert rel(got, want) <= TOL


def test_mimi_encode_latents_bf16(engines):
    """The SEANet encoder, encoder transformer and downsample on a float32
    waveform with bfloat16 weights (JAX promotes the weights to the
    waveform's float32, and so does the port), and the first semantic and
    acoustic codes (worst measured: 5.0e-7 of peak; 0 codes differ)."""
    jeng, eng, *_, jm, tm, _, _ = engines
    wav = (np.random.default_rng(5).standard_normal((1, 40 * 12)) * 0.3).astype(np.float32)
    jp, tp = jeng.mimi_params, eng.mimi.p
    jx = JMI.seanet_apply(jp["encoder"], JMI.encoder_plan(jm), jnp.asarray(wav)[..., None])
    jx = JMI.mimi_transformer(jp["enc_tf"], jm, jx, jnp.arange(jx.shape[1]))
    jx = JMI.mimi_conv(jp["downsample"], jx, JMI.downsample_spec(jm))
    with torch.inference_mode():
        tx = TMI.seanet_apply(tp["encoder"], encoder_plan(tm), torch.from_numpy(wav)[..., None])
        tx = TMI.mimi_transformer(tp["enc_tf"], tm, tx, torch.arange(tx.shape[1]))
        tx = TMI.mimi_conv(tp["downsample"], tx, downsample_spec(tm))
    assert tx.dtype == torch.float32
    assert rel(tx, jx) <= TOL
    q, jq = tp["quantizer"], jp["quantizer"]
    ns = tm.num_semantic_quantizers
    for proj, emb in (("in_proj_sem", 0), ("in_proj_ac", ns)):
        res = f32(jx) @ f32(jq[proj])
        e = f32(jq["embed"][emb])
        scores = 2.0 * res @ e.T - (e * e).sum(-1)
        want = scores.argmax(-1)
        got = TMI._nearest_code(q["embed"][emb], tx @ q[proj].float()).numpy()
        ids_agree(got, want, scores)
    got_codes = TMI.rvq_encode(q, tm, tx).numpy()
    assert got_codes.shape == (1, tx.shape[1], tm.num_quantizers)
