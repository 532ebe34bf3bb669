"""The torch port's Mimi decode against the JAX package on the CPU: RVQ
dequant, the 12.5 -> 25 Hz upsample, the decoder transformer, the SEANet
decoder (kernel K3's plain version and its CPU route) and the full decode,
each within 1e-4 (fp32 stacks; the frameworks sum in different orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sopro_tpu.codec import mimi_jax as JMI
from sopro_tpu.codec.mimi_config import decoder_plan as j_decoder_plan
from sopro_tpu.codec.mimi_config import upsample_spec as j_upsample_spec

from sopro_tpu_torch import weights as W
from sopro_tpu_torch.codec import mimi as TMI
from sopro_tpu_torch.codec.mimi_config import decoder_plan, upsample_spec
from sopro_tpu_torch.codec.vocoder import pack_seanet_decoder, seanet_decode

from tests.test_torch_ops import STACK_TOL, close, make_trees, t2n, to_jax

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mimi():
    _, tree, _, _, jm, tm = make_trees()
    dec = W.mimi_params_from_jax(tree, tm, "cpu")
    rng = np.random.default_rng(9)
    codes = rng.integers(0, 33, (2, 7, 8)).astype(np.int32)  # 32 is clamped
    return to_jax(tree), dec, jm, tm, codes


def test_decode_stages_match_jax(mimi):
    jp, dec, jm, tm, codes = mimi
    p = dec.p
    je = JMI.rvq_decode(jp["quantizer"], jnp.asarray(codes))
    te = TMI.rvq_decode(p["quantizer"], torch.from_numpy(codes))
    close(t2n(te), je, STACK_TOL)
    ju = JMI.mimi_convt(jp["upsample"], je, j_upsample_spec(jm))
    tu = TMI.mimi_convt(p["upsample"], te, upsample_spec(tm))
    close(t2n(tu), ju, STACK_TOL)
    pos = np.arange(ju.shape[1])
    np.testing.assert_array_equal(
        t2n(TMI.sliding_causal_bias(torch.from_numpy(pos), torch.from_numpy(pos), 6)),
        np.asarray(JMI.sliding_causal_bias(jnp.asarray(pos), jnp.asarray(pos), 6)),
    )
    jt = JMI.mimi_transformer(jp["dec_tf"], jm, ju, jnp.asarray(pos))
    tt = TMI.mimi_transformer(p["dec_tf"], tm, tu, torch.from_numpy(pos))
    close(t2n(tt), jt, STACK_TOL)


def test_seanet_matches_jax(mimi):
    jp, dec, jm, tm, _ = mimi
    emb = np.random.default_rng(10).standard_normal((2, 9, 32)).astype(np.float32)
    want = JMI.seanet_apply(jp["decoder"], j_decoder_plan(jm), jnp.asarray(emb))
    got = TMI.seanet_apply(dec.p["decoder"], decoder_plan(tm), torch.from_numpy(emb))
    close(t2n(got), want, STACK_TOL)
    routed = seanet_decode(pack_seanet_decoder(dec.p["decoder"], tm), tm, torch.from_numpy(emb))
    assert routed.shape == (2, 9 * 12)
    close(t2n(routed), np.asarray(want)[..., 0], STACK_TOL)


def test_mimi_decode_matches_jax(mimi):
    jp, dec, jm, tm, codes = mimi
    want = JMI.mimi_decode(jp, jm, jnp.asarray(codes))
    got = dec(torch.from_numpy(codes))
    assert got.shape == (2, 7 * tm.hop_length)
    close(t2n(got), want, STACK_TOL)
    close(t2n(TMI.mimi_decode(dec.p, tm, torch.from_numpy(codes))), want, STACK_TOL)
