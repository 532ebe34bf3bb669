"""The torch port's sampler against the JAX package on the CPU: Threefry
bits, key derivation and the full-vocab sampler must be bit-identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sopro_tpu import sampling as JS
from sopro_tpu_torch import sampling as TS

torch.set_num_threads(1)

U32 = np.uint32


def _u32(x):
    return np.asarray(x).astype(np.int64) & 0xFFFFFFFF


def test_threefry_split_uniform_bit_exact():
    rng = np.random.default_rng(0)
    k0, k1, x0, x1 = (rng.integers(0, 2**32, 64, dtype=np.uint64).astype(U32) for _ in range(4))
    ja, jb = JS.threefry2x32(k0, k1, x0, x1)
    ta, tb = TS.threefry2x32(*(torch.from_numpy(v.astype(np.int64)) for v in (k0, k1, x0, x1)))
    np.testing.assert_array_equal(ta.numpy(), _u32(ja))
    np.testing.assert_array_equal(tb.numpy(), _u32(jb))

    keys = rng.integers(0, 2**32, (5, 2), dtype=np.uint64).astype(U32)
    jn, js = JS.split_keys(jnp.asarray(keys))
    tn, ts = TS.split_keys(torch.from_numpy(keys.astype(np.int64)))
    np.testing.assert_array_equal(tn.numpy(), _u32(jn))
    np.testing.assert_array_equal(ts.numpy(), _u32(js))

    ids = rng.integers(0, 2049, (5, 37)).astype(np.int32)
    np.testing.assert_array_equal(
        TS.uniform_for_ids(torch.from_numpy(keys.astype(np.int64)), torch.from_numpy(ids)).numpy(),
        np.asarray(JS.uniform_for_ids(jnp.asarray(keys), jnp.asarray(ids))),
    )


@pytest.mark.parametrize("seed", [0, 1, 7, 42, 12345, 2**31 - 1, -1, -77])
def test_prng_key_and_split_match_jax_random(seed):
    want_key = np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))
    np.testing.assert_array_equal(TS.prng_key(seed).numpy(), _u32(want_key))
    for b in (1, 3):
        want = np.asarray(jax.random.split(jax.random.PRNGKey(seed), b))
        np.testing.assert_array_equal(TS.split_rows(TS.prng_key(seed), b).numpy(), _u32(want))


def test_sample_full_vocab_identical_tokens():
    """Identical tokens on identical logits over 300 random rows with varied
    top_p, temperature and membership masks, plus a degenerate row."""
    rng = np.random.default_rng(1)
    b, v = 300, 2049
    logits = (rng.standard_normal((b, v)) * rng.uniform(0.5, 6.0, (b, 1))).astype(np.float32)
    logits[0] = -np.inf  # degenerate: no finite mass -> argmax fallback
    logits[1, :5] = np.nan
    member = rng.random((b, v)) < rng.uniform(0.0, 0.05, (b, 1))
    top_p = rng.uniform(0.05, 1.0, (b, 1)).astype(np.float32)
    top_p[2] = 1e-5
    temp = rng.uniform(0.05, 1.6, (b, 1)).astype(np.float32)
    keys = rng.integers(0, 2**32, (b, 2), dtype=np.uint64).astype(U32)
    want = JS.sample_full_vocab(
        jnp.asarray(keys[:, 0:1]), jnp.asarray(keys[:, 1:2]), jnp.asarray(logits),
        jnp.asarray(member), jnp.asarray(top_p), jnp.asarray(temp),
    )
    kt = torch.from_numpy(keys.astype(np.int64))
    got = TS.sample_full_vocab(
        kt[:, 0:1], kt[:, 1:2], torch.from_numpy(logits), torch.from_numpy(member),
        torch.from_numpy(top_p), torch.from_numpy(temp),
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_history_helpers_match_jax():
    rng = np.random.default_rng(2)
    b = 6
    hist = rng.integers(0, 4, (b, JS.HIST_LEN)).astype(np.int32)
    hist[0, :] = np.tile([1, 2, 3], 17)[-JS.HIST_LEN:]  # exact 3-cycle
    hist[1, :40] = -1
    t = np.array([50, 10, 3, 60, 0, 32], np.int32)
    streak = np.array([0, 9, 8, 2, 9, 1], np.int32)
    ht, tt, st = (torch.from_numpy(x) for x in (hist, t, streak))
    np.testing.assert_array_equal(TS.repeated_tail(ht, tt).numpy(),
                                  np.asarray(JS.repeated_tail(jnp.asarray(hist), jnp.asarray(t))))
    for enabled in (True, False):
        jt = JS.anti_loop_settings(jnp.asarray(hist), jnp.asarray(t), jnp.asarray(streak),
                                   (jnp.float32(0.9), jnp.float32(1.05)),
                                   (jnp.float32(0.85), jnp.float32(1.2)), enabled=enabled)
        tt2 = TS.anti_loop_settings(ht, tt, st, (0.9, 1.05), (0.85, 1.2), enabled=enabled)
        for a, c in zip(tt2, jt):
            np.testing.assert_array_equal(a.numpy(), np.asarray(c))
    tok = rng.integers(0, 4, b).astype(np.int32)
    last = rng.integers(0, 4, b).astype(np.int32)
    np.testing.assert_array_equal(TS.push_history(ht, torch.from_numpy(tok)).numpy(),
                                  np.asarray(JS.push_history(jnp.asarray(hist), jnp.asarray(tok))))
    js_, jl = JS.update_streak(jnp.asarray(streak), jnp.asarray(last), jnp.asarray(tok), jnp.asarray(t))
    ts_, tl = TS.update_streak(st, torch.from_numpy(last), torch.from_numpy(tok), tt)
    np.testing.assert_array_equal(ts_.numpy(), np.asarray(js_))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
