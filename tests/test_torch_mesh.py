"""The port's device mesh (`sopro_tpu_torch.parallel.mesh`) for serving and
batch synthesis, on the CPU: the mesh's shards are entries of
`devices=[torch.device("cpu")] * n`, as the JAX tests run on the 8 virtual
CPU devices of tests/conftest.py.

- `make_mesh`: shapes and errors as `sopro_tpu.parallel.make_mesh`.
- `ContinuousBatcher(mesh=)`: every session against the port's solo stream
  (rtol 1e-4, atol 1e-5: the same arithmetic on other batch shapes), and
  against the JAX batcher over `make_mesh(8, dp=8, tp=1)` (tokens exact,
  waveforms within 1e-4 of the peak; zero decoder conv biases and
  (max_frames + 1) % 4 == 0, as tests/test_torch_serve.py sets up).
- `synthesize_batch(mesh=)`: against the unsharded port and JAX's batch over
  `make_mesh(2, dp=2, tp=1)`, within 1e-4 of each row's peak, lengths equal.
- `bench_state`'s conditioning and text KV against JAX's within 1e-5.
"""

import numpy as np
import pytest
import torch

from sopro_tpu.engine import Engine as JEngine
from sopro_tpu.parallel import make_mesh as j_make_mesh
from sopro_tpu.serve.scheduler import ContinuousBatcher as JBatcher
from sopro_tpu.tokenizer import SimpleCharTokenizer as JTok
from sopro_tpu.tts import SoproTTS as JTTS

from sopro_tpu_torch.parallel import make_mesh, row_blocks
from sopro_tpu_torch.serve import ContinuousBatcher
from sopro_tpu_torch.serve import server as core

from tests.test_torch_batch import MAX_FRAMES as BATCH_MAX_FRAMES
from tests.test_torch_batch import assert_rows_close, build_pair
from tests.test_torch_ops import make_trees, to_jax
from tests.test_torch_serve import MAX_FRAMES, REF_TOKENS, _cat, _close, _drain, _port, _solo
from tests.test_torch_streaming import audible_decoder

torch.set_num_threads(1)

CPU = torch.device("cpu")


def cpu_mesh(n, **kw):
    return make_mesh(n, devices=[CPU] * n, **kw)


@pytest.fixture(scope="module")
def tts():
    tree, mimi, _, cfg, _, mcfg = make_trees(seed=6)
    audible_decoder(mimi)
    return _port(tree, mimi, cfg, mcfg)


@pytest.fixture(scope="module")
def ref(tts):
    return tts.prepare_reference(ref_tokens_tq=REF_TOKENS)


@pytest.mark.parametrize("n,kw", [(2, {}), (8, {}), (8, dict(dp=8, tp=1)), (8, dict(tp=4)),
                                  (1, {})])
def test_make_mesh_shapes_match_jax(n, kw):
    mesh = cpu_mesh(n, **kw)
    assert mesh.shape == dict(j_make_mesh(n, **kw).shape)
    assert mesh.devices.shape == (mesh.shape["dp"], mesh.shape["tp"])
    assert all(d == CPU for d in mesh.devices.ravel())


def test_make_mesh_errors_match_jax():
    for n, kw in ((8, dict(dp=3, tp=2)), (6, dict(dp=2))):
        with pytest.raises(ValueError) as jerr:
            j_make_mesh(n, **kw)
        with pytest.raises(ValueError) as err:
            cpu_mesh(n, **kw)
        assert str(err.value) == str(jerr.value)
    with pytest.raises(ValueError, match="need 9 devices, have 8"):
        j_make_mesh(9)
    with pytest.raises(ValueError, match="need 9 devices, have 8"):
        make_mesh(9, devices=[CPU] * 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(2)  # no card here, and no devices= given
    mesh = make_mesh(devices=["cpu", "cpu", "cpu", "cpu"])
    assert mesh.shape == {"dp": 2, "tp": 2}
    assert row_blocks(8, 4) == [(0, 2), (2, 4), (4, 6), (6, 8)]
    with pytest.raises(ValueError, match="do not split"):
        row_blocks(6, 4)


def test_mesh_batcher_matches_solo(tts, ref):
    """dp = 8 over eight CPU entries: one slot a shard; every session ships
    its solo stream (ramp off: ramp_frames = chunk_frames)."""
    texts, seeds = ["alpha one", "beta two two", "gamma three"], [11, 22, 33]
    b = ContinuousBatcher(tts, slots=8, chunk_frames=4, text_bucket=16, max_frames=MAX_FRAMES,
                          mesh=cpu_mesh(8, dp=8, tp=1))
    try:
        assert len(b.states) == 8 and all(st.carry.t.shape == (1,) for st in b.states)
        handles = [b.submit(t, ref, seed=s) for t, s in zip(texts, seeds)]
        outs = [_cat(_drain(h)) for h in handles]
    finally:
        b.stop()
    for t, s, out, h in zip(texts, seeds, outs, handles):
        assert out.shape[1] > 0
        _close(out, _solo(tts, ref, t, s))
    stats = b.stats()
    assert stats["sessions_done"] == 3
    # shards 0-2 held the sessions; the others never ran a tick
    assert [h.slot for h in handles] == [0, 1, 2]
    assert all(n > 0 for n in stats["shard_ticks"][:3]) and stats["shard_ticks"][3:] == [0] * 5
    assert stats["ticks"] == max(stats["shard_ticks"])
    assert len(stats["shard_dispatch_ms_p50"]) == 8
    with pytest.raises(AttributeError, match="states"):
        b.state


def test_mesh_batcher_matches_the_jax_mesh_batcher():
    """dp = 8 in both packages, on the same weights and requests, a session
    a shard (8 of them: one group fills every slot, so the admit grace ends
    at once): the decoded tokens (left in the slots' state) exact, waveforms
    within 1e-4 of the peak."""
    tree, mimi, jcfg, cfg, jm, tm = make_trees(seed=6)
    audible_decoder(mimi)
    for layer in mimi["decoder"]:
        for conv in ([layer] if "w" in layer else layer.get("convs", [])):
            conv["b"] = np.zeros_like(conv["b"])
    port = _port(tree, mimi, cfg, tm)
    jtts = JTTS(JEngine(to_jax(tree), jcfg, to_jax(mimi), jm), jcfg, JTok())
    kw = dict(slots=8, chunk_frames=4, text_bucket=16, max_frames=19, admit_grace_ms=60_000.0)
    texts = ("alpha one", "beta two two", "gamma three", "delta", "epsilon five", "zeta six",
             "eta seven", "theta eight")
    seeds = tuple(11 * (i + 1) for i in range(8))
    outs = {}
    for name, make, r in (
        ("port", lambda: ContinuousBatcher(port, mesh=cpu_mesh(8, dp=8, tp=1), **kw),
         port.prepare_reference(ref_tokens_tq=REF_TOKENS)),
        ("jax", lambda: JBatcher(jtts, mesh=j_make_mesh(8, dp=8, tp=1), **kw),
         jtts.engine.prepare_reference(REF_TOKENS)),
    ):
        b = make()
        try:
            handles = [b.submit(t, r, seed=s) for t, s in zip(texts, seeds)]
            outs[name] = [_cat(_drain(h, timeout=600)) for h in handles]
        finally:
            b.stop()
        outs[name + "_tokens"] = (np.concatenate([st.carry.tokens.numpy() for st in b.states])
                                  if name == "port" else np.asarray(b.carry.tokens))
    np.testing.assert_array_equal(outs["port_tokens"], outs["jax_tokens"])
    for got, want in zip(outs["port"], outs["jax"]):
        assert got.shape == want.shape and got.shape[1] > 0
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * float(np.abs(want).max()))


def test_dp2_join_mid_flight_lands_on_the_second_shard(tts, ref):
    """4 slots on dp = 2 (2 a shard): after `warmup` (its session on shard
    0, a scratch state on shard 1: the batcher's own shard 1 untouched), two
    sessions fill shard 0, a third joins while they decode and takes slot
    2, on shard 1; every session ships its solo stream. min_gen_frames =
    max_frames keeps the first two decoding to the cap, so the join is
    mid-flight."""
    kw = dict(min_gen_frames=MAX_FRAMES)
    warm = ContinuousBatcher(tts, slots=4, chunk_frames=4, ramp_frames=2, text_bucket=16,
                             max_frames=MAX_FRAMES, mesh=cpu_mesh(2))
    try:
        warm.warmup(ref)
    finally:
        warm.stop()
    assert warm.stats()["sessions_done"] == 1 and warm.stats()["shard_ticks"][1] == 0
    assert bool(warm.states[1].carry.stopped.all()) and not warm.states[1].carry.t.any()
    b = ContinuousBatcher(tts, slots=4, chunk_frames=4, text_bucket=16, max_frames=MAX_FRAMES,
                          mesh=cpu_mesh(2))
    try:
        first = [b.submit(t, ref, seed=s, **kw) for t, s in (("alpha one", 11), ("beta two", 22))]
        head = first[0].out.get(timeout=120)  # shard 0 is decoding
        late = b.submit("gamma three", ref, seed=33, **kw)
        outs = [_cat([head] + _drain(first[0])), _cat(_drain(first[1])), _cat(_drain(late))]
    finally:
        b.stop()
    assert [h.slot for h in first + [late]] == [0, 1, 2]
    for (t, s), out in zip((("alpha one", 11), ("beta two", 22), ("gamma three", 33)), outs):
        _close(out, _solo(tts, ref, t, s, **kw))
    assert all(n > 0 for n in b.stats()["shard_ticks"])


def test_slots_must_divide_by_dp(tts):
    jtree, jmimi, jcfg, _, jm, _ = make_trees(seed=6)
    jtts = JTTS(JEngine(to_jax(jtree), jcfg, to_jax(jmimi), jm), jcfg, JTok())
    with pytest.raises(ValueError) as jerr:
        JBatcher(jtts, slots=3, text_bucket=16, max_frames=MAX_FRAMES,
                 mesh=j_make_mesh(2, dp=2, tp=1))
    with pytest.raises(ValueError) as err:
        ContinuousBatcher(tts, slots=3, text_bucket=16, max_frames=MAX_FRAMES,
                          mesh=cpu_mesh(2, dp=2, tp=1))
    assert str(err.value) == str(jerr.value) == "slots=3 must divide by dp=2"


def test_synthesize_batch_over_a_mesh_matches_unsharded_and_jax():
    """4 rows in two text buckets (one duplicated) over dp = 2: with one
    group, and with pipeline_group=3, which JAX rounds to 2 (each group's
    shards pad to the group's bucket). A group that dp does not divide
    raises."""
    jtts, port, ref_tokens = build_pair()
    texts = ("hello there", "a second, longer request", "hello there", "short one")
    seeds = (3, 5, 3, 4)
    jref, pref = (jtts.prepare_reference(ref_tokens_tq=ref_tokens),
                  port.prepare_reference(ref_tokens_tq=ref_tokens))
    kw = dict(max_frames=BATCH_MAX_FRAMES, seeds=seeds)
    flat = port.synthesize_batch(texts, ref=pref, **kw)
    for group in (None, 3):
        got = port.synthesize_batch(texts, ref=pref, pipeline_group=group, mesh=cpu_mesh(2),
                                    **kw)
        assert_rows_close(got, flat)
        np.testing.assert_array_equal(got[0], got[2])
    want = jtts.synthesize_batch(texts, ref=jref, pipeline_group=3,
                                 mesh=j_make_mesh(2, dp=2, tp=1), **kw)
    assert_rows_close(got, want)
    with pytest.raises(ValueError, match="do not split"):
        port.synthesize_batch(texts[:3], ref=pref, mesh=cpu_mesh(2), **kw)


def test_bench_state_matches_jax():
    """Every slot live on one text: the conditioning and the text KV (at
    the text's positions) within 1e-5 of JAX's `bench_state`, per shard."""
    tree, mimi, jcfg, cfg, jm, tm = make_trees(seed=6)
    port = _port(tree, mimi, cfg, tm)
    jtts = JTTS(JEngine(to_jax(tree), jcfg, to_jax(mimi), jm), jcfg, JTok())
    kw = dict(slots=4, chunk_frames=4, text_bucket=16, max_frames=MAX_FRAMES)
    text = "bench tick"
    _, jcond, jkv, _, _, _ = JBatcher(jtts, **kw).bench_state(
        jtts.engine.prepare_reference(REF_TOKENS), text)
    pref = port.prepare_reference(ref_tokens_tq=REF_TOKENS)
    n = len(port.encode_text(text))
    jk = np.stack([np.asarray(kv["k"]) for kv in jkv if kv is not None])  # [A, B, H, L, hd]
    jv = np.stack([np.asarray(kv["v"]) for kv in jkv if kv is not None])
    single = ContinuousBatcher(port, **kw)
    meshed = ContinuousBatcher(port, mesh=cpu_mesh(2), **kw)
    st = single.bench_state(pref, text)
    shards = meshed.bench_state(pref, text)
    assert len(shards) == 2 and all(s.cond.shape[0] == 2 for s in shards)
    for cond, kv_k, kv_v, mask, emitted, stopped in (
        (st.cond, st.kv_k, st.kv_v, st.text_mask, st.emitted, st.carry.stopped),
        *((s.cond, s.kv_k, s.kv_v, s.text_mask, s.emitted, s.carry.stopped) for s in shards),
    ):
        b = cond.shape[0]
        np.testing.assert_allclose(cond.numpy(), np.asarray(jcond)[:b], atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(kv_k.numpy()[:, :, :, :n], jk[:, :b, :, :n], atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(kv_v.numpy()[:, :, :, :n], jv[:, :b, :, :n], atol=1e-5, rtol=1e-5)
        assert mask[:, :n].all() and not mask[:, n:].any()
        assert not emitted.any() and not stopped.any()


def test_sopro_dp_builds_a_mesh_batcher_on_the_cpu(tts, monkeypatch):
    """SOPRO_DP=2 with SOPRO_DEVICE=cpu: the server's batcher splits its
    slots over two CPU shards."""
    from sopro_tpu_torch import tts as T

    monkeypatch.setenv("SOPRO_DP", "2")
    monkeypatch.setenv("SOPRO_DEVICE", "cpu")
    monkeypatch.setenv("SOPRO_RANDOM_INIT", "1")
    monkeypatch.setenv("SOPRO_SLOTS", "4")
    monkeypatch.setenv("SOPRO_MAX_FRAMES", str(MAX_FRAMES))
    monkeypatch.setattr(core, "CFG", core.ServerConfig())
    monkeypatch.setattr(core, "_tts", None)
    monkeypatch.setattr(core, "_batcher", None)
    asked = {}

    def from_random(*args, **kw):
        asked.update(kw)
        return tts

    monkeypatch.setattr(T.SoproTTS, "from_random", staticmethod(from_random))
    got, batcher = core.get_tts()
    try:
        assert got is tts and asked["device"] == "cpu"
        assert batcher.mesh.shape == {"dp": 2, "tp": 1}
        assert [st.carry.t.shape[0] for st in batcher.states] == [2, 2]
        assert all(e is tts.engine for e in batcher.engines)  # shards on the engine's own device
    finally:
        batcher.stop()
