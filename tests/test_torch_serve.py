"""The torch port's continuous-batching scheduler and HTTP servers on the CPU.

The key property: a session that shares the batch with others ships what
it would ship alone. With the ramp off (ramp_frames >= chunk_frames) that
is the port's own `SoproTTS.stream` at the same chunk, seed and reference;
with a ramp, a mid-flight join leaves an established session's waveform as
it was alone. One test holds the port's batcher against the JAX package's
on the same weights: 2 slots, chunk 4, zero decoder conv biases (where the
JAX stream's zero history is the causal padding) and (max_frames + 1) % 4
== 0 (where the JAX tick does not clamp its last window).

Tolerances: waveforms rtol 1e-4 / atol 1e-5 against the port's own stream
(the same arithmetic on other batch shapes), 1e-4 of the peak against JAX;
frame counts and PCM exact. The Mimi decoder is rescaled (`audible_decoder`)
so waveforms follow the tokens.
"""

import io
import json
import struct
import urllib.request
import wave

import numpy as np
import pytest
import torch

from sopro_tpu.engine import Engine as JEngine
from sopro_tpu.serve import server as JServer
from sopro_tpu.serve.scheduler import ContinuousBatcher as JBatcher
from sopro_tpu.tokenizer import SimpleCharTokenizer as JTok
from sopro_tpu.tts import SoproTTS as JTTS

from sopro_tpu_torch import weights as W
from sopro_tpu_torch.engine import Engine
from sopro_tpu_torch.config import RuntimeConfig
from sopro_tpu_torch.serve import ContinuousBatcher
from sopro_tpu_torch.serve import server as core
from sopro_tpu_torch.tokenizer import SimpleCharTokenizer
from sopro_tpu_torch.tts import SoproTTS

from tests.test_serve import _call_route, _install_fastapi_stub, _post
from tests.test_torch_cuda import CFG
from tests.test_torch_ops import make_trees, to_jax
from tests.test_torch_streaming import audible_decoder

torch.set_num_threads(1)

MAX_FRAMES = CFG["max_frames"]  # 20: 21 frames a session
REF_TOKENS = np.random.default_rng(0).integers(0, CFG["codebook_size"],
                                               (10, CFG["num_codebooks"])).astype(np.int32)


def _port(tree, mimi, cfg, mcfg, runtime=None) -> SoproTTS:
    return SoproTTS(Engine(W.sopro_params_from_jax(tree, cfg, "cpu"),
                           W.mimi_params_from_jax(mimi, mcfg, "cpu"), runtime),
                    cfg, SimpleCharTokenizer(), runtime)


@pytest.fixture(scope="module")
def tts():
    tree, mimi, _, cfg, _, mcfg = make_trees(seed=6)
    audible_decoder(mimi)
    return _port(tree, mimi, cfg, mcfg)


@pytest.fixture(scope="module")
def ref(tts):
    return tts.prepare_reference(ref_tokens_tq=REF_TOKENS)


def _batcher(tts, **kw):
    kw = dict(dict(slots=3, chunk_frames=4, text_bucket=16, max_frames=MAX_FRAMES), **kw)
    return ContinuousBatcher(tts, **kw)


def _cat(chunks):
    return np.concatenate(chunks, axis=1) if chunks else np.zeros((1, 0), np.float32)


def _solo(tts, ref, text, seed, cf=4, **kw):
    return _cat(list(tts.stream(text, ref=ref, max_frames=MAX_FRAMES, chunk_frames=cf,
                                seed=seed, **kw)))


def _close(got, want):
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def _drain(h, timeout=120):
    chunks = []
    while True:
        c = h.out.get(timeout=timeout)
        if c is None:
            if h.error is not None:
                raise h.error
            return chunks
        chunks.append(c)


def test_concurrent_sessions_match_solo(tts, ref):
    texts, seeds = ["alpha one", "beta two two", "gamma three"], [11, 22, 33]
    b = _batcher(tts)
    try:
        handles = [b.submit(t, ref, seed=s) for t, s in zip(texts, seeds)]
        outs = [_cat(_drain(h)) for h in handles]
    finally:
        b.stop()
    for t, s, out in zip(texts, seeds, outs):
        assert out.shape[1] > 0
        _close(out, _solo(tts, ref, t, s))
    assert b.stats()["sessions_done"] == 3


def test_sessions_join_mid_flight(tts, ref):
    """A session that joins while another decodes matches its solo stream,
    and so does the established one."""
    b = _batcher(tts)
    try:
        ha = b.submit("first one", ref, seed=5)
        first = ha.out.get(timeout=120)  # A is decoding
        hb = b.submit("late joiner", ref, seed=8)
        out_a = _cat([first] + _drain(ha))
        out_b = _cat(_drain(hb))
    finally:
        b.stop()
    _close(out_a, _solo(tts, ref, "first one", 5))
    _close(out_b, _solo(tts, ref, "late joiner", 8))


def test_ramp_grid_and_a_join_leaves_a_co_resident_as_it_was(tts, ref):
    """chunk 8, ramp 2: each session's first chunk is 2 frames, and a
    mid-flight join does not change an established session's waveform
    (against each session alone in a batcher)."""
    hop = tts.engine.mimi_cfg.hop_length
    solos = {}
    b = _batcher(tts, chunk_frames=8, ramp_frames=2)
    try:
        for t, s in (("alpha one", 11), ("beta two two", 22)):
            chunks = _drain(b.submit(t, ref, seed=s))
            assert chunks[0].shape[1] == 2 * hop
            solos[s] = _cat(chunks)
        assert b.ramp_ticks >= 2
    finally:
        b.stop()
    b = _batcher(tts, chunk_frames=8, ramp_frames=2)
    try:
        ha = b.submit("alpha one", ref, seed=11)
        first = ha.out.get(timeout=120)
        assert first.shape[1] == 2 * hop
        hb = b.submit("beta two two", ref, seed=22)
        wav_a, wav_b = _cat([first] + _drain(ha)), _cat(_drain(hb))
    finally:
        b.stop()
    _close(wav_a, solos[11])
    _close(wav_b, solos[22])


def test_production_grid_and_frame_count(tts, ref):
    """slots 8, chunk 16, ramp 4: the first chunk is 4 frames, interior ones
    16, and the frame count equals `generate_tokens` at the same seed."""
    hop = tts.engine.mimi_cfg.hop_length
    b = _batcher(tts, slots=8, chunk_frames=16, ramp_frames=4)
    try:
        chunks = _drain(b.submit("alpha one", ref, seed=11))
    finally:
        b.stop()
    assert chunks[0].shape[1] == 4 * hop
    assert all(c.shape[1] == 16 * hop for c in chunks[1:-1])
    want = tts.generate_tokens("alpha one", ref, max_frames=MAX_FRAMES, seed=11).shape[0]
    assert sum(c.shape[1] for c in chunks) == want * hop


def test_more_sessions_than_slots(tts, ref):
    """Seven sessions on three slots: the overflow waits and joins as slots
    free up, each session as it would run alone."""
    b = _batcher(tts)
    try:
        handles = [b.submit(f"text {i}", ref, seed=i) for i in range(7)]
        outs = [_cat(_drain(h)) for h in handles]
    finally:
        b.stop()
    for i, (h, out) in enumerate(zip(handles, outs)):
        _close(out, _solo(tts, ref, f"text {i}", i))
        assert (h.first_chunk_s is not None) == (out.shape[1] > 0)
    assert sum(out.shape[1] > 0 for out in outs) >= 5
    assert b.stats()["sessions_done"] == 7 and b.admit_groups >= 3


def test_submits_from_many_threads(tts, ref):
    """Twelve client threads submit at once (more than this box's cores)
    with a short switch interval: every session completes and ships what
    it would ship alone."""
    import sys
    import threading

    b = _batcher(tts)
    outs = {}

    def client(i):
        outs[i] = _cat(_drain(b.submit(f"client {i}", ref, seed=60 + i)))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(12)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
        b.stop()
    assert sorted(outs) == list(range(12)) and b.stats()["sessions_done"] == 12
    for i in (0, 11):
        _close(outs[i], _solo(tts, ref, f"client {i}", 60 + i))


def test_cancel_frees_the_slot(tts, ref):
    b = _batcher(tts, slots=1)
    try:
        ha = b.submit("long run one", ref, seed=41)
        ha.out.get(timeout=120)
        ha.cancel()
        assert len(_drain(ha)) < 4
        hb = b.submit("after cancel", ref, seed=42)
        _close(_cat(_drain(hb)), _solo(tts, ref, "after cancel", 42))
    finally:
        b.stop()


def test_pcm16_is_the_rounded_float(tts, ref):
    outs = {}
    for pcm16 in (False, True):
        b = _batcher(tts, slots=2, pcm16=pcm16)
        try:
            outs[pcm16] = _drain(b.submit("alpha one", ref, seed=11))
        finally:
            b.stop()
    assert len(outs[True]) == len(outs[False])
    for q, f in zip(outs[True], outs[False]):
        assert q.dtype == np.int16
        np.testing.assert_array_equal(q, np.round(np.clip(f, -1.0, 1.0) * 32767.0).astype(np.int16))


def test_anti_loop_off_matches_solo(tts, ref):
    """anti_loop=False rides as recovery settings equal to the normal ones:
    the same tokens as a stream that never checks for loops."""
    b = _batcher(tts)
    try:
        out = _cat(_drain(b.submit("delta four", ref, seed=44, anti_loop=False)))
    finally:
        b.stop()
    _close(out, _solo(tts, ref, "delta four", 44, anti_loop=False))


def test_submit_validates_text_and_seed(tts, ref):
    b = _batcher(tts)
    try:
        for seed in (2 ** 31, -(2 ** 31) - 1):
            with pytest.raises(ValueError, match="int32"):
                b.submit("hi", ref, seed=seed)
        with pytest.raises(ValueError, match="bucket"):
            b.submit("x " * 20, ref)
        out = _cat(_drain(b.submit("edge", ref, seed=2 ** 31 - 1)))
    finally:
        b.stop()
    _close(out, _solo(tts, ref, "edge", 2 ** 31 - 1))


def test_warmup_runs_every_ref_bucket(tts, ref):
    rt = RuntimeConfig(ref_buckets=(16, 32))
    eng = Engine(tts.engine.model, tts.engine.mimi, rt)
    b = ContinuousBatcher(SoproTTS(eng, tts.cfg, tts.tokenizer, rt), slots=2, chunk_frames=4,
                          text_bucket=16, max_frames=MAX_FRAMES)
    try:
        b.warmup()
        assert b.stats()["sessions_done"] == 2 and b.admit_groups == 2
        b.reset_stats()  # what a benchmark does before its traffic
        stats = b.stats()
        assert (stats["sessions_done"], stats["ticks"], stats["admit_groups"]) == (0, 0, 0)
        assert stats["ttfa_p50_ms"] is None and stats["tick_dispatch_ms_p50"] is None
        out = _cat(_drain(b.submit("after warmup", ref, seed=4)))
    finally:
        b.stop()
    stats = b.stats()
    assert stats["sessions_done"] == 1 and stats["ticks"] >= 1 and out.shape[1] > 0
    assert stats["ttfa_p50_ms"] is not None


def test_spro_helpers_bytes_equal_jax():
    rng = np.random.default_rng(1)
    wav = (rng.standard_normal((1, 500)) * 0.7).astype(np.float32)
    pcm = np.round(np.clip(wav, -1, 1) * 32767).astype(np.int16)
    for x in (wav, pcm, wav[0]):
        assert core.float_to_pcm16le(x) == JServer.float_to_pcm16le(x)
    assert core.wav_bytes_from_float(wav, 24000) == JServer.wav_bytes_from_float(wav, 24000)
    assert core.stream_header(24000, 1) == JServer.stream_header(24000, 1)
    assert core.frame(b"abc") == JServer.frame(b"abc")
    assert core.sha256_bytes(b"x") == JServer.sha256_bytes(b"x")
    for rid in ("0" * 64, "a1b2" * 16, "../../etc/passwd", "A" * 64, "0" * 63, "", None):
        assert core.valid_ref_id(rid) == JServer.valid_ref_id(rid)
    assert core.ServerConfig().max_frames == JServer.ServerConfig().max_frames == 2000


def test_jax_npz_reference_loads_in_the_port(tmp_path):
    """A reference cached by the JAX server's `save_prepared_reference`
    loads in the port and synthesizes as the port's own reference does."""
    tree, mimi, jcfg, cfg, jm, tm = make_trees(seed=8)
    port = _port(tree, mimi, cfg, tm)
    jeng = JEngine(to_jax(tree), jcfg, to_jax(mimi), jm)
    path = str(tmp_path / "ref.npz")
    JServer.save_prepared_reference(path, jeng.prepare_reference(REF_TOKENS))
    loaded = core.load_prepared_reference(path)
    own = port.prepare_reference(ref_tokens_tq=REF_TOKENS)
    np.testing.assert_allclose(loaded.ref_seq.numpy(), own.ref_seq.numpy(), rtol=1e-4, atol=1e-5)
    assert loaded.ref_kv[0]["mask"].dtype == torch.bool
    kw = dict(max_frames=12, seed=3)
    np.testing.assert_allclose(port.synthesize("after restart", ref=loaded, **kw),
                               port.synthesize("after restart", ref=own, **kw), rtol=1e-4, atol=1e-6)
    back = str(tmp_path / "port.npz")
    core.save_prepared_reference(back, own)
    theirs = JServer.load_prepared_reference(back)
    np.testing.assert_array_equal(np.asarray(theirs.ref_seq), own.ref_seq.numpy())
    for jkv, kv in zip(theirs.ref_kv, own.ref_kv):
        assert set(jkv) == set(kv)
        for k in kv:
            np.testing.assert_array_equal(np.asarray(jkv[k]), kv[k].numpy())


def _wav_upload(sr):
    wav = np.random.default_rng(0).standard_normal(sr) * 0.3
    bio = io.BytesIO()
    with wave.open(bio, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes((np.clip(wav, -1, 1) * 32767).astype("<i2").tobytes())
    return bio.getvalue()


def _spro_frames(data):
    assert data[:4] == b"SPRO" and struct.unpack("<II", data[4:12]) == (24000, 1)
    off, total = 12, 0
    while off < len(data):
        (n,) = struct.unpack("<I", data[off: off + 4])
        off, total = off + 4 + n, total + n
    assert off == len(data)
    return total


def test_stdlib_http_contract(tts, monkeypatch, tmp_path):
    """The SPRO wire protocol and the endpoints over real sockets."""
    from sopro_tpu_torch.serve import server_stdlib as srv

    b = _batcher(tts, slots=2, pcm16=True)
    monkeypatch.setattr(core, "_tts", tts)
    monkeypatch.setattr(core, "_batcher", b)
    monkeypatch.setattr(core.CFG, "ref_cache_dir", str(tmp_path / "refcache"))
    httpd = srv.serve("127.0.0.1", 0)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            assert r.status == 200 and json.loads(r.read())["ok"]
        sr = int(tts.engine.mimi_cfg.sampling_rate)
        code, _, body = _post(f"{base}/v1/reference/cache", {"ref_seconds": "0.016"},
                              {"ref_audio": ("ref.wav", _wav_upload(sr))})
        assert code == 200, body
        rid = json.loads(body)["ref_id"]
        code, _, body = _post(f"{base}/v1/reference/cache", {"ref_seconds": "0.016"},
                              {"ref_audio": ("ref.webm", b"\x1aE\xdf\xa3 not audio")})
        assert code == 400 and b"WAV" in body
        speech = f"{base}/v1/audio/speech"
        for fields, want in (
            ({"input": "hi", "ref_id": "../../etc/passwd"}, 400),
            ({"input": "hi", "ref_id": "0" * 64}, 404),
            ({"input": "hi"}, 400),
            ({"input": "  ", "ref_id": rid}, 400),
            ({"input": "x " * 20, "ref_id": rid, "ref_seconds": "0.016"}, 400),
            ({"input": "hi", "ref_id": rid, "ref_seconds": "0.016", "seed": str(2 ** 31)}, 400),
            ({"input": "hi", "ref_id": rid, "ref_seconds": "0.016", "max_frames": "many"}, 400),
            ({"input": "hi", "ref_id": rid, "ref_seconds": "short"}, 400),
        ):
            assert _post(speech, fields)[0] == want, fields
        code, headers, body = _post(speech, {"input": "hello", "ref_id": rid, "stream": "false",
                                             "ref_seconds": "0.016", "max_frames": "8"})
        assert code == 200 and headers["Content-Type"].startswith("audio/wav")
        assert body[:4] == b"RIFF" and headers["X-Sopro-Max-Frames"] == "8"
        code, headers, _ = _post(speech, {"input": "hello", "ref_id": rid, "stream": "false",
                                          "ref_seconds": "0.016", "max_frames": "600"})
        assert code == 200 and headers["X-Sopro-Max-Frames"] == str(MAX_FRAMES)
        code, _, data = _post(speech, {"input": "hello stream", "ref_id": rid, "stream": "true",
                                       "ref_seconds": "0.016", "max_frames": "8"})
        assert code == 200 and _spro_frames(data) % (2 * tts.engine.mimi_cfg.hop_length) == 0
        assert len(data) > 12
        with urllib.request.urlopen(f"{base}/v1/stats", timeout=30) as r:
            stats = json.loads(r.read())
        assert stats["slots"] == 2 and stats["sessions_done"] >= 3
    finally:
        httpd.shutdown()
        b.stop()


def test_fastapi_routes_execute(tts, monkeypatch, tmp_path):
    """`build_app`'s route bodies through a stub fastapi (none is
    installed): reference cache, a WAV and a SPRO stream."""
    fastapi = _install_fastapi_stub(monkeypatch)
    b = _batcher(tts, slots=2)
    monkeypatch.setattr(core, "_tts", tts)
    monkeypatch.setattr(core, "_batcher", b)
    monkeypatch.setattr(core.CFG, "ref_cache_dir", str(tmp_path / "fc"))
    try:
        routes = core.build_app().routes
        assert routes[("GET", "/healthz")]()["ok"]
        sr = int(tts.engine.mimi_cfg.sampling_rate)
        out = _call_route(routes[("POST", "/v1/reference/cache")],
                          ref_audio=fastapi.UploadFile("ref.wav", _wav_upload(sr)), ref_seconds=0.016)
        speech = routes[("POST", "/v1/audio/speech")]
        resp = _call_route(speech, input="hello", ref_id=out["ref_id"], ref_seconds=0.016,
                           max_frames=8)
        assert resp.media_type == "audio/wav" and resp.content[:4] == b"RIFF"
        sresp = _call_route(speech, input="hello", ref_id=out["ref_id"], ref_seconds=0.016,
                            max_frames=8, stream=True)
        assert _spro_frames(b"".join(sresp.gen)) > 0
        try:
            _call_route(speech, input="hi", ref_id="../evil")
        except Exception as e:
            assert getattr(e, "status_code", None) == 400
        else:
            raise AssertionError("a malformed ref_id was accepted")
    finally:
        b.stop()


def test_port_batcher_matches_the_jax_batcher():
    """The port's `ContinuousBatcher` against the JAX package's on the same
    weights and requests: 2 slots, chunk 4, zero decoder conv biases,
    max_frames 19 ((19 + 1) % 4 == 0). Waveforms within 1e-4 of the peak,
    and the decoded tokens (left in each slot's state) exact."""
    tree, mimi, jcfg, cfg, jm, tm = make_trees(seed=6)
    audible_decoder(mimi)
    for layer in mimi["decoder"]:
        for conv in ([layer] if "w" in layer else layer.get("convs", [])):
            conv["b"] = np.zeros_like(conv["b"])
    port = _port(tree, mimi, cfg, tm)
    jtts = JTTS(JEngine(to_jax(tree), jcfg, to_jax(mimi), jm), jcfg, JTok())
    kw = dict(slots=2, chunk_frames=4, text_bucket=16, max_frames=19, admit_grace_ms=60_000.0)
    jref = jtts.engine.prepare_reference(REF_TOKENS)
    pref = port.prepare_reference(ref_tokens_tq=REF_TOKENS)
    texts, seeds = ("alpha one", "beta two two"), (11, 22)
    outs = {}
    for name, make, r in (("port", lambda: ContinuousBatcher(port, **kw), pref),
                          ("jax", lambda: JBatcher(jtts, **kw), jref)):
        b = make()
        try:
            handles = [b.submit(t, r, seed=s) for t, s in zip(texts, seeds)]
            outs[name] = [_cat(_drain(h, timeout=600)) for h in handles]
        finally:
            b.stop()
        outs[name + "_tokens"] = np.asarray((b.state.carry if name == "port" else b.carry).tokens)
    np.testing.assert_array_equal(outs["port_tokens"], outs["jax_tokens"])
    for got, want in zip(outs["port"], outs["jax"]):
        assert got.shape == want.shape and got.shape[1] > 0
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * float(np.abs(want).max()))
