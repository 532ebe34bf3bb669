"""The port's CLI and profiling on the CPU: `--help` and the exit code 2
cases as subprocesses; synthesize, `--stream`, `--long`, `--metrics_json`
and `--trace_dir` in-process through `cli.main(argv)`, with `from_random`
building the small test configuration (the WAV equals `SoproTTS.synthesize`
at the same seed, bit for bit); the hub flags and the server's
SOPRO_REVISION / HF_TOKEN reach `from_pretrained`; the FLOP counters equal the JAX package's
at the small and the full configuration, and the training step's count
agrees with torch's own FLOP counter at full width; the new modules and
chip_smoke.py import no JAX.
"""

import json
import os
import subprocess
import sys
import wave

import numpy as np
import pytest
import torch

from sopro_tpu import profiling as JP
from sopro_tpu.codec.mimi_config import MimiConfig as JMimiCfg
from sopro_tpu.config import SoproTTSConfig as JCfg

from sopro_tpu_torch import audio as A
from sopro_tpu_torch import cli
from sopro_tpu_torch import profiling as TP
from sopro_tpu_torch.codec.mimi_config import MimiConfig
from sopro_tpu_torch.config import SoproTTSConfig
from sopro_tpu_torch.tts import SoproTTS

from tests.test_torch_cuda import CFG, SMALL_MIMI, TRAIN_CFG, make_batch, torch_batch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXT = "Hello there."
SEED = 3
MAX_FRAMES = 20


def run_cli(args):
    return subprocess.run([sys.executable, "-m", "sopro_tpu_torch.cli", *args], cwd=REPO,
                          capture_output=True, text=True, timeout=300)


def test_help_lists_the_flags():
    r = run_cli(["--help"])
    assert r.returncode == 0, r.stderr[-2000:]
    for flag in ("--ref_audio", "--ref_tokens", "--max_frames", "--device", "--trace_dir",
                 "--stream", "--long", "--metrics_json", "--random_init", "--revision"):
        assert flag in r.stdout, flag


@pytest.mark.parametrize("extra,message", [
    ([], "exactly one"),
    (["--ref_tokens", "x.npy", "--ref_audio", "x.wav"], "exactly one"),
    (["--ref_tokens", "x.npy", "--stream", "--long"], "mutually exclusive"),
])
def test_bad_reference_arguments_exit_2(tmp_path, extra, message):
    if "--ref_tokens" in extra and "--stream" not in extra:
        np.save(tmp_path / "x.npy", np.zeros((4, 8), np.int32))
        extra = [str(tmp_path / a) if a.startswith("x.") else a for a in extra]
    r = run_cli(["--text", "hi", "--random_init", "--device", "cpu",
                 "--out", str(tmp_path / "o.wav"), *extra])
    assert r.returncode == 2, r.stderr[-2000:]
    assert message in r.stderr


@pytest.fixture
def small(monkeypatch, tmp_path):
    """`from_random` builds the small configuration; a reference .npy."""
    build = SoproTTS.from_random.__func__

    def from_random(cls, cfg=None, *, seed=0, device="cuda", **kw):
        return build(cls, SoproTTSConfig(**CFG), seed=seed, mimi_cfg=MimiConfig(**SMALL_MIMI),
                     device=device)

    monkeypatch.setattr(SoproTTS, "from_random", classmethod(from_random))
    ref = np.random.default_rng(1).integers(0, 32, (14, 8)).astype(np.int32)
    np.save(tmp_path / "ref.npy", ref)
    tts = SoproTTS.from_random(seed=SEED, device="cpu")
    return tts, ref, ["--random_init", "--device", "cpu", "--seed", str(SEED), "--quiet",
                      "--ref_tokens", str(tmp_path / "ref.npy"), "--max_frames", str(MAX_FRAMES)]


def read_wav(path):
    with wave.open(str(path), "rb") as f:
        assert f.getframerate() == 24000 and f.getnchannels() == 1 and f.getsampwidth() == 2
        return np.frombuffer(f.readframes(f.getnframes()), np.int16)


def test_cli_wav_equals_synthesize(small, tmp_path, capsys):
    tts, ref, argv = small
    out, trace = tmp_path / "o.wav", tmp_path / "trace"
    assert cli.main([*argv, "--text", TEXT, "--out", str(out), "--metrics_json",
                     "--trace_dir", str(trace)]) == 0
    want = tts.synthesize(TEXT, ref_tokens_tq=ref, max_frames=MAX_FRAMES, seed=SEED, pcm16=True)
    assert want.size > 0
    np.testing.assert_array_equal(read_wav(out), want[0])
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(metrics) == {"ttfa_ms", "wall_s", "audio_s", "rtf", "frames_per_s"}
    assert metrics["audio_s"] == round(want.shape[1] / 24000, 3) and metrics["ttfa_ms"] is None
    events = json.loads((trace / TP.TRACE_FILE).read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)


def test_cli_stream_equals_stream(small, tmp_path, capsys):
    tts, ref, argv = small
    out = tmp_path / "s.wav"
    assert cli.main([*argv, "--text", TEXT, "--out", str(out), "--stream",
                     "--chunk_frames", "5", "--metrics_json"]) == 0
    chunks = list(tts.stream(TEXT, ref_tokens_tq=ref, max_frames=MAX_FRAMES, seed=SEED,
                             chunk_frames=5))
    assert len(chunks) > 1
    np.testing.assert_array_equal(read_wav(out), A.pcm16(np.concatenate(chunks, axis=1))[0])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["ttfa_ms"] > 0


def test_cli_long_equals_synthesize_long(small, tmp_path, monkeypatch):
    """Chunks of at most 12 characters, so a text the small configuration's
    text table holds still splits into three rows of one batch."""
    from sopro_tpu_torch import tts as tts_mod

    split = tts_mod.split_sentences
    monkeypatch.setattr(tts_mod, "split_sentences", lambda text, max_chars: split(text, 12))
    tts, ref, argv = small
    text = "First one. Second. Third!"
    assert len(tts_mod.split_sentences(text, 350)) == 3
    out = tmp_path / "l.wav"
    assert cli.main([*argv, "--text", text, "--out", str(out), "--long", "--gap_ms", "50"]) == 0
    want = tts.synthesize_long(text, ref_tokens_tq=ref, max_frames=MAX_FRAMES, seed=SEED,
                               gap_ms=50, pcm16=True)
    assert want.size > 0
    np.testing.assert_array_equal(read_wav(out), want[0])


def _record_from_pretrained(monkeypatch, calls):
    """`SoproTTS.from_pretrained` records its arguments and returns the small
    configuration's `from_random(seed=SEED)` on the CPU."""

    def from_pretrained(cls, repo_id, **kw):
        calls.append(dict(kw, repo_id=repo_id))
        return SoproTTS.from_random(seed=SEED, device="cpu")

    monkeypatch.setattr(SoproTTS, "from_pretrained", classmethod(from_pretrained))


@pytest.mark.parametrize("given", [True, False], ids=["flags", "defaults"])
def test_cli_passes_the_hub_flags_to_from_pretrained(small, tmp_path, monkeypatch, given):
    """--revision, --cache_dir and --token reach `from_pretrained` as the JAX
    CLI passes them (None where absent), with --repo and --mimi_repo; the WAV
    is that model's `synthesize`."""
    tts, ref, argv = small
    calls = []
    _record_from_pretrained(monkeypatch, calls)
    hub = ["--revision", "v2", "--cache_dir", str(tmp_path / "hub"), "--token", "hf_x"] if given else []
    out = tmp_path / "p.wav"
    assert cli.main([a for a in argv if a != "--random_init"] + hub + [
        "--repo", "org/m", "--mimi_repo", "org/mimi", "--text", TEXT, "--out", str(out)]) == 0
    want = dict(revision="v2", cache_dir=str(tmp_path / "hub"), token="hf_x") if given else dict(
        revision=None, cache_dir=None, token=None)
    assert calls == [dict(want, repo_id="org/m", mimi_repo_id="org/mimi", device="cpu")]
    np.testing.assert_array_equal(
        read_wav(out), tts.synthesize(TEXT, ref_tokens_tq=ref, max_frames=MAX_FRAMES, seed=SEED,
                                      pcm16=True)[0])


@pytest.mark.parametrize("env", [{"SOPRO_REVISION": "v3", "HF_TOKEN": "hf_y"},
                                 {"SOPRO_REVISION": "", "HF_TOKEN": ""}], ids=["set", "empty"])
def test_server_passes_sopro_revision_and_hf_token(small, monkeypatch, env):
    """`ServerConfig` reads SOPRO_REVISION and HF_TOKEN (empty -> None, as in
    the JAX package) and `get_tts` hands them to `from_pretrained` with
    SOPRO_REPO_ID and SOPRO_MIMI_REPO_ID."""
    from sopro_tpu_torch.serve import server as core

    for k, v in dict(env, SOPRO_REPO_ID="org/m", SOPRO_MIMI_REPO_ID="org/mimi", SOPRO_DEVICE="cpu",
                     SOPRO_SLOTS="1", SOPRO_MAX_FRAMES=str(MAX_FRAMES), SOPRO_RANDOM_INIT="").items():
        monkeypatch.setenv(k, v)
    calls = []
    _record_from_pretrained(monkeypatch, calls)
    monkeypatch.setattr(core, "CFG", core.ServerConfig())
    monkeypatch.setattr(core, "_tts", None)
    monkeypatch.setattr(core, "_batcher", None)
    _, batcher = core.get_tts()
    batcher.stop()
    assert calls == [dict(repo_id="org/m", revision=env["SOPRO_REVISION"] or None,
                          token=env["HF_TOKEN"] or None, mimi_repo_id="org/mimi", device="cpu")]


@pytest.mark.parametrize("cfg", [TRAIN_CFG, CFG, {}], ids=["train", "small", "full"])
def test_flop_counters_equal_jax(cfg):
    jcfg, tcfg = JCfg(**cfg), SoproTTSConfig(**cfg)
    for text_len in (1, 64, 2048):
        assert TP.ar_step_flops(tcfg, text_len) == JP.ar_step_flops(jcfg, text_len)
        assert TP.ar_loop_flops(tcfg, 3, text_len, 401) == JP.ar_loop_flops(jcfg, 3, text_len, 401)
    for b, t in ((1, 401), (8, 197)):
        assert TP.nar_heads_flops(tcfg, b, t) == JP.nar_heads_flops(jcfg, b, t)
    for mcfg in (SMALL_MIMI, {}):
        assert (TP.seanet_decoder_flops(MimiConfig(**mcfg), 2, 802)
                == JP.seanet_decoder_flops(JMimiCfg(**mcfg), 2, 802))


def test_train_step_flops_against_torch_flop_counter():
    """At full width `train_step_flops` counts what torch's FlopCounterMode
    counts in `loss_fn` and its backward, within 1 % (the count leaves out
    Token2SV's 192-wide stack); the counter's depthwise-conv backward, which
    it counts as a dense conv, is taken as twice the forward conv."""
    from torch.utils.flop_counter import FlopCounterMode

    from sopro_tpu_torch import train as T
    from sopro_tpu_torch import weights as W

    cfg = SoproTTSConfig()
    model = W.sopro_params_from_jax(W.init_sopro_params(0, cfg, 259), cfg, "cpu")
    b, l, tr, s = 2, 10, 6, 12
    nb = make_batch(b=b, l=l, tr=tr, s=s, cb=cfg.codebook_size, q=cfg.num_codebooks)
    nb["text_mask"][:], nb["ref_mask"][:] = True, True
    with FlopCounterMode(display=False) as fc:
        loss, _ = T.loss_fn(model, torch_batch(nb))
        loss.backward()
    ops = {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}
    counted = (fc.get_total_flops() - ops["aten.convolution_backward"]
               + 2 * ops["aten.convolution"])
    assert abs(TP.train_step_flops(cfg, b, s, l, tr) / counted - 1) < 0.01


def test_new_modules_and_chip_smoke_leave_jax_out():
    """The training, data-parallel, CLI, profiling and native modules, the
    kernel tools and chip_smoke.py import neither JAX nor the JAX package (a
    fresh interpreter)."""
    code = (
        "import sys, chip_smoke, sopro_tpu_torch.train, sopro_tpu_torch.parallel, "
        "sopro_tpu_torch.cli, sopro_tpu_torch.profiling, sopro_tpu_torch.native, "
        "sopro_tpu_torch.bench_kernels, sopro_tpu_torch.bench_ar, "
        "sopro_tpu_torch.bench_ablation, sopro_tpu_torch.bench_csm\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'sopro_tpu' or m.startswith('sopro_tpu.')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
