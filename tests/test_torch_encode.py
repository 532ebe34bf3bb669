"""Reference voices from audio: the port's Mimi encode, its audio input and
the facade's audio branch against the JAX package on the CPU.

Bars: codes bit-equal (the nearest-code argmax decides far from ties on
these inputs), the resampler within 1e-4, loaded samples exact, the
prepared reference within 1e-4 (fp32 stacks).
"""

import wave

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sopro_tpu import audio as JA
from sopro_tpu.codec import mimi_jax as JMI
from sopro_tpu.engine import Engine as JEngine
from sopro_tpu.tokenizer import SimpleCharTokenizer as JTok
from sopro_tpu.tts import SoproTTS as JTTS

from sopro_tpu_torch import audio as TA
from sopro_tpu_torch import weights as W
from sopro_tpu_torch.codec import mimi as TMI
from sopro_tpu_torch.engine import Engine
from sopro_tpu_torch.tokenizer import SimpleCharTokenizer
from sopro_tpu_torch.tts import SoproTTS

from tests.test_torch_ops import STACK_TOL, close, make_trees, t2n, to_jax

torch.set_num_threads(1)


def _audible_encoder(mimi) -> None:
    """Rescale the encode half's N(0, 0.02) weights to keep the signal's
    size through each layer (std 1/sqrt(fan-in), the RVQ input projections
    3x that), so the codes follow the input rather than the biases."""
    def rescale(p):
        if isinstance(p, list):
            for v in p:
                rescale(v)
        elif isinstance(p, dict):
            if "w" in p:
                p["w"] = p["w"] / (0.02 * np.sqrt(np.prod(p["w"].shape[:-1])))
            for v in p.values():
                if isinstance(v, (dict, list)):
                    rescale(v)

    rescale(mimi["encoder"])
    rescale(mimi["downsample"])
    for k in ("in_proj_sem", "in_proj_ac"):
        w = mimi["quantizer"][k]
        mimi["quantizer"][k] = w * (3.0 / (0.02 * np.sqrt(w.shape[0])))


@pytest.fixture(scope="module")
def pair():
    tree, mimi, jcfg, tcfg, jm, tm = make_trees(seed=7)  # encoder biases filled too
    _audible_encoder(mimi)
    port = SoproTTS(Engine(W.sopro_params_from_jax(tree, tcfg, "cpu"),
                           W.mimi_params_from_jax(mimi, tm, "cpu")), tcfg, SimpleCharTokenizer())
    jtts = JTTS(JEngine(to_jax(tree), jcfg, to_jax(mimi), jm), jcfg, JTok())
    return jtts, port


def _voice(sr: int, seconds: float, seed: int = 0) -> np.ndarray:
    """A voiced stretch between two quiet ones (the VAD trims the edges)."""
    rng = np.random.default_rng(seed)
    n = int(sr * seconds)
    t = np.arange(n) / sr
    env = ((t > 0.2 * seconds) & (t < 0.8 * seconds)).astype(np.float32)
    wav = 0.3 * env * np.sin(2 * np.pi * 220 * t) + 0.05 * env * rng.standard_normal(n)
    return (wav + 1e-4 * rng.standard_normal(n)).astype(np.float32)


def _write_wav(path, wav: np.ndarray, sr: int) -> None:
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(np.round(np.clip(wav, -1, 1) * 32767).astype(np.int16).tobytes())


def test_mimi_encode_matches_jax(pair):
    jtts, port = pair
    mcfg = port.engine.mimi_cfg
    wav = np.random.default_rng(3).standard_normal((2, 11 * mcfg.hop_length)).astype(np.float32) * 0.3
    want = np.asarray(JMI.mimi_encode(jtts.engine.mimi_params, jtts.engine.mimi_cfg, jnp.asarray(wav)))
    got = t2n(TMI.mimi_encode(port.engine.mimi.p, mcfg, torch.from_numpy(wav)))
    assert got.shape == want.shape == (2, 11, mcfg.num_quantizers) and got.dtype == np.int32
    assert all(len(np.unique(got[..., q])) > 4 for q in range(mcfg.num_quantizers))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        t2n(TMI.mimi_encode(port.engine.mimi.p, mcfg, torch.from_numpy(wav), num_quantizers=3)),
        want[..., :3],
    )


def test_encode_audio_bucketed_matches_jax(pair):
    """A length that is no whole number of frames, padded to a ref bucket."""
    jtts, port = pair
    wav = _voice(24000, 0.05, seed=4)[: 37 * port.engine.mimi_cfg.hop_length - 5]
    want = jtts.engine.encode_audio(wav)
    got = port.engine.encode_audio(wav)
    assert got.shape == (37, port.cfg.num_codebooks)
    np.testing.assert_array_equal(got, want)


def test_resample_and_load_match_jax(tmp_path):
    wav = _voice(16000, 0.5, seed=5)
    close(TA.resample(wav, 16000, 24000), JA.resample(wav, 16000, 24000), STACK_TOL)
    assert TA.resample(wav, 24000, 24000).dtype == np.float32
    path = tmp_path / "ref.wav"
    _write_wav(path, wav, 16000)
    got, sr = TA.load_audio_file(str(path))
    want, jsr = JA.load_audio_file(str(path))
    assert sr == jsr == 16000
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(TA.trim_silence_energy(got, sr), JA.trim_silence_energy(want, sr))
    np.testing.assert_array_equal(TA.center_crop_audio(got, 1000), JA.center_crop_audio(want, 1000))
    (tmp_path / "ref.mp3").write_bytes(b"ID3")
    with pytest.raises(ValueError, match="WAV"):
        TA.load_audio_file(str(tmp_path / "ref.mp3"))


def test_reference_from_wav_matches_jax(pair, tmp_path):
    """encode_reference / prepare_reference(ref_audio_path=...) from a 16 kHz
    WAV file: load, VAD trim, resample to 24 kHz, crop, Mimi encode."""
    jtts, port = pair
    path = str(tmp_path / "voice.wav")
    _write_wav(path, _voice(16000, 0.6, seed=6), 16000)
    want = jtts.encode_reference(ref_audio_path=path, ref_seconds=0.2)
    got = port.encode_reference(ref_audio_path=path, ref_seconds=0.2)
    assert got.shape == want.shape and got.shape[0] == 200
    np.testing.assert_array_equal(got, want)
    with pytest.raises(RuntimeError):
        port.encode_reference(ref_audio_path=path, ref_tokens_tq=got)
    jref = jtts.prepare_reference(ref_audio_path=path, ref_seconds=0.2)
    pref = port.prepare_reference(ref_audio_path=path, ref_seconds=0.2)
    close(t2n(pref.sv_ref), jref.sv_ref, STACK_TOL)
    close(t2n(pref.ref_seq), jref.ref_seq, STACK_TOL)
