"""The port's audio I/O against the JAX package on the CPU: mp3 and ogg
vorbis references through the repository's native decoder give the same
samples as `sopro_tpu.native.decode_file`, from files encoded in the test
with the system's encoder libraries (the tests skip only where an encoder
library is missing); a missing native library and an undecodable file raise
with the reason; `save_audio` / `pcm16` write what the JAX package writes.
"""

import numpy as np
import pytest

from sopro_tpu import audio as JA
from sopro_tpu import native as JN

from sopro_tpu_torch import audio as TA
from sopro_tpu_torch import native as TN

from tests.test_native import _encode_mp3, _encode_ogg

SR = 24000


def _tone(seconds=1.0, hz=440.0):
    t = np.arange(int(SR * seconds)) / SR
    return (0.5 * np.sin(2 * np.pi * hz * t)).astype(np.float32)


@pytest.mark.parametrize("fmt,encode", [("mp3", _encode_mp3), ("ogg", _encode_ogg)])
def test_compressed_reference_decodes_as_in_jax(tmp_path, fmt, encode):
    path = str(tmp_path / f"ref.{fmt}")
    encode(_tone(), SR, path)
    want = JN.decode_file(path)
    assert want is not None, "the JAX package could not decode the file"
    for wav, sr in (TN.decode_file(path), TA.load_audio_file(path)):
        assert sr == want[1] == SR
        assert wav.dtype == np.float32 and wav.ndim == 1 and wav.size > SR // 2
        np.testing.assert_array_equal(wav, want[0])


def test_undecodable_file_raises(tmp_path):
    path = tmp_path / "noise.mp3"
    path.write_bytes(b"not audio at all, just bytes")
    with pytest.raises(ValueError, match="cannot decode"):
        TA.load_audio_file(str(path))


def test_missing_native_library_raises_with_the_reason(tmp_path):
    with pytest.raises(RuntimeError, match="building .*libsopro_audio.so failed"):
        TN.load(str(tmp_path))  # no Makefile there: make fails and says why


def test_wav_stays_on_the_stdlib_path(tmp_path, monkeypatch):
    def no_native(*a, **k):
        raise AssertionError("a WAV must not reach the native decoder")

    monkeypatch.setattr(TN, "decode_file", no_native)
    path = str(tmp_path / "a.wav")
    TA.save_audio(path, _tone())
    wav, sr = TA.load_audio_file(path)
    assert sr == SR and wav.shape == (SR,)


@pytest.mark.parametrize("shape,dtype", [((SR,), np.float32), ((1, SR), np.float32),
                                          ((2, SR), np.float32), ((1, SR), np.int16),
                                          ((1, 2, SR), np.float32)])
def test_save_audio_and_pcm16_match_jax(tmp_path, shape, dtype):
    rng = np.random.default_rng(0)
    wav = (rng.standard_normal(shape) * 0.6).astype(np.float32)
    wav.flat[:3] = [1.5, -1.5, 0.0]  # clipping
    if dtype == np.int16:
        wav = JA.pcm16(wav).reshape(shape)
    got = TA.pcm16(wav)
    assert got.shape == wav.shape  # JAX flattens floats (its native converter's layout)
    np.testing.assert_array_equal(got.ravel(), np.ravel(JA.pcm16(wav)))
    TA.save_audio(str(tmp_path / "t.wav"), wav)
    JA.save_audio(str(tmp_path / "j.wav"), wav)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
