"""ctypes bindings for the repository's native audio library
(counterpart: sopro_tpu/native.py): `native/sopro_audio.cpp`, built by
`make -C native` into `native/libsopro_audio.so` at first use.

The port binds its compressed-audio decoder: mp3 through the system's
libmpg123 and ogg vorbis through libvorbisfile, which the library opens at
run time (no build dependency). A library that cannot be built or loaded,
a codec library that is not installed and a file that does not decode each
raise with the reason; nothing here falls back quietly.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Tuple

import numpy as np

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
LIB_NAME = "libsopro_audio.so"

_LOCK = threading.Lock()
_LIBS = {}  # native directory -> loaded library


def load(native_dir: str = NATIVE_DIR) -> ctypes.CDLL:
    """The native library of `native_dir`, built with make if it is missing."""
    with _LOCK:
        if native_dir in _LIBS:
            return _LIBS[native_dir]
        path = os.path.join(native_dir, LIB_NAME)
        if not os.path.exists(path):
            try:
                subprocess.run(["make", "-C", native_dir, "-s"], check=True,
                               capture_output=True, text=True, timeout=300)
            except FileNotFoundError as e:
                raise RuntimeError(f"cannot build {path}: {e}") from e
            except subprocess.CalledProcessError as e:
                raise RuntimeError(f"building {path} failed: {e.stderr.strip()[-2000:]}") from e
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            raise RuntimeError(f"cannot load {path}: {e}") from e
        f32pp = ctypes.POINTER(ctypes.POINTER(ctypes.c_float))
        lib.sopro_decode_file.restype = ctypes.c_int
        lib.sopro_decode_file.argtypes = [ctypes.c_char_p, f32pp,
                                          ctypes.POINTER(ctypes.c_size_t),
                                          ctypes.POINTER(ctypes.c_int)]
        lib.sopro_buf_free.restype = None
        lib.sopro_buf_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        _LIBS[native_dir] = lib
        return lib


def decode_file(path: str, native_dir: str = NATIVE_DIR) -> Tuple[np.ndarray, int]:
    """Decode an mp3 or ogg vorbis file -> (mono float32 [S], sample rate)."""
    lib = load(native_dir)
    buf = ctypes.POINTER(ctypes.c_float)()
    n, sr = ctypes.c_size_t(), ctypes.c_int()
    rc = lib.sopro_decode_file(os.fsencode(path), ctypes.byref(buf), ctypes.byref(n),
                               ctypes.byref(sr))
    if rc == 2:
        raise RuntimeError(
            f"cannot decode {path!r}: the system codec library it needs "
            "(libmpg123 for mp3, libvorbisfile for ogg) is not installed"
        )
    if rc != 0:
        raise ValueError(f"cannot decode {path!r}: not a readable mp3 or ogg vorbis file")
    try:
        out = np.ctypeslib.as_array(buf, shape=(n.value,)).astype(np.float32)
    finally:
        lib.sopro_buf_free(buf)
    return out, int(sr.value)
