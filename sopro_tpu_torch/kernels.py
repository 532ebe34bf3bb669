"""Build, load and count the hand-written CUDA kernels under `csrc/`.

Each `csrc/<name>.cu` exposes a plain C function and is compiled by nvcc for
`sm_90a` into its own shared library under `<repo>/build/kernels/`, named by
a hash of its sources and flags, at first use; a changed source rebuilds.
The libraries are loaded with ctypes: pointers travel as `c_void_p`
(tensor.data_ptr()), the stream as `c_void_p`, and every C entry point
returns `cudaGetLastError()` after its launches, which the caller turns into
an exception.

`LAUNCHES` counts, per kernel, the wrapper calls that launched it on the
device; `reset_launches()` zeroes the counts. `LAUNCH_INFO` keeps what a
kernel chose at launch time (the AR loop's cluster size).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
KERNELS = ("ar_loop", "nar_heads", "seanet")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
LAUNCH_INFO: Dict[str, dict] = {}  # launch shape a kernel chose at run time
_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources(name: str):
    return [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh"))


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start_build(name: str):
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    log = open(out.with_suffix(".log"), "w")
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    return proc, log, tmp, out


def _finish_build(name: str, job) -> None:
    proc, log, tmp, out = job
    rc = proc.wait()
    log.close()
    text = out.with_suffix(".log").read_text()
    if rc != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (rc={rc}):\n{text}")
    os.replace(tmp, out)


def build(names: Iterable[str] = KERNELS) -> float:
    """Compile every named kernel that is not built yet (in parallel);
    returns the wall seconds spent."""
    t0 = time.perf_counter()
    jobs = {name: _start_build(name) for name in names}
    for name, job in jobs.items():
        if job is not None:
            _finish_build(name, job)
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc's output (ptxas register / shared-memory report) for a kernel."""
    path = _lib_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    if name not in _LIBS:
        build([name])
        _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
    return _LIBS[name]


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
