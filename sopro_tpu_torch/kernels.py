"""Build, load and count the hand-written CUDA kernels under `csrc/`.

Each `csrc/<source>.cu` exposes plain C functions and is compiled by nvcc
for `sm_90a` into its own shared library under `<repo>/build/kernels/`,
named by a hash of its sources and flags, at first use; a changed source
rebuilds. The libraries are loaded with ctypes: pointers travel as
`c_void_p` (tensor.data_ptr()), the stream as `c_void_p`, and every C entry
point returns `cudaGetLastError()` after its launches, which the caller
turns into an exception.

`KERNELS` names the kernels, each counted on its own; `SOURCES` the files
they are built from (K1 `ar_loop` and K5 `ar_step` share `ar_loop.cu`, K3
`seanet` and K4 `seanet_chunk` share `seanet.cu`; K6 `csm_depth`, CSM's
depth passes, is `csm_depth.cu`, and K7 `csm_backbone`, CSM's backbone
step, `csm_backbone.cu`). `SOPRO_SOURCES` are the ones Sopro's paths run,
which its warm-up builds; K6 and K7 are built at CSM's first use.
`LAUNCHES` counts, per kernel, the wrapper calls that launched its float32
instantiation on the device, `LAUNCHES_BF16` those of its bfloat16
instantiation (`count(name, dtype)`; `LAUNCHES_BY_DTYPE` maps the dtype
name to the dict); `reset_launches()` zeroes both. `LAUNCH_INFO` keeps
what a kernel chose at launch time (the AR kernels' cluster size). The CSM
wrappers check their tensors with `need`.

Tools that time another build of a source (an older `csrc/`, a text edit,
a define) build it with `build_variant` and launch it through the same
wrappers inside `using(source, lib)`; nothing else builds or swaps a library.

Every C entry point runs inside `on_device(tensor.device)`: the CUDA runtime
launches, sets a kernel's shared-memory attribute and answers occupancy
queries for the *current* device only, so a call for tensors on another card
than the current one would be refused or configured from the wrong card.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
KERNELS = ("ar_loop", "ar_step", "nar_heads", "seanet", "seanet_chunk", "csm_depth", "csm_backbone")
SOPRO_SOURCES = ("ar_loop", "nar_heads", "seanet")
SOURCES = SOPRO_SOURCES + ("csm_depth", "csm_backbone")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
LAUNCHES_BF16: Dict[str, int] = {name: 0 for name in KERNELS}
LAUNCHES_BY_DTYPE = {"float32": LAUNCHES, "bfloat16": LAUNCHES_BF16}
LAUNCH_INFO: Dict[str, dict] = {}  # launch shape a kernel chose at run time
_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for counts in LAUNCHES_BY_DTYPE.values():
        for name in counts:
            counts[name] = 0


def count(name: str, dtype) -> None:
    """One launch of kernel `name`'s instantiation for `dtype` (a torch
    dtype): float32 or bfloat16."""
    LAUNCHES_BY_DTYPE[str(dtype).replace("torch.", "")][name] += 1


def _tool(name: str) -> str:
    """A CUDA toolkit program (nvcc, cuobjdump): on PATH or under CUDA_HOME."""
    found = shutil.which(name)
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / name
    if cand.exists():
        return str(cand)
    raise RuntimeError(f"{name} not found: the CUDA kernels need the CUDA toolkit")


def _nvcc() -> str:
    return _tool("nvcc")


def _plan(name: str, src_dir=None, edits=(), defines=()):
    """(library path, source bytes, nvcc flags, source directory) of
    `<src_dir>/<name>.cu` (default `csrc/`) with its text `edits` applied and
    `defines` added to the tree's flags. The path hashes the flags, the
    edited source and the directory's headers: the tree's own source maps to
    the tree's library wherever it lies."""
    src_dir = CSRC if src_dir is None else Path(src_dir)
    data = (src_dir / f"{name}.cu").read_bytes()
    for old, new in edits:
        if old.encode() not in data:
            raise ValueError(f"{name}.cu: edit text not found: {old!r}")
        data = data.replace(old.encode(), new.encode())
    flags = [*NVCC_FLAGS, *defines]
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(f"{name}.cu".encode())
    h.update(data)
    for header in sorted(src_dir.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so", data, flags, src_dir


def _lib_path(name: str) -> Path:
    return _plan(name)[0]


def _start_build(name: str, src_dir=None, edits=(), defines=()):
    out, data, flags, src_dir = _plan(name, src_dir, edits, defines)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = src_dir / f"{name}.cu"
    if edits:  # the edited copy beside the library, its headers from src_dir
        src = out.with_suffix(".cu")
        src.write_bytes(data)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *flags, "-I", str(src_dir), "-o", str(tmp), str(src)]
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


def build(names: Iterable[str] = SOURCES) -> float:
    """Compile every named source that is not built yet (one nvcc each, all
    started together); returns the wall seconds spent."""
    t0 = time.perf_counter()
    jobs = {name: _start_build(name) for name in names}
    for name, job in jobs.items():
        if job is not None:
            _finish_build(name, job)
    return time.perf_counter() - t0


def build_variant(source: str, *, edits=(), defines=(), src_dir=None) -> ctypes.CDLL:
    """Another build of `csrc/<source>.cu`, or of the same file under
    `src_dir` (an older `csrc/` with today's packs and entry points), for
    tools that time it beside the tree's: `edits` are (text, replacement)
    pairs applied first (a missing text raises ValueError before nvcc
    runs), `defines` extra nvcc flags ("-DSOPRO_AR_CLOCKS"). Built with the
    tree's NVCC_FLAGS into `build/kernels/`, cached by content hash
    (`ptxas(lib)` reads its register report); launch it through the
    wrappers inside `using(source, lib)`."""
    job = _start_build(source, src_dir, edits, defines)
    if job is not None:
        _finish_build(source, job)
    return ctypes.CDLL(str(_plan(source, src_dir, edits, defines)[0]))


def ptxas(library) -> List[str]:
    """ptxas' register and spill lines of a build: a source name (the
    tree's library) or a library `build_variant` returned."""
    path = _lib_path(library) if isinstance(library, str) else Path(library._name)
    log = path.with_suffix(".log")
    if not log.exists():
        return []
    return [ln.strip() for ln in log.read_text().splitlines() if "registers" in ln or "spill" in ln]


def sass_counts(name: str, kernel: str, opcodes: Iterable[str]) -> Dict[str, Dict[str, int]]:
    """Per built function of source `name` whose (mangled) name contains
    `kernel`: how many SASS instructions start with each of `opcodes`
    (`cuobjdump -sass` of the library)."""
    out = subprocess.run([_tool("cuobjdump"), "-sass", str(_lib_path(name))], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    counts = {}
    for body in out.split("Function : ")[1:]:
        fn, text = body.split("\n", 1)
        if kernel in fn:
            ops = [line.split("*/", 1)[1].strip() for line in text.splitlines()
                   if line.strip().startswith("/*") and "*/" in line]
            counts[fn.strip()] = {op: sum(1 for x in ops if x.lstrip("@!P0123456789 ").startswith(op))
                                  for op in opcodes}
    return counts


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of source `name`, built first if needed."""
    if name not in _LIBS:
        build([name])
        _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
    return _LIBS[name]


def entry_points(source: str) -> List[str]:
    """The C entry points of `source`: the `extern "C"` functions of the
    tree's file that the library the wrappers load exports (not those behind
    a define)."""
    text = (CSRC / f"{source}.cu").read_text()
    return [n for n in re.findall(r'extern "C"[^(;]*?(\w+)\s*\(', text) if hasattr(lib(source), n)]


@contextlib.contextmanager
def using(source: str, variant: ctypes.CDLL):
    """Inside, the wrappers launch `variant` (from `build_variant`) for
    `source`; on leaving, even by an exception, the tree's library again.
    A variant that lacks one of the tree's entry points is refused."""
    tree = lib(source)
    for name in entry_points(source):
        if not hasattr(variant, name):
            raise RuntimeError(f"{source}: the variant has no entry point {name}")
    _LIBS[source] = variant
    try:
        yield variant
    finally:
        _LIBS[source] = tree


def entry(source: str, name: str, argtypes) -> ctypes._CFuncPtr:
    """C entry point `name` of `source`'s library, its argument types bound
    once (ctypes keeps the function object on the library)."""
    fn = getattr(lib(source), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def need(kernel: str, name: str, x, shape, dtype, device, align: int = 16) -> None:
    """Tensor `x`, argument `name` of `kernel`'s wrapper, is `dtype` on
    `device`, contiguous of `shape`, at an `align`-byte boundary (16 for
    what a kernel reads 16 bytes at a time); raises ValueError naming it."""
    if x is None:
        raise ValueError(f"{kernel}: {name} is missing")
    if x.device != device or x.dtype != dtype:
        raise ValueError(f"{kernel}: {name} must be {dtype} on {device}, got {x.dtype} on {x.device}")
    if tuple(x.shape) != tuple(shape) or not x.is_contiguous() or x.data_ptr() % align:
        raise ValueError(f"{kernel}: {name} must be contiguous {tuple(shape)} at a {align}-byte "
                         f"boundary, got {tuple(x.shape)}")


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


@contextlib.contextmanager
def on_device(device):
    """Make CUDA `device` the current device for the calls inside and yield
    the handle of its current stream. A CPU device enters nothing and
    yields the null handle (plain code and emulated launches run there)."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        yield ctypes.c_void_p(0)
        return
    with torch.cuda.device(device):
        yield stream_ptr(device)
