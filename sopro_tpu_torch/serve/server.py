"""The serving app's core (counterpart: sopro_tpu/serve/server.py): the SPRO
wire helpers, the prepared-reference cache, the server's configuration and
model, the request handling (`cache_reference`, `speech`), and a FastAPI app
over it (`build_app`, built once by `get_app`; fastapi is imported only
there). `python -m sopro_tpu_torch.serve.server` (`main`) runs that app
under uvicorn on SOPRO_HOST (default 0.0.0.0) and SOPRO_PORT (default
8000), and raises ImportError where fastapi or uvicorn is not installed;
`server_stdlib.py` serves the same endpoints over the same functions
without either (`python -m sopro_tpu_torch.serve.server_stdlib`).

Endpoints: `POST /v1/reference/cache`, `POST /v1/audio/speech` (a WAV, or
with stream=true the SPRO framed-PCM stream), `GET /v1/stats`, `GET
/healthz`, and the browser demo: `GET /` answers `static/index.html`, `GET
/static/<file>` the files beside it (a fixed one-line page at `/` where the
file is missing). Every request is a session on the continuous-batching
scheduler (`ContinuousBatcher`).

Configuration by environment, as the JAX package's server reads it:
  SOPRO_REPO_ID (a local snapshot directory or a hub repo id,
  `hub.download_repo`), SOPRO_REVISION (its revision), HF_TOKEN (the hub's
  token), SOPRO_REF_CACHE_DIR, SOPRO_CHUNK_SIZE (default 16), SOPRO_RAMP_FRAMES
  (first-chunk ramp tick, default 4; >= chunk size disables), SOPRO_SLOTS
  (default 8), SOPRO_ADMIT_GRACE_MS (default 6; 0 disables),
  SOPRO_MAX_FRAMES (default 2000), SOPRO_REF_SECONDS (default 12),
  SOPRO_RANDOM_INIT=1 (random weights), SOPRO_DEVICE ("cpu" runs on the
  CPU; else the card), SOPRO_DP (> 1: the slots split over a mesh of that
  many dp shards, `make_mesh(dp, dp=dp, tp=1)`: one card each, or dp shards
  of the CPU under SOPRO_DEVICE=cpu). The Mimi snapshot is
  SOPRO_MIMI_REPO_ID (a local directory or a hub repo id, default the JAX
  package's "kyutai/mimi").
"""

from __future__ import annotations

import hashlib
import io
import os
import re
import struct
import tempfile
import threading
import wave as _wave
from typing import Any, Dict, Iterator, Optional, Tuple, Union

import numpy as np

TARGET_SR = 24000
MAGIC = b"SPRO"


# --------------------------------------------------------------------------
# wire helpers
# --------------------------------------------------------------------------


def float_to_pcm16le(wav: np.ndarray) -> bytes:
    wav = np.asarray(wav)
    if wav.ndim == 2:
        wav = wav[0]
    if wav.dtype == np.int16:  # already converted on the device
        return wav.astype("<i2", copy=False).tobytes()
    return np.round(np.clip(wav, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()


def wav_bytes_from_float(wav: np.ndarray, sr: int) -> bytes:
    bio = io.BytesIO()
    with _wave.open(bio, "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(int(sr))
        wf.writeframes(float_to_pcm16le(wav))
    return bio.getvalue()


def stream_header(sr: int, channels: int) -> bytes:
    return MAGIC + struct.pack("<II", int(sr), int(channels))


def frame(payload: bytes) -> bytes:
    return struct.pack("<I", len(payload)) + payload


def sha256_bytes(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


_REF_ID_RE = re.compile(r"^[0-9a-f]{64}$")


def valid_ref_id(rid: str) -> bool:
    """A ref_id is a sha256 hex digest; anything else (a path, say) is
    refused before it touches the file system."""
    return bool(_REF_ID_RE.match(rid or ""))


# --------------------------------------------------------------------------
# prepared references on disk: named npz arrays, the JAX package's keys
# --------------------------------------------------------------------------


def save_prepared_reference(path: str, ref) -> None:
    """sv_ref, ref_seq and kv{i}_{k,v,mask} per reference x-attn layer."""
    host = lambda x: x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)
    arrays = {"sv_ref": host(ref.sv_ref), "ref_seq": host(ref.ref_seq)}
    for i, kv in enumerate(ref.ref_kv):
        for name, leaf in kv.items():
            if leaf is not None:
                arrays[f"kv{i}_{name}"] = host(leaf)
    np.savez(path, **arrays)


def load_prepared_reference(path: str, device="cpu"):
    """The inverse of `save_prepared_reference` (files of either package),
    as tensors on `device`."""
    import torch

    from sopro_tpu_torch.models.sopro import PreparedReference

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    with np.load(path, allow_pickle=False) as z:
        if "sv_ref" not in z.files:
            raise ValueError(f"{path}: legacy positional reference cache; re-cache the "
                             "reference audio.")
        kvs, i = [], 0
        while f"kv{i}_k" in z.files:
            kvs.append({name: t(z[f"kv{i}_{name}"]) if f"kv{i}_{name}" in z.files else None
                        for name in ("k", "v", "mask")})
            i += 1
        return PreparedReference(sv_ref=t(z["sv_ref"]), ref_seq=t(z["ref_seq"]), ref_kv=tuple(kvs))


# --------------------------------------------------------------------------
# app state
# --------------------------------------------------------------------------


class ServerConfig:
    def __init__(self):
        self.repo_id = os.environ.get("SOPRO_REPO_ID", "samuel-vitorino/sopro-v1.5")
        self.revision = os.environ.get("SOPRO_REVISION") or None
        self.token = os.environ.get("HF_TOKEN") or None
        self.mimi_repo_id = os.environ.get("SOPRO_MIMI_REPO_ID", "kyutai/mimi")
        self.ref_cache_dir = os.environ.get(
            "SOPRO_REF_CACHE_DIR", os.path.join(tempfile.gettempdir(), "sopro_tpu_ref_cache")
        )
        self.chunk_size = int(os.environ.get("SOPRO_CHUNK_SIZE", "16"))
        self.ramp_frames = int(os.environ.get("SOPRO_RAMP_FRAMES", "4"))
        self.slots = int(os.environ.get("SOPRO_SLOTS", "8"))
        self.admit_grace_ms = float(os.environ.get("SOPRO_ADMIT_GRACE_MS", "6"))
        # the scheduler's frame cap: requests clamp max_frames to <= 2000 and
        # above the cap get the effective value in X-Sopro-Max-Frames
        self.max_frames = int(os.environ.get("SOPRO_MAX_FRAMES", "2000"))
        self.random_init = os.environ.get("SOPRO_RANDOM_INIT", "") not in ("", "0")
        self.default_ref_seconds = float(os.environ.get("SOPRO_REF_SECONDS", "12.0"))
        self.device = "cpu" if os.environ.get("SOPRO_DEVICE") == "cpu" else "cuda"
        self.dp = int(os.environ.get("SOPRO_DP", "0"))


CFG = ServerConfig()
_state_lock = threading.Lock()
_tts = None
_batcher = None
_ref_cache_lock = threading.Lock()


def get_tts():
    """The server's (SoproTTS, started ContinuousBatcher), built on first
    use: random weights with SOPRO_RANDOM_INIT, else the SOPRO_REPO_ID
    snapshot (at SOPRO_REVISION, with HF_TOKEN); the batcher over a dp mesh
    when SOPRO_DP > 1."""
    global _tts, _batcher
    with _state_lock:
        if _tts is None:
            import torch

            from sopro_tpu_torch.serve.scheduler import ContinuousBatcher
            from sopro_tpu_torch.tts import SoproTTS

            if CFG.random_init:
                _tts = SoproTTS.from_random(seed=0, device=CFG.device)
            else:
                _tts = SoproTTS.from_pretrained(CFG.repo_id, revision=CFG.revision,
                                                token=CFG.token, mimi_repo_id=CFG.mimi_repo_id,
                                                device=CFG.device)
            mesh = None
            if CFG.dp > 1:
                from sopro_tpu_torch.parallel import make_mesh

                cpu = [torch.device("cpu")] * CFG.dp if CFG.device == "cpu" else None
                mesh = make_mesh(CFG.dp, dp=CFG.dp, tp=1, devices=cpu)
            _batcher = ContinuousBatcher(
                _tts, slots=CFG.slots, chunk_frames=CFG.chunk_size, ramp_frames=CFG.ramp_frames,
                max_frames=CFG.max_frames, admit_grace_ms=CFG.admit_grace_ms, mesh=mesh,
                pcm16=True,  # the wire is 16-bit: half the tick's copy
            )
            _batcher.start()
        return _tts, _batcher


def _effective_ref_seconds(rs: Optional[float]) -> float:
    return float(rs) if rs and rs > 0 else CFG.default_ref_seconds


def sv_cache_path(rid: str, ref_seconds: float) -> str:
    os.makedirs(CFG.ref_cache_dir, exist_ok=True)
    return os.path.join(CFG.ref_cache_dir, f"{rid}_{ref_seconds:g}.npz")


def get_or_compute_ref(tts, data: bytes, *, suffix: str, ref_seconds: float):
    """A sha256-keyed disk cache of prepared references (named npz arrays,
    read back after a restart without any in-process state)."""
    path = sv_cache_path(sha256_bytes(data), ref_seconds)
    with _ref_cache_lock:
        if os.path.exists(path):
            return load_prepared_reference(path, tts.engine.device)
        with tempfile.NamedTemporaryFile(suffix=suffix, delete=False) as f:
            f.write(data)
            tmp = f.name
        try:
            ref = tts.prepare_reference(ref_audio_path=tmp, ref_seconds=ref_seconds)
        finally:
            os.unlink(tmp)
        save_prepared_reference(path, ref)
        return ref


def clamp_request(max_frames, top_p, temperature, style_strength):
    """The request clamps: max_frames to [1, 2000], top_p to [0.01, 1],
    temperature to [0.05, 3], style_strength to [0, 3]."""
    return (int(max(1, min(int(max_frames), 2000))), float(max(0.01, min(float(top_p), 1.0))),
            float(max(0.05, min(float(temperature), 3.0))),
            float(max(0.0, min(float(style_strength), 3.0))))


class RequestError(Exception):
    """A request the server refuses: answered with `status` and {"detail": ...}."""

    def __init__(self, status: int, detail: str):
        super().__init__(detail)
        self.status, self.detail = int(status), str(detail)


def _field(fields: Dict[str, Any], name: str, default=None):
    """A form field, or `default` where it is absent or empty."""
    v = fields.get(name)
    return default if v is None or v == "" else v


def _truthy(v) -> bool:
    return str(v).lower() in ("1", "true", "yes")


def _suffix(filename: Optional[str]) -> str:
    return os.path.splitext(filename or "")[-1] or ".wav"


def _ref_seconds(fields) -> float:
    try:
        rs = _field(fields, "ref_seconds")
        return _effective_ref_seconds(None if rs is None else float(rs))
    except ValueError as e:
        raise RequestError(400, str(e))


def cache_reference(fields: Dict[str, Any], files: Dict[str, Tuple[str, bytes]]) -> Dict[str, Any]:
    """POST /v1/reference/cache: `fields` name -> value (ref_seconds),
    `files` name -> (filename, bytes) (ref_audio) -> the JSON answer.
    Raises RequestError."""
    filename, data = files.get("ref_audio", ("", b""))
    if not data:
        raise RequestError(400, "Empty `ref_audio` upload.")
    tts, _ = get_tts()
    rs = _ref_seconds(fields)
    try:
        get_or_compute_ref(tts, data, suffix=_suffix(filename), ref_seconds=rs)
    except ValueError as e:  # an undecodable container or payload
        raise RequestError(400, str(e))
    return {"ref_id": sha256_bytes(data), "ref_seconds": rs}


def speech(fields: Dict[str, Any], files: Dict[str, Tuple[str, bytes]]
           ) -> Tuple[str, Dict[str, str], Union[bytes, Iterator[bytes]]]:
    """POST /v1/audio/speech -> (media type, headers, body). Fields: input,
    stream, ref_id, max_frames, top_p, temperature, anti_loop,
    style_strength, ref_seconds, seed; files: ref_audio. With stream=true
    the body is an iterator of the SPRO pieces (the header, then one
    length-prefixed PCM frame per chunk); closing it before its end (the
    client went away) cancels the session. Else the body is a WAV. Raises
    RequestError."""
    text = str(_field(fields, "input", ""))
    if not text.strip():
        raise RequestError(400, "`input` must be non-empty.")
    tts, batcher = get_tts()
    rs = _ref_seconds(fields)
    ref_id = _field(fields, "ref_id")
    if (ref_id is None) == ("ref_audio" not in files):
        raise RequestError(400, "Provide exactly one of `ref_id` or `ref_audio`.")
    if ref_id is not None:
        if not valid_ref_id(ref_id):
            raise RequestError(400, "`ref_id` must be a sha256 hex digest.")
        p = sv_cache_path(ref_id, rs)
        if not os.path.exists(p):
            raise RequestError(404, "Cached reference not found. Cache it first.")
        ref = load_prepared_reference(p, tts.engine.device)
    else:
        filename, data = files["ref_audio"]
        if not data:
            raise RequestError(400, "Empty `ref_audio` upload.")
        try:
            ref = get_or_compute_ref(tts, data, suffix=_suffix(filename), ref_seconds=rs)
        except ValueError as e:
            raise RequestError(400, str(e))
    try:
        max_frames, top_p, temperature, style_strength = clamp_request(
            _field(fields, "max_frames", 400), _field(fields, "top_p", 0.9),
            _field(fields, "temperature", 1.05), _field(fields, "style_strength", 1.2))
        handle = batcher.submit(
            text, ref, top_p=top_p, temperature=temperature, style_strength=style_strength,
            max_frames=max_frames, seed=int(_field(fields, "seed", 0)),
            anti_loop=_truthy(_field(fields, "anti_loop", True)),
        )
    except ValueError as e:  # a malformed number, over-long text, a seed past int32
        raise RequestError(400, str(e))
    headers = {"X-Sopro-Max-Frames": str(min(max_frames, batcher.max_frames_cap))}
    if not _truthy(_field(fields, "stream", False)):
        try:
            chunks = list(handle.chunks())
        except BaseException:
            handle.cancel()  # an interrupted drain must not keep decoding
            raise
        wav = np.concatenate(chunks, axis=1) if chunks else np.zeros((1, 0), np.float32)
        return "audio/wav", headers, wav_bytes_from_float(wav, TARGET_SR)

    def gen():
        # its finally runs when the client disconnects: the slot frees within a tick
        try:
            yield stream_header(TARGET_SR, 1)
            for chunk in handle.chunks():
                payload = float_to_pcm16le(chunk)
                if payload:
                    yield frame(payload)
        finally:
            handle.cancel()

    return "application/octet-stream", headers, gen()


STATIC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "static")
FALLBACK_INDEX = b"<h1>sopro</h1><p>POST /v1/audio/speech</p>"
STATIC_TYPES = {".html": "text/html", ".js": "text/javascript"}


def index_html() -> bytes:
    """The demo page (`static/index.html`), or a fixed one-line page where
    the file is missing."""
    path = os.path.join(STATIC_DIR, "index.html")
    if not os.path.exists(path):
        return FALLBACK_INDEX
    with open(path, "rb") as f:
        return f.read()


def static_file(rel: str) -> Optional[Tuple[bytes, str]]:
    """A file of the demo under STATIC_DIR -> (bytes, content type), or None
    for a path that leaves the directory (`..`, a link out) or names no
    file."""
    root = os.path.realpath(STATIC_DIR)
    target = os.path.realpath(os.path.join(root, rel))
    if not target.startswith(root + os.sep) or not os.path.isfile(target):
        return None
    with open(target, "rb") as f:
        data = f.read()
    return data, STATIC_TYPES.get(os.path.splitext(target)[1], "application/octet-stream")


def build_app():
    """The FastAPI app: a thin transport over `cache_reference` and `speech`."""
    from fastapi import FastAPI, File, Form, HTTPException, UploadFile
    from fastapi.responses import HTMLResponse, Response, StreamingResponse

    app = FastAPI(title="SoproTTS API", version="1.5.0")

    def upload(f) -> Dict[str, Tuple[str, bytes]]:
        return {} if f is None else {"ref_audio": (f.filename or "", f.file.read())}

    @app.get("/healthz")
    def healthz():
        return {"ok": True}

    @app.get("/v1/stats")
    def stats():
        _, batcher = get_tts()
        return batcher.stats()

    if os.path.isdir(STATIC_DIR):
        from fastapi.staticfiles import StaticFiles

        app.mount("/static", StaticFiles(directory=STATIC_DIR), name="static")

    @app.get("/")
    def index():
        return HTMLResponse(index_html().decode("utf-8"))

    # plain `def` endpoints: the framework runs them in its thread pool, so
    # the blocking waits inside never stall the event loop
    @app.post("/v1/reference/cache")
    def cache_reference_route(ref_audio: UploadFile = File(...),
                              ref_seconds: Optional[float] = Form(None)):
        try:
            return cache_reference({"ref_seconds": ref_seconds}, upload(ref_audio))
        except RequestError as e:
            raise HTTPException(status_code=e.status, detail=e.detail)

    @app.post("/v1/audio/speech")
    def speech_route(
        input: str = Form(...),
        stream: bool = Form(False),
        ref_id: Optional[str] = Form(None),
        ref_audio: Optional[UploadFile] = File(None),
        max_frames: int = Form(400),
        top_p: float = Form(0.9),
        temperature: float = Form(1.05),
        anti_loop: bool = Form(True),
        style_strength: float = Form(1.2),
        ref_seconds: Optional[float] = Form(None),
        seed: int = Form(0),
    ):
        fields = dict(input=input, stream=stream, ref_id=ref_id, max_frames=max_frames,
                      top_p=top_p, temperature=temperature, anti_loop=anti_loop,
                      style_strength=style_strength, ref_seconds=ref_seconds, seed=seed)
        try:
            media, headers, body = speech(fields, upload(ref_audio))
        except RequestError as e:
            raise HTTPException(status_code=e.status, detail=e.detail)
        if isinstance(body, bytes):
            return Response(content=body, media_type=media, headers=headers)
        return StreamingResponse(body, media_type=media, headers=headers)

    return app


app = None


def get_app():
    """The FastAPI app of this process, built on first use."""
    global app
    if app is None:
        app = build_app()
    return app


def main():
    """Serve `get_app()` with uvicorn on SOPRO_HOST / SOPRO_PORT."""
    try:
        import fastapi  # noqa: F401
        import uvicorn
    except ImportError as e:
        raise ImportError(
            f"serve.server needs fastapi and uvicorn ({e}); without them run "
            "`python -m sopro_tpu_torch.serve.server_stdlib`"
        ) from e
    uvicorn.run(get_app(), host=os.environ.get("SOPRO_HOST", "0.0.0.0"),
                port=int(os.environ.get("SOPRO_PORT", "8000")))


if __name__ == "__main__":
    main()
