"""The HTTP server without fastapi (counterpart:
sopro_tpu/serve/server_stdlib.py): a threaded `http.server` with the
endpoints and SPRO wire protocol of serve/server.py.

  GET  /            GET /healthz    GET /v1/stats
  POST /v1/reference/cache          (multipart: ref_audio, ref_seconds)
  POST /v1/audio/speech             (multipart or urlencoded form; stream=true
                                     -> chunked SPRO framed PCM)

Run it with `python -m sopro_tpu_torch.serve.server_stdlib` (SOPRO_HOST,
default 0.0.0.0, and SOPRO_PORT, default 8000; serve/server.py lists the
model's settings). Every request is a continuous-batching session, so
concurrent clients stream at once.
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Tuple
from urllib.parse import parse_qsl

from sopro_tpu_torch.serve import server as core


def parse_form(content_type: str, body: bytes
               ) -> Tuple[Dict[str, str], Dict[str, Tuple[str, bytes]]]:
    """An urlencoded or multipart/form-data body -> (fields, files{name:
    (filename, data)})."""
    fields: Dict[str, str] = {}
    files: Dict[str, Tuple[str, bytes]] = {}
    ct = (content_type or "").lower()
    if ct.startswith("application/x-www-form-urlencoded"):
        fields.update(parse_qsl(body.decode("utf-8", "replace")))
        return fields, files
    if not ct.startswith("multipart/form-data"):
        return fields, files
    boundary = next((p.strip()[len("boundary="):].strip('"') for p in content_type.split(";")
                     if p.strip().startswith("boundary=")), None)
    if not boundary:
        return fields, files
    for chunk in body.split(b"--" + boundary.encode()):
        chunk = chunk.strip(b"\r\n")
        if not chunk or chunk == b"--" or b"\r\n\r\n" not in chunk:
            continue
        raw_headers, data = chunk.split(b"\r\n\r\n", 1)
        disp = next((line for line in raw_headers.decode("utf-8", "replace").split("\r\n")
                     if line.lower().startswith("content-disposition:")), "")
        name = filename = None
        for piece in disp.split(";"):
            piece = piece.strip()
            if piece.startswith("name="):
                name = piece[5:].strip('"')
            elif piece.startswith("filename="):
                filename = piece[9:].strip('"')
        if name is None:
            continue
        if filename is not None:
            files[name] = (filename, data)
        else:
            fields[name] = data.decode("utf-8", "replace")
    return fields, files


class Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "sopro/1.5"

    def log_message(self, fmt, *args):  # quiet unless asked
        if os.environ.get("SOPRO_HTTP_LOG"):
            super().log_message(fmt, *args)

    def _bytes(self, code: int, data: bytes, ctype: str, headers: Dict[str, str] = None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def _json(self, code: int, obj) -> None:
        self._bytes(code, json.dumps(obj).encode(), "application/json")

    def do_GET(self):
        if self.path == "/healthz":
            return self._json(200, {"ok": True})
        if self.path == "/v1/stats":
            _, batcher = core.get_tts()
            return self._json(200, batcher.stats())
        if self.path == "/":
            return self._bytes(200, b"<h1>sopro</h1><p>POST /v1/audio/speech</p>", "text/html")
        return self._json(404, {"detail": "not found"})

    def do_POST(self):
        n = int(self.headers.get("Content-Length", "0") or "0")
        body = self.rfile.read(n) if n else b""
        fields, files = parse_form(self.headers.get("Content-Type", ""), body)
        if self.path == "/v1/reference/cache":
            return self._cache_reference(fields, files)
        if self.path == "/v1/audio/speech":
            return self._speech(fields, files)
        return self._json(404, {"detail": "not found"})

    def _cache_reference(self, fields, files):
        try:
            return self._json(200, core.cache_reference(fields, files))
        except core.RequestError as e:
            return self._json(e.status, {"detail": e.detail})

    def _speech(self, fields, files):
        try:
            media, headers, body = core.speech(fields, files)
        except core.RequestError as e:
            return self._json(e.status, {"detail": e.detail})
        if isinstance(body, bytes):
            return self._bytes(200, body, media, headers)

        self.send_response(200)
        self.send_header("Content-Type", media)
        self.send_header("Transfer-Encoding", "chunked")
        for k, v in headers.items():
            self.send_header(k, v)
        self.end_headers()
        try:
            for piece in body:
                self.wfile.write(f"{len(piece):x}\r\n".encode() + piece + b"\r\n")
            self.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError):
            pass  # the client went away
        finally:
            body.close()  # before its end: cancels the session, the slot frees within a tick


def serve(host: str = "0.0.0.0", port: int = 8000) -> ThreadingHTTPServer:
    """Start the server in a daemon thread; `shutdown()` stops it."""
    httpd = ThreadingHTTPServer((host, port), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def main():
    host = os.environ.get("SOPRO_HOST", "0.0.0.0")
    port = int(os.environ.get("SOPRO_PORT", "8000"))
    core.get_tts()  # load the model and start the scheduler before taking traffic
    httpd = ThreadingHTTPServer((host, port), Handler)
    print(f"sopro serving on http://{host}:{port}", flush=True)
    httpd.serve_forever()


if __name__ == "__main__":
    main()
