"""A small HTTP object store (the S3 role between processes) and its
client (the port of ``fedml_tpu/comm/object_store_http.py``).

:class:`MiniObjectStoreServer` keeps blobs in memory behind ``PUT /key``
(200) and ``GET /key`` (the bytes, or 404), on a threaded
``http.server`` bound to an ephemeral port by default.
:class:`HttpObjectStore` is the ``put`` / ``get`` interface
``MqttS3CommManager`` takes, over HTTP: a missing blob raises ``KeyError``
(the in-memory store's contract, which the receive loop reads as a blob
really gone), any other failure (a refused connection, a 5xx) raises what
``urllib`` raised, which the loop retries.  Timeouts: 30 s a request, as in
the reference.
"""

from __future__ import annotations

import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional


class MiniObjectStoreServer:
    """Threaded HTTP store: ``PUT /key`` -> 200, ``GET /key`` -> bytes/404."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host, self.port = host, port
        self._blobs: dict[str, bytes] = {}
        self._lock = threading.Lock()
        self._server: Optional[ThreadingHTTPServer] = None

    def start(self) -> int:
        blobs, lock = self._blobs, self._lock

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence per-request stderr noise
                pass

            def do_PUT(self):
                n = int(self.headers.get("Content-Length", 0))
                data = self.rfile.read(n)
                with lock:
                    blobs[self.path.lstrip("/")] = data
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def do_GET(self):
                with lock:
                    data = blobs.get(self.path.lstrip("/"))
                if data is None:
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self._server = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._server.server_address[1]
        threading.Thread(target=self._server.serve_forever, daemon=True).start()
        return self.port

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"


class HttpObjectStore:
    """Client side of :class:`MiniObjectStoreServer` — the
    ``InMemoryObjectStore`` interface (``put``/``get``) over real HTTP."""

    def __init__(self, base_url: str, timeout: float = 30.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    def put(self, key: str, data: bytes) -> str:
        req = urllib.request.Request(
            f"{self.base_url}/{key}", data=data, method="PUT",
            headers={"Content-Type": "application/octet-stream"},
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            if r.status != 200:
                raise RuntimeError(f"object store PUT {key} -> {r.status}")
        return key

    def get(self, key: str) -> bytes:
        try:
            with urllib.request.urlopen(
                f"{self.base_url}/{key}", timeout=self.timeout
            ) as r:
                return r.read()
        except urllib.error.HTTPError as e:
            if e.code == 404:
                # keep the InMemoryObjectStore contract: callers handling a
                # missing-payload race catch KeyError, not HTTPError
                raise KeyError(key) from e
            raise
