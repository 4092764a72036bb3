"""Model serving: predictor interface + HTTP inference runner.

The port of ``fedml_tpu/serving/inference.py``.  ``FedMLPredictor`` (the
user's ``predict`` / ``ready``) and ``FedMLInferenceRunner`` (``POST
/predict``, ``GET /ready``, ``GET /stats``, streaming and file responses
from the stdlib ThreadingHTTPServer) are the reference's host code as they
are.  :class:`TorchPredictor` is the counterpart of its ``JaxPredictor``:
the port's model (``model.apply(variables, x, train=False)``) over
variables on the predictor's device, the card unless the caller names
another (``core/device.resolve_device``).

Every request batch is padded to ``max_batch`` rows, as in the reference,
so every forward runs one shape and cuDNN picks one algorithm.  Each
forward runs under ``torch.inference_mode()`` entered in the calling
thread, since the mode is thread-local: the batcher's dispatch thread and
the hot-swap watcher thread (which warms a new version) both run the
model.  The reference's AOT program store (``aot_store``) is not ported
(``ROADMAP.md`` Queue 1 item 10b) and raises.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional

import numpy as np

#: why the AOT program store is refused (the worker's ``--aot-dir`` too)
AOT_REFUSAL = ("the AOT program store (the reference's core/aot.py) is not ported yet "
               "(ROADMAP.md Queue 1 item 10b)")

class FedMLPredictor:
    """Reference API shape (``fedml_predictor.py``)."""

    def predict(self, request: dict) -> Any:
        raise NotImplementedError

    def predict_stream(self, request: dict):
        """Streaming response: an iterator of JSON-serializable chunks
        (reference ``fedml_inference_runner.py:20-27`` wraps the predictor's
        generator in a ``StreamingResponse`` when the request sets
        ``stream``).  Default: one chunk, the plain prediction."""
        yield self.predict(request)

    def predict_file(self, request: dict, accept: str) -> str:
        """Non-JSON Accept header: return a path to a file to serve
        (reference ``fedml_inference_runner.py:34-36`` wraps the predictor
        result in a ``FileResponse``).  Predictors producing binary artifacts
        (images, audio, model files) override this."""
        raise NotImplementedError(
            f"this predictor produces JSON only (Accept: {accept!r})"
        )

    def ready(self) -> bool:
        return True


class TorchPredictor(FedMLPredictor):
    """Serve a port model: request {"inputs": [[...], ...]} -> {"outputs": ...}.

    ``variables`` are in the port's layout (``weights.flax_to_torch`` of a
    published artifact); they move to ``device`` once.  Pads every batch to
    ``max_batch`` so one input shape serves all request sizes.

    **Hot swap**: :meth:`clone_with` builds a predictor for a NEW variable
    tree that shares this one's model (its structure), so a version swap
    moves the new tensors to the device and pays one warm execution.
    """

    def __init__(self, model, variables, max_batch: int = 32,
                 aot_store=None, feature_shape=None, model_name: str = "",
                 device=None):
        from ..core.device import resolve_device

        if aot_store is not None:
            raise NotImplementedError(AOT_REFUSAL)
        self.device = resolve_device(device)
        self.model = model
        self.variables = _to_device(variables, self.device)
        self.max_batch = int(max_batch)
        self.model_name = model_name
        self.feature_shape = (tuple(feature_shape)
                              if feature_shape is not None else None)

    def clone_with(self, variables) -> "TorchPredictor":
        """A predictor over ``variables`` sharing this one's model (the
        hot-swap path: the tensors move to the device, nothing is rebuilt)."""
        clone = type(self).__new__(type(self))
        clone.device = self.device
        clone.model = self.model
        clone.variables = _to_device(variables, self.device)
        clone.max_batch = self.max_batch
        clone.model_name = self.model_name
        clone.feature_shape = self.feature_shape
        return clone

    def warm(self) -> None:
        """One padded execution so the first real request never pays the
        first use (cuDNN's set-up, the allocator), and a swapped-in tree
        never serves cold."""
        if self.feature_shape is None:
            return  # input shape unknown (conv model without --feature-dim)
        self.predict_rows(
            np.zeros((1,) + self.feature_shape, dtype=np.float32))

    def predict_rows(self, x: np.ndarray) -> np.ndarray:
        """Rows in, f32 logits out: the micro-batcher's execution surface
        (and the one padded forward ``predict`` wraps)."""
        import torch

        x = np.asarray(x, dtype=np.float32)
        n = x.shape[0]
        if n > self.max_batch:
            raise ValueError(f"batch {n} exceeds max_batch {self.max_batch}")
        if self.feature_shape is None:
            self.feature_shape = tuple(x.shape[1:])
        pad = self.max_batch - n
        if pad:
            x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
        # inference mode is thread-local: entered here, in the calling thread
        with torch.inference_mode():
            logits, _ = self.model.apply(self.variables, torch.from_numpy(x).to(self.device),
                                         train=False)
            out = logits.to(torch.float32).cpu().numpy()
        return out[:n]

    def predict(self, request: dict) -> dict:
        x = np.asarray(request["inputs"], dtype=np.float32)
        return {"outputs": self.predict_rows(x).tolist()}

    def predict_stream(self, request: dict):
        """One chunk per input row: the batched compute runs once, rows
        stream out as they are sliced."""
        out = self.predict(request)["outputs"]
        for i, row in enumerate(out):
            yield {"index": i, "outputs": row}


def _to_device(variables, device):
    """A tree of tensors or numpy arrays as tensors on ``device``."""
    import torch

    if isinstance(variables, dict):
        return {k: _to_device(v, device) for k, v in variables.items()}
    if not torch.is_tensor(variables):
        variables = torch.from_numpy(np.array(variables, copy=True))
    return variables.to(device)


class FedMLInferenceRunner:
    """HTTP runner (``fedml_inference_runner.py``): POST /predict, GET /ready.

    With a ``batcher``, plain JSON predicts route through the
    continuous micro-batcher: coalesced execution, bounded admission (queue
    overflow answers 503 + ``Retry-After``), and the response carries the
    model ``version`` that served it; ``GET /stats`` exposes the batcher +
    hot-swap accounting.  Streaming/file requests keep the direct path.
    """

    def __init__(self, predictor: FedMLPredictor, host: str = "127.0.0.1", port: int = 2345,
                 batcher=None, stats_fn=None, result_timeout_s: float = 30.0):
        self.predictor = predictor
        self.host = host
        self.port = port
        self.batcher = batcher
        self.stats_fn = stats_fn
        self.result_timeout_s = float(result_timeout_s)
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def _make_handler(self):
        predictor = self.predictor
        batcher = self.batcher
        stats_fn = self.stats_fn
        result_timeout_s = self.result_timeout_s

        class Handler(BaseHTTPRequestHandler):
            # chunked transfer is an HTTP/1.1 feature; the default HTTP/1.0
            # status line would make spec-compliant clients deliver the raw
            # chunk framing as body content
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            def _json(self, code: int, obj) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/ready":
                    if predictor.ready():
                        self._json(200, {"status": "ready"})
                    else:
                        self._json(503, {"status": "not ready"})
                elif self.path == "/stats" and stats_fn is not None:
                    self._json(200, stats_fn())
                else:
                    self._json(404, {"error": "not found"})

            def do_POST(self):
                if self.path != "/predict":
                    self._json(404, {"error": "not found"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    request = json.loads(self.rfile.read(length).decode())
                    accept = self.headers.get("Accept", "application/json")
                    # a JSON reply satisfies the request if ANY member of the
                    # (possibly composite, parameterized) Accept list is JSON
                    # or a wildcard — 'application/json, text/plain, */*' and
                    # 'application/json; charset=utf-8' are JSON requests
                    wants = [m.split(";")[0].strip().lower()
                             for m in accept.split(",") if m.strip()]
                    json_ok = not wants or any(
                        m in ("application/json", "application/*", "*/*", "application/x-ndjson")
                        for m in wants
                    )
                    if not json_ok:
                        # reference FileResponse path: binary artifact reply
                        self._file(predictor.predict_file(request, accept), wants[0])
                        return
                    if request.get("stream", False):
                        self._stream(predictor.predict_stream(request))
                        return
                    if batcher is not None:
                        self._batched(request)
                        return
                    result = predictor.predict(request)
                    self._json(200, result)
                except Exception as e:  # surface the error to the caller
                    self._json(400, {"error": f"{type(e).__name__}: {e}"})

            def _batched(self, request: dict) -> None:
                """Continuous-batching predict: admission-bounded, answered
                with the serving model version; a full queue is explicit
                backpressure (503 + Retry-After), never silent queueing."""
                from .batcher import QueueOverflow

                try:
                    fut = batcher.submit(np.asarray(request["inputs"],
                                                    dtype=np.float32))
                except QueueOverflow as e:
                    body = json.dumps({"error": "overloaded",
                                       "retry_after_s": round(e.retry_after_s, 3)}).encode()
                    self.send_response(503)
                    self.send_header("Content-Type", "application/json")
                    # RFC 7231 delta-seconds (integer); the JSON body carries
                    # the precise estimate for richer clients
                    self.send_header("Retry-After",
                                     str(max(1, int(e.retry_after_s + 0.999))))
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                out = fut.wait(timeout=result_timeout_s)
                result = {"outputs": np.asarray(out).tolist()}
                if fut.version is not None:
                    result["version"] = int(fut.version)
                self._json(200, result)

            def _file(self, path: str, content_type: str) -> None:
                import os as _os
                import shutil as _shutil

                size = _os.path.getsize(path)  # pre-header failure -> clean 400
                with open(path, "rb") as f:
                    self.send_response(200)
                    self.send_header("Content-Type", content_type)
                    self.send_header("Content-Length", str(size))
                    self.end_headers()
                    try:
                        # stream, don't slurp: artifacts can be model files
                        _shutil.copyfileobj(f, self.wfile)
                    except Exception:
                        # headers are gone; a 400 here would corrupt the
                        # response — drop the connection (same as _stream)
                        self.close_connection = True

            def _stream(self, chunks) -> None:
                """Chunked transfer of newline-delimited JSON — the stdlib
                equivalent of the reference's StreamingResponse
                (``fedml_inference_runner.py:28``).  The first chunk is
                materialized BEFORE the headers go out so an immediately-
                failing predictor still produces a clean 400 (mid-stream
                failures can only truncate the chunked body — inherent to
                streaming)."""
                # dedicated empty-stream sentinel: a predictor may legally
                # yield a literal None (json 'null' is a valid NDJSON line)
                _empty = object()
                it = iter(chunks)
                try:
                    first = next(it)
                except StopIteration:
                    first = _empty
                    it = iter(())
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def put(chunk) -> None:
                    line = (json.dumps(chunk) + "\n").encode()
                    self.wfile.write(f"{len(line):x}\r\n".encode() + line + b"\r\n")
                    self.wfile.flush()

                try:
                    if first is not _empty:
                        put(first)
                    for chunk in it:
                        put(chunk)
                except Exception:
                    # headers are gone: a 400 written here would inject an
                    # HTTP status line into the chunked body (clients would
                    # read it as data or silent truncation).  Drop the
                    # connection WITHOUT the terminal 0-chunk so the client
                    # sees an aborted — not cleanly finished — stream.
                    self.close_connection = True
                    return
                self.wfile.write(b"0\r\n\r\n")

        return Handler

    def run(self, block: bool = True) -> int:
        """Start serving; returns the bound port (0 port -> ephemeral)."""
        self._server = ThreadingHTTPServer((self.host, self.port), self._make_handler())
        self.port = self._server.server_address[1]
        if block:
            self._server.serve_forever()
        else:
            self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
            self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._server:
            self._server.shutdown()
            self._server.server_close()
