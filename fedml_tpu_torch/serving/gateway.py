"""Tenant-routed serving gateway: one front door for a shared worker fleet.

The port of ``fedml_tpu/serving/gateway.py`` (host code over the port's
metrics registry):

- :class:`ServingGateway` listens on ONE port and routes each request by
  its ``tenant`` id to the worker bound to that tenant (added by card,
  whose ``publish_dir`` names the tenant's manifest, or by address:
  :meth:`ServingGateway.add_tenant`);
- requests of the same tenant are coalesced at the gateway
  (``extra.gateway_max_batch`` rows / ``extra.gateway_flush_ms`` window)
  before one forwarded ``POST /predict`` reaches the worker, whose own
  micro-batcher then sees fuller batches;
- responses carry the ``version`` the worker served and the tenant id, so
  every answer is attributable to exactly one tenant's manifest (zero
  bleed between tenants);
- a full per-tenant queue answers 503 + ``Retry-After``, and an unknown
  tenant 404: never a silent misroute;
- a request with ``"stream": true`` is not coalesced: it is forwarded
  alone to the tenant's worker and its NDJSON chunks are relayed as they
  arrive, each tagged with the tenant (the reference's gateway answers
  every request as one JSON body; the port adds this path).

The multi-tenant control plane that feeds a gateway in the reference
(``sched/multi_tenant.py``) is not ported yet (``ROADMAP.md`` Queue 1
item 9).
"""

from __future__ import annotations

import http.client
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from ..core.flags import cfg_extra
from ..obs import registry as obsreg

log = logging.getLogger("fedml_tpu_torch.serving.gateway")

__all__ = ["ServingGateway", "GatewayOverflow", "gateway_from_config"]

GATEWAY_REQUESTS = obsreg.REGISTRY.counter(
    "fedml_gateway_requests_total",
    "Requests at the tenant-routed gateway, by tenant and outcome "
    "(ok / unknown_tenant / overflow / error).",
    labels=("tenant", "outcome"),
)
GATEWAY_BATCHES = obsreg.REGISTRY.counter(
    "fedml_gateway_batches_total",
    "Coalesced batches the gateway forwarded to a tenant's worker.",
    labels=("tenant",),
)
GATEWAY_BATCH_FILL = obsreg.REGISTRY.histogram(
    "fedml_gateway_batch_fill",
    "Rows per forwarded gateway batch (fill against gateway_max_batch).",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128),
)
GATEWAY_REQUEST_TIME = obsreg.REGISTRY.histogram(
    "fedml_gateway_request_seconds",
    "Gateway request latency end to end: admission, coalescing window, "
    "worker round trip.",
    labels=("tenant",),
)
GATEWAY_TENANTS = obsreg.REGISTRY.gauge(
    "fedml_gateway_tenants",
    "Tenants currently routed by the serving gateway.",
)


class GatewayOverflow(RuntimeError):
    """A tenant's gateway queue is full — explicit backpressure."""

    def __init__(self, depth: int, retry_after_s: float):
        super().__init__(f"gateway queue full ({depth} pending)")
        self.depth = depth
        self.retry_after_s = float(retry_after_s)


class _GatewayRequest:
    """One caller's rows riding a coalesced forward."""

    __slots__ = ("rows", "event", "outputs", "version", "error")

    def __init__(self, rows: np.ndarray):
        self.rows = rows
        self.event = threading.Event()
        self.outputs = None
        self.version: Optional[int] = None
        self.error: Optional[str] = None


class _TenantLane:
    """Per-tenant coalescing queue + dispatcher: submit rows, the lane
    batches co-tenant requests for up to ``flush_ms`` / ``max_batch`` rows,
    forwards ONE ``POST /predict`` to the tenant's worker, and splits the
    outputs back per caller.

    Thread model: ``_pending``/counters under ``_cond``
    (one lock for the whole lane); the dispatcher drains under it and
    forwards outside it; callers block on their request's event.
    """

    def __init__(self, tenant: str, address: tuple, *,
                 publish_dir: Optional[str] = None, max_batch: int = 8,
                 max_queue: int = 256, flush_ms: float = 2.0,
                 timeout_s: float = 30.0):
        self.tenant = str(tenant)
        self.address = (str(address[0]), int(address[1]))
        self.publish_dir = publish_dir
        self.max_batch = max(1, int(max_batch))
        self.max_queue = max(1, int(max_queue))
        self.flush_s = max(0.0, float(flush_ms)) / 1000.0
        self.timeout_s = float(timeout_s)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._pending: list[_GatewayRequest] = []
        self._stop = False
        self._forwarded = 0
        self._last_version: Optional[int] = None
        self._thread = threading.Thread(
            target=self._loop, name=f"gateway-{tenant}", daemon=True)
        self._thread.start()

    def submit(self, rows: np.ndarray) -> _GatewayRequest:
        req = _GatewayRequest(rows)
        with self._cond:
            depth = sum(r.rows.shape[0] for r in self._pending)
            if depth + rows.shape[0] > self.max_queue:
                raise GatewayOverflow(
                    depth, retry_after_s=max(self.flush_s, 0.05))
            self._pending.append(req)
            self._cond.notify()
        return req

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._pending and not self._stop:
                    self._cond.wait(timeout=0.2)
                if self._stop and not self._pending:
                    return
                # coalescing window: let co-tenant rows join this batch
                if self.flush_s > 0 and not self._stop:
                    deadline = time.monotonic() + self.flush_s
                    while (sum(r.rows.shape[0] for r in self._pending)
                           < self.max_batch):
                        left = deadline - time.monotonic()
                        if left <= 0:
                            break
                        self._cond.wait(timeout=left)
                batch: list[_GatewayRequest] = []
                rows = 0
                while self._pending and rows < self.max_batch:
                    batch.append(self._pending.pop(0))
                    rows += batch[-1].rows.shape[0]
            self._forward(batch)

    def _forward(self, batch: list[_GatewayRequest]) -> None:
        rows = np.concatenate([r.rows for r in batch])
        GATEWAY_BATCHES.inc(tenant=self.tenant)
        GATEWAY_BATCH_FILL.observe(float(rows.shape[0]))
        try:
            conn = http.client.HTTPConnection(*self.address,
                                              timeout=self.timeout_s)
            try:
                body = json.dumps({"inputs": rows.tolist()})
                conn.request("POST", "/predict", body,
                             {"Content-Type": "application/json"})
                resp = conn.getresponse()
                payload = json.loads(resp.read().decode())
                if resp.status != 200:
                    raise RuntimeError(
                        f"worker answered {resp.status}: "
                        f"{payload.get('error', payload)}")
            finally:
                conn.close()
            outputs = np.asarray(payload["outputs"])
            version = payload.get("version")
            off = 0
            with self._cond:
                self._forwarded += len(batch)
                if version is not None:
                    self._last_version = int(version)
            for req in batch:
                n = req.rows.shape[0]
                req.outputs = outputs[off:off + n]
                req.version = None if version is None else int(version)
                off += n
                req.event.set()
        except Exception as e:  # noqa: BLE001 — every caller gets the reason
            log.warning("gateway forward to tenant %s failed: %s",
                        self.tenant, e)
            for req in batch:
                req.error = f"{type(e).__name__}: {e}"
                req.event.set()

    def stats(self) -> dict:
        with self._cond:
            return {
                "address": f"{self.address[0]}:{self.address[1]}",
                "publish_dir": self.publish_dir,
                "pending": sum(r.rows.shape[0] for r in self._pending),
                "forwarded": self._forwarded,
                "last_version": self._last_version,
            }

    def stop(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._thread.join(timeout=5.0)


class ServingGateway:
    """One HTTP front door routing ``{"tenant": ..., "inputs": ...}`` to the
    tenant's worker, with per-tenant gateway-side coalescing."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 max_batch: int = 8, flush_ms: float = 2.0,
                 max_queue: int = 256, result_timeout_s: float = 30.0):
        self.host = host
        self.port = int(port)
        self.max_batch = int(max_batch)
        self.flush_ms = float(flush_ms)
        self.max_queue = int(max_queue)
        self.result_timeout_s = float(result_timeout_s)
        self._lanes: dict[str, _TenantLane] = {}
        self._lock = threading.Lock()
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- routing table --------------------------------------------------------
    def add_tenant(self, tenant: str, *, port: int,
                   host: str = "127.0.0.1",
                   publish_dir: Optional[str] = None,
                   card=None) -> None:
        """Route ``tenant`` to the worker at ``host:port``.  ``card`` (a
        serving ModelCard) supplies ``publish_dir`` when one isn't given —
        the manifest root every answered version is attributable to."""
        if card is not None and publish_dir is None:
            publish_dir = getattr(card, "publish_dir", None)
        with self._lock:
            old = self._lanes.pop(str(tenant), None)
            self._lanes[str(tenant)] = _TenantLane(
                tenant, (host, port), publish_dir=publish_dir,
                max_batch=self.max_batch, max_queue=self.max_queue,
                flush_ms=self.flush_ms, timeout_s=self.result_timeout_s)
            GATEWAY_TENANTS.set(len(self._lanes))
        if old is not None:
            old.stop()

    def remove_tenant(self, tenant: str) -> None:
        with self._lock:
            lane = self._lanes.pop(str(tenant), None)
            GATEWAY_TENANTS.set(len(self._lanes))
        if lane is not None:
            lane.stop()

    def lane_of(self, tenant: str) -> Optional[_TenantLane]:
        with self._lock:
            return self._lanes.get(str(tenant))

    # -- request path ---------------------------------------------------------
    def handle(self, request: dict) -> tuple[int, dict]:
        """Route one decoded request; returns (http status, response body).
        Factored off the HTTP handler so in-process callers (tests)
        exercise the exact serving path."""
        tenant = str(request.get("tenant", ""))
        lane = self.lane_of(tenant)
        if lane is None:
            GATEWAY_REQUESTS.inc(tenant=tenant or "?", outcome="unknown_tenant")
            return 404, {"error": f"unknown tenant {tenant!r}"}
        t0 = time.monotonic()
        try:
            rows = np.asarray(request["inputs"], dtype=np.float32)
            req = lane.submit(rows)
        except GatewayOverflow as e:
            GATEWAY_REQUESTS.inc(tenant=tenant, outcome="overflow")
            return 503, {"error": "overloaded",
                         "retry_after_s": round(e.retry_after_s, 3)}
        except Exception as e:  # noqa: BLE001 — malformed inputs answer 400
            GATEWAY_REQUESTS.inc(tenant=tenant, outcome="error")
            return 400, {"error": f"{type(e).__name__}: {e}"}
        if not req.event.wait(timeout=self.result_timeout_s):
            GATEWAY_REQUESTS.inc(tenant=tenant, outcome="error")
            return 504, {"error": "worker timed out"}
        if req.error is not None:
            GATEWAY_REQUESTS.inc(tenant=tenant, outcome="error")
            return 502, {"error": req.error}
        GATEWAY_REQUESTS.inc(tenant=tenant, outcome="ok")
        GATEWAY_REQUEST_TIME.observe(time.monotonic() - t0, tenant=tenant)
        out = {"tenant": tenant, "outputs": np.asarray(req.outputs).tolist()}
        if req.version is not None:
            out["version"] = int(req.version)
        return 200, out

    def stream(self, request: dict):
        """``(status, body or None, chunks)`` of a streaming request: the
        tenant's worker answers ``stream`` requests chunk by chunk; a 404
        for an unknown tenant, a 502 when the worker refuses."""
        tenant = str(request.get("tenant", ""))
        lane = self.lane_of(tenant)
        if lane is None:
            GATEWAY_REQUESTS.inc(tenant=tenant or "?", outcome="unknown_tenant")
            return 404, {"error": f"unknown tenant {tenant!r}"}, None
        body = {k: v for k, v in request.items() if k != "tenant"}
        conn = http.client.HTTPConnection(*lane.address, timeout=self.result_timeout_s)
        try:
            conn.request("POST", "/predict", json.dumps(body),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
        except Exception as e:  # noqa: BLE001 — the caller gets the reason
            conn.close()
            GATEWAY_REQUESTS.inc(tenant=tenant, outcome="error")
            return 502, {"error": f"{type(e).__name__}: {e}"}, None
        if resp.status != 200:
            payload = resp.read().decode(errors="replace")
            conn.close()
            GATEWAY_REQUESTS.inc(tenant=tenant, outcome="error")
            return 502, {"error": f"worker answered {resp.status}: {payload}"}, None

        def chunks():
            try:
                for line in resp:
                    line = line.strip()
                    if line:
                        yield {"tenant": tenant, **json.loads(line)}
                GATEWAY_REQUESTS.inc(tenant=tenant, outcome="ok")
            finally:
                conn.close()

        return 200, None, chunks()

    def stats(self) -> dict:
        with self._lock:
            lanes = dict(self._lanes)
        return {"tenants": {t: lane.stats() for t, lane in lanes.items()}}

    # -- HTTP front -----------------------------------------------------------
    def _make_handler(self):
        gw = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            def _json(self, code: int, obj) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                if code == 503 and "retry_after_s" in obj:
                    self.send_header(
                        "Retry-After",
                        str(max(1, int(obj["retry_after_s"] + 0.999))))
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/ready":
                    self._json(200, {"status": "ready",
                                     "tenants": len(gw._lanes)})
                elif self.path == "/stats":
                    self._json(200, gw.stats())
                else:
                    self._json(404, {"error": "not found"})

            def do_POST(self):
                if self.path != "/predict":
                    self._json(404, {"error": "not found"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    request = json.loads(self.rfile.read(length).decode())
                except Exception as e:  # noqa: BLE001
                    self._json(400, {"error": f"{type(e).__name__}: {e}"})
                    return
                if request.get("stream", False):
                    self._stream(request)
                    return
                code, body = gw.handle(request)
                self._json(code, body)

            def _stream(self, request: dict) -> None:
                """Chunked NDJSON relay of the worker's stream (a failure
                mid-stream drops the connection without the last chunk, as
                the worker's own stream does)."""
                code, body, chunks = gw.stream(request)
                if chunks is None:
                    self._json(code, body)
                    return
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                try:
                    for chunk in chunks:
                        line = (json.dumps(chunk) + "\n").encode()
                        self.wfile.write(f"{len(line):x}\r\n".encode() + line + b"\r\n")
                        self.wfile.flush()
                except Exception:
                    self.close_connection = True
                    return
                self.wfile.write(b"0\r\n\r\n")

        return Handler

    def start(self, block: bool = False) -> int:
        """Bind and serve; returns the bound port."""
        self._server = ThreadingHTTPServer((self.host, self.port),
                                           self._make_handler())
        self.port = self._server.server_address[1]
        if block:
            self._server.serve_forever()
        else:
            self._thread = threading.Thread(
                target=self._server.serve_forever,
                name="fedml-gateway", daemon=True)
            self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        with self._lock:
            lanes = list(self._lanes.values())
            self._lanes.clear()
            GATEWAY_TENANTS.set(0)
        for lane in lanes:
            lane.stop()


def gateway_from_config(cfg, **overrides) -> ServingGateway:
    """A gateway shaped by the ``extra.gateway_*`` flags (port / batch cap /
    flush window); keyword overrides win."""
    kw = {
        "port": int(cfg_extra(cfg, "gateway_port") or 0),
        "max_batch": int(cfg_extra(cfg, "gateway_max_batch")),
        "flush_ms": float(cfg_extra(cfg, "gateway_flush_ms")),
    }
    kw.update(overrides)
    return ServingGateway(**kw)
