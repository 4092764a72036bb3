"""Process-global metrics registry with Prometheus text exposition.

The port of ``fedml_tpu/obs/registry.py`` (stdlib only, no torch):
``Counter`` / ``Gauge`` / ``Histogram`` families (labels supported, fixed
log-scale latency buckets), a text-format 0.0.4 ``render()``, a structured
``snapshot()``, ``ScopedRegistry`` (label-bound views, one family shared by
tenants) and a tiny ``http.server`` endpoint serving ``/metrics`` and
``/healthz``.  For the same sequence of calls ``render()`` is byte for byte
the reference's: the label escaping, ``_format_value`` and the bucket layout
of :func:`default_latency_buckets` are the reference's own
(``tests/test_torch_registry.py`` holds the two equal).

One addition: :meth:`MetricsRegistry.add_collect_hook` registers a callable
that ``render()`` and ``snapshot()`` run first.  The eager kernel timer
(``ops/timing.py``) resolves its pending CUDA event pairs there, so a
scrape sees every launch that has finished on the card; the output format
is unchanged.

The servers' ``extra.metrics_port`` stays refused until their metric
families are ported (``ROADMAP.md`` Queue 1 item 10b): an endpoint with
nothing of theirs in it would be a silent no-op.

Everything is thread-safe: the hot paths (comm receive loop, server round
handlers, the serving batcher) update metrics from different threads.
"""

from __future__ import annotations

import json
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "ScopedRegistry", "MetricsHTTPServer", "maybe_start_metrics_server",
    "default_latency_buckets",
]

_INF = float("inf")
_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def default_latency_buckets() -> tuple:
    """Fixed log-scale buckets: 100µs doubling up to ~419s (22 buckets) —
    spans FL phase durations from a metrics-registry update to a straggling
    cross-silo round, with constant relative resolution and no deps."""
    out, v = [], 1e-4
    for _ in range(22):
        out.append(v)
        v *= 2.0
    return tuple(out)


def _escape_help(s: str) -> str:
    return s.replace("\\", r"\\").replace("\n", r"\n")


def _escape_label_value(s: str) -> str:
    return s.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _format_value(v: float) -> str:
    if v == _INF:
        return "+Inf"
    if v == -_INF:
        return "-Inf"
    if v != v:  # NaN
        return "NaN"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _format_labels(names: Sequence[str], values: Sequence[str],
                   extra: Sequence[tuple] = ()) -> str:
    pairs = [f'{n}="{_escape_label_value(str(v))}"' for n, v in zip(names, values)]
    pairs += [f'{n}="{_escape_label_value(str(v))}"' for n, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


class _Metric:
    """One metric family: a name, a help string, and label-keyed children."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "", labels: Sequence[str] = ()):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for label in labels:
            if not _LABEL_RE.match(label) or label == "le":
                raise ValueError(f"invalid label name {label!r} on {name}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labels)
        self._lock = threading.Lock()
        self._children: dict[tuple, object] = {}

    def _key(self, labels: dict) -> tuple:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: got labels {sorted(labels)}, declared {list(self.labelnames)}"
            )
        return tuple(str(labels[n]) for n in self.labelnames)

    def clear(self) -> None:
        with self._lock:
            self._children.clear()

    def _snapshot(self) -> dict:
        """Structured point-in-time view of this family (scalar children;
        Histogram overrides).  Input shape of the OTLP exporter."""
        with self._lock:
            samples = [
                {"labels": dict(zip(self.labelnames, key)), "value": float(v)}
                for key, v in sorted(self._children.items())
            ]
        return {"name": self.name, "kind": self.kind, "help": self.help,
                "labels": list(self.labelnames), "samples": samples}


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {amount})")
        key = self._key(labels)
        with self._lock:
            self._children[key] = self._children.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._children.get(self._key(labels), 0.0))

    def _render_into(self, out: list) -> None:
        with self._lock:
            for key in sorted(self._children):
                out.append(f"{self.name}{_format_labels(self.labelnames, key)} "
                           f"{_format_value(self._children[key])}")


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._children[key] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._children[key] = self._children.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._children.get(self._key(labels), 0.0))

    _render_into = Counter._render_into


class Histogram(_Metric):
    """Fixed-bucket histogram (log-scale latency buckets by default).

    Children store per-bucket counts plus sum/count; ``render`` emits the
    Prometheus cumulative form (``_bucket{le=...}``, ``+Inf`` == ``_count``,
    ``_sum``, ``_count``)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "", labels: Sequence[str] = (),
                 buckets: Optional[Sequence[float]] = None):
        super().__init__(name, help, labels)
        bounds = tuple(sorted(float(b) for b in (buckets or default_latency_buckets())))
        if not bounds or any(b != b for b in bounds):
            raise ValueError(f"histogram {name}: invalid buckets {buckets!r}")
        self.buckets = bounds if bounds[-1] == _INF else bounds + (_INF,)

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        value = float(value)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = {"counts": [0] * len(self.buckets), "sum": 0.0, "count": 0}
                self._children[key] = child
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    child["counts"][i] += 1
                    break
            child["sum"] += value
            child["count"] += 1

    def count(self, **labels) -> int:
        with self._lock:
            child = self._children.get(self._key(labels))
            return int(child["count"]) if child else 0

    def sum(self, **labels) -> float:
        with self._lock:
            child = self._children.get(self._key(labels))
            return float(child["sum"]) if child else 0.0

    def _snapshot(self) -> dict:
        with self._lock:
            samples = [
                {"labels": dict(zip(self.labelnames, key)),
                 "counts": list(child["counts"]),
                 "sum": float(child["sum"]), "count": int(child["count"])}
                for key, child in sorted(self._children.items())
            ]
        return {"name": self.name, "kind": self.kind, "help": self.help,
                "labels": list(self.labelnames), "buckets": list(self.buckets),
                "samples": samples}

    def _render_into(self, out: list) -> None:
        with self._lock:
            for key in sorted(self._children):
                child = self._children[key]
                cumulative = 0
                for bound, n in zip(self.buckets, child["counts"]):
                    cumulative += n
                    labels = _format_labels(self.labelnames, key,
                                            extra=[("le", _format_value(bound))])
                    out.append(f"{self.name}_bucket{labels} {cumulative}")
                base = _format_labels(self.labelnames, key)
                out.append(f"{self.name}_sum{base} {_format_value(child['sum'])}")
                out.append(f"{self.name}_count{base} {child['count']}")


class MetricsRegistry:
    """Named metric families + the text-format exposition."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}
        self._collect_hooks: list = []

    def _get_or_create(self, cls, name: str, help: str, labels: Sequence[str],
                       **kwargs) -> _Metric:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if type(existing) is not cls or existing.labelnames != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} re-registered as {cls.kind} with labels "
                        f"{tuple(labels)}; existing is {existing.kind} with "
                        f"{existing.labelnames}"
                    )
                return existing
            metric = cls(name, help, labels, **kwargs)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str = "", labels: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", labels: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "", labels: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels, buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def scoped(self, **bound: str) -> "ScopedRegistry":
        """A view of this registry with ``bound`` labels pre-applied — the
        multi-tenant namespace mechanism: two tenants registering
        the SAME family name through ``REGISTRY.scoped(job=...)`` share one
        family whose samples stay fully separated by the ``job`` label, so
        neither can observe (or clobber) the other's series.  Bound label
        names are appended to every family's declared labels; re-registering
        an existing family with a different label set still refuses exactly
        as the base registry does."""
        return ScopedRegistry(self, bound)

    def add_collect_hook(self, fn) -> None:
        """Run ``fn()`` at the start of every :meth:`render` and
        :meth:`snapshot` (a source whose observations complete late, such
        as CUDA event pairs, brings its families up to date there)."""
        with self._lock:
            self._collect_hooks.append(fn)

    def _collect(self) -> list:
        with self._lock:
            hooks = list(self._collect_hooks)
            metrics = list(self._metrics.values())
        for fn in hooks:
            fn()
        return metrics

    def snapshot(self) -> list[dict]:
        """Structured point-in-time view of every family: name/kind/help/
        labels plus samples (and buckets for histograms).  This is what the
        OTLP exporter (``obs/otlp.py``) maps to ``ResourceMetrics``, and a
        JSON-friendly debugging surface for tests and reports."""
        metrics = self._collect()
        return [m._snapshot() for m in metrics]

    def render(self) -> str:
        """Prometheus text format 0.0.4: HELP + TYPE per family, then the
        family's samples; ends with a newline as the format requires."""
        metrics = self._collect()
        out: list[str] = []
        for metric in metrics:
            out.append(f"# HELP {metric.name} {_escape_help(metric.help)}")
            out.append(f"# TYPE {metric.name} {metric.kind}")
            metric._render_into(out)
        return "\n".join(out) + "\n"


class _BoundChild:
    """One family viewed through fixed label values: every write/read call
    merges the bound labels in, so tenant code uses the plain metric API
    while its samples land in its own label series."""

    __slots__ = ("_metric", "_bound")

    def __init__(self, metric: _Metric, bound: dict):
        self._metric = metric
        self._bound = bound

    def _merge(self, labels: dict) -> dict:
        overlap = set(labels) & set(self._bound)
        if overlap:
            raise ValueError(
                f"{self._metric.name}: labels {sorted(overlap)} are bound by "
                "the scoped registry and cannot be overridden")
        return {**self._bound, **labels}

    def inc(self, amount: float = 1.0, **labels) -> None:
        self._metric.inc(amount, **self._merge(labels))

    def dec(self, amount: float = 1.0, **labels) -> None:
        self._metric.dec(amount, **self._merge(labels))

    def set(self, value: float, **labels) -> None:
        self._metric.set(value, **self._merge(labels))

    def observe(self, value: float, **labels) -> None:
        self._metric.observe(value, **self._merge(labels))

    def value(self, **labels) -> float:
        return self._metric.value(**self._merge(labels))

    def count(self, **labels) -> int:
        return self._metric.count(**self._merge(labels))

    def sum(self, **labels) -> float:
        return self._metric.sum(**self._merge(labels))

    @property
    def name(self) -> str:
        return self._metric.name


class ScopedRegistry:
    """Label-bound view over a :class:`MetricsRegistry` (see
    :meth:`MetricsRegistry.scoped`).  Family names carry the ``fedml_``
    namespace, as in the reference."""

    def __init__(self, registry: "MetricsRegistry", bound: dict):
        for name in bound:
            if not _LABEL_RE.match(name) or name == "le":
                raise ValueError(f"invalid bound label name {name!r}")
        self.registry = registry
        self.bound = {k: str(v) for k, v in bound.items()}

    def _labels(self, labels: Sequence[str]) -> tuple:
        clash = set(labels) & set(self.bound)
        if clash:
            raise ValueError(f"labels {sorted(clash)} already bound by this scope")
        return tuple(self.bound) + tuple(labels)

    def counter(self, name: str, help: str = "", labels: Sequence[str] = ()) -> _BoundChild:
        return _BoundChild(self.registry.counter(name, help, self._labels(labels)),
                           self.bound)

    def gauge(self, name: str, help: str = "", labels: Sequence[str] = ()) -> _BoundChild:
        return _BoundChild(self.registry.gauge(name, help, self._labels(labels)),
                           self.bound)

    def histogram(self, name: str, help: str = "", labels: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> _BoundChild:
        return _BoundChild(
            self.registry.histogram(name, help, self._labels(labels), buckets=buckets),
            self.bound)


#: the process-global registry every instrumented layer writes to
REGISTRY = MetricsRegistry()


class MetricsHTTPServer:
    """``/metrics`` + ``/healthz`` on a stdlib ThreadingHTTPServer.

    ``port=0`` binds an ephemeral port (read it back from ``.port``); the
    serve loop runs on a daemon thread so nothing blocks or outlives the
    process.  Scrape with any Prometheus-compatible collector."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 port: int = 0, host: str = "0.0.0.0"):
        registry = registry or REGISTRY
        started = time.time()

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    body = registry.render().encode("utf-8")
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif path == "/healthz":
                    body = json.dumps({"status": "ok", "uptime_s": round(time.time() - started, 3)}).encode()
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # scrapes must not spam stderr
                pass

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MetricsHTTPServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="fedml-metrics-http", daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


def maybe_start_metrics_server(cfg) -> Optional[MetricsHTTPServer]:
    """Start the exposition endpoint when ``cfg.extra['metrics_port']`` is
    set (0 = ephemeral port); None (and no server) otherwise.  The port's
    servers refuse ``extra.metrics_port`` until their metric families are
    ported (``ROADMAP.md`` Queue 1 item 10b), so nothing calls this yet."""
    from ..core.flags import cfg_extra

    port = cfg_extra(cfg, "metrics_port")
    if port is None:
        return None
    return MetricsHTTPServer(REGISTRY, port=int(port)).start()
