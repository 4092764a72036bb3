"""Continuous micro-batcher in front of the predictor.

The port of ``fedml_tpu/serving/batcher.py``: host Python with no tensor
of its own, the reference's logic line for line over the port's metrics
registry (``obs/registry.py``), so the families and their names are the
reference's.

- **Bounded admission queue.**  ``submit`` either enqueues the request or
  raises :class:`QueueOverflow`; the HTTP layer maps it to 503 +
  ``Retry-After``, so a traffic spike degrades to explicit backpressure,
  never unbounded queue growth.
- **Coalesce, dispatch as soon as the device frees.**  One dispatcher
  thread drains the queue into the fixed padded batch the predictor runs
  (``max_batch`` rows: one shape, so cuDNN picks one algorithm) and runs
  ONE forward per micro-batch.  A lone request never waits for a full
  batch; an optional ``flush_ms`` window only delays a PARTIAL batch long
  enough for arrivals already in flight to join (0 = dispatch at once).
- **Per-request futures** carry queue/execute/total latency into the
  ``fedml_serving_*`` histograms (p50/p99 come from the bucket counts,
  :func:`percentile_from_histogram`), plus QPS and batch-fill gauges.
- **Hot-swap seam.**  The predictor of each micro-batch is resolved
  per dispatch through an optional route controller
  (:class:`~fedml_tpu_torch.serving.publisher.HotSwapController`), so a
  version swap lands between micro-batches with zero dropped in-flight
  requests.

Thread model: request threads call ``submit``/``stats``, the dispatcher
thread drains; every shared mutable touch runs under the one queue
``Condition``.  Predictor execution runs outside the lock, on the
dispatcher thread (the predictor enters ``torch.inference_mode`` there).
"""

from __future__ import annotations

import math
import threading
import time
from typing import Optional

import numpy as np

from ..obs import registry as obsreg

__all__ = ["MicroBatcher", "QueueOverflow", "BatchRequest"]

QUEUE_TIME = obsreg.REGISTRY.histogram(
    "fedml_serving_queue_seconds",
    "Admission-queue wait per request (submit to micro-batch dispatch).",
)
EXECUTE_TIME = obsreg.REGISTRY.histogram(
    "fedml_serving_execute_seconds",
    "Predictor execution wall time per micro-batch.",
)
REQUEST_TIME = obsreg.REGISTRY.histogram(
    "fedml_serving_request_seconds",
    "Total in-batcher latency per request (submit to result ready).",
)
REQUESTS = obsreg.REGISTRY.counter(
    "fedml_serving_requests_total",
    "Requests through the micro-batcher, by outcome (ok / rejected = 503 "
    "backpressure / error = batch execution failure).",
    labels=("outcome",),
)
BATCHES = obsreg.REGISTRY.counter(
    "fedml_serving_batches_total",
    "Micro-batches dispatched to the predictor.",
)
BATCH_FILL = obsreg.REGISTRY.gauge(
    "fedml_serving_batch_fill_fraction",
    "EWMA fraction of padded batch lanes carrying real rows per dispatch.",
)
QPS_GAUGE = obsreg.REGISTRY.gauge(
    "fedml_serving_qps",
    "EWMA requests/s completed by the micro-batcher.",
)
QUEUE_DEPTH = obsreg.REGISTRY.gauge(
    "fedml_serving_queue_depth",
    "Requests waiting in the admission queue.",
)


class QueueOverflow(RuntimeError):
    """Admission queue full: the caller should answer 503 and retry after
    ``retry_after_s`` (an estimate of when a lane frees up)."""

    def __init__(self, depth: int, retry_after_s: float):
        super().__init__(f"admission queue full ({depth} requests waiting)")
        self.depth = depth
        self.retry_after_s = retry_after_s


class BatchRequest:
    """One submitted request: rows in, a waitable result out (the future the
    HTTP handler blocks on)."""

    __slots__ = ("x", "n", "submit_t", "done", "outputs", "error", "version",
                 "queue_s", "execute_s", "total_s")

    def __init__(self, x: np.ndarray):
        self.x = x
        self.n = int(x.shape[0])
        self.submit_t = time.monotonic()
        self.done = threading.Event()
        self.outputs: Optional[np.ndarray] = None
        self.error: Optional[Exception] = None
        self.version: Optional[int] = None
        self.queue_s = 0.0
        self.execute_s = 0.0
        self.total_s = 0.0

    def wait(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self.done.wait(timeout):
            raise TimeoutError("micro-batch result not ready in time")
        if self.error is not None:
            raise self.error
        return self.outputs


class MicroBatcher:
    """Continuous micro-batcher (see module docstring).

    ``controller`` is the hot-swap seam: an object with
    ``route() -> (predictor, version, is_canary)`` and
    ``observe_batch(version, ok, execute_s, is_canary, fallback)``;
    ``None`` pins the constructor predictor forever (plain serving).
    """

    def __init__(self, predictor, *, controller=None, max_batch: Optional[int] = None,
                 max_queue: int = 256, flush_ms: float = 2.0):
        self._predictor = predictor
        self._controller = controller
        self.max_batch = int(max_batch or getattr(predictor, "max_batch", 32))
        self.max_queue = int(max_queue)
        self.flush_s = max(0.0, float(flush_ms) / 1000.0)
        # one Condition is both the admission mutex and the dispatcher's
        # wakeup — a single lock identity for every shared-state access
        self._cond = threading.Condition()
        self._queue: list[BatchRequest] = []
        self._stopped = False
        # accounting (guarded by _cond)
        self._completed = 0
        self._rejected = 0
        self._errored = 0
        self._batches = 0
        self._fill_ewma: Optional[float] = None
        self._qps_ewma: Optional[float] = None
        self._batch_s_ewma: Optional[float] = None
        self._last_dispatch_t: Optional[float] = None
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        name="fedml-serving-batcher", daemon=True)
        self._thread.start()

    # -- request side ---------------------------------------------------------
    def submit(self, x) -> BatchRequest:
        """Enqueue one request of ``rows x features...``; raises
        :class:`QueueOverflow` when the admission queue is full and
        ``ValueError`` for rows that can never fit the padded batch."""
        x = np.asarray(x, dtype=np.float32)
        if x.ndim < 2:
            x = x.reshape(1, -1)
        if x.shape[0] > self.max_batch:
            raise ValueError(
                f"request batch {x.shape[0]} exceeds max_batch {self.max_batch}")
        req = BatchRequest(x)
        with self._cond:
            if self._stopped:
                raise RuntimeError("micro-batcher stopped")
            if len(self._queue) + 1 > self.max_queue:
                self._rejected += 1
                REQUESTS.inc(outcome="rejected")
                raise QueueOverflow(len(self._queue), self._retry_after_locked())
            self._queue.append(req)
            QUEUE_DEPTH.set(len(self._queue))
            self._cond.notify()
        return req

    def _retry_after_locked(self) -> float:
        """Backpressure hint: roughly how long until the queued backlog has
        drained one max_batch worth of lanes."""
        per_batch = self._batch_s_ewma or 0.05
        backlog_batches = max(1.0, len(self._queue) / max(1, self.max_batch))
        return max(0.05, per_batch * backlog_batches)

    @property
    def retry_after_s(self) -> float:
        with self._cond:
            return self._retry_after_locked()

    # -- dispatcher -----------------------------------------------------------
    def _take_batch_locked(self) -> list[BatchRequest]:
        batch: list[BatchRequest] = []
        lanes = 0
        while self._queue and lanes + self._queue[0].n <= self.max_batch:
            req = self._queue.pop(0)
            batch.append(req)
            lanes += req.n
        QUEUE_DEPTH.set(len(self._queue))
        return batch

    def _dispatch_loop(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._stopped:
                    self._cond.wait(timeout=0.1)
                if self._stopped and not self._queue:
                    return
                first_t = self._queue[0].submit_t
                # flush window: hold a PARTIAL batch open only until the
                # oldest request has waited flush_s (arrivals already in
                # flight get to join); a full batch never waits
                if self.flush_s > 0:
                    deadline = first_t + self.flush_s
                    while (sum(r.n for r in self._queue) < self.max_batch
                           and not self._stopped):
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        self._cond.wait(timeout=remaining)
                batch = self._take_batch_locked()
            if batch:
                self._execute(batch)

    def _execute(self, batch: list[BatchRequest]) -> None:
        now = time.monotonic()
        for req in batch:
            req.queue_s = now - req.submit_t
            QUEUE_TIME.observe(req.queue_s)
        xs = np.concatenate([req.x for req in batch]) if len(batch) > 1 else batch[0].x
        if self._controller is not None:
            pred, version, is_canary = self._controller.route()
        else:
            pred, version, is_canary = self._predictor, None, False
        served_version = version
        t0 = time.monotonic()
        outputs, err, regressed = self._run(pred, xs)
        fallback = False
        if is_canary and (err is not None or regressed):
            # canary regression (exception OR non-finite outputs) must not
            # cost the requests: re-execute on the stable predictor; the
            # controller records the regression against the canary version
            pred, served_version, _ = self._controller.stable()
            outputs, err, _ = self._run(pred, xs)
            fallback = True
        execute_s = time.monotonic() - t0
        EXECUTE_TIME.observe(execute_s)
        if self._controller is not None:
            self._controller.observe_batch(
                version, err is None, execute_s, is_canary, fallback)
        done_t = time.monotonic()
        off = 0
        for req in batch:
            req.execute_s = execute_s
            req.total_s = done_t - req.submit_t
            req.version = served_version
            if err is None:
                req.outputs = outputs[off:off + req.n]
            else:
                req.error = err
            off += req.n
            REQUEST_TIME.observe(req.total_s)
            REQUESTS.inc(outcome="ok" if err is None else "error")
            req.done.set()
        self._account(batch, err, done_t)

    def _run(self, pred, xs):
        """(outputs, error, canary_regressed): non-finite canary output is a
        regression exactly like an exception — a poisoned published tree
        must never be promoted on latency alone."""
        try:
            out = np.asarray(pred.predict_rows(xs))
        except Exception as e:  # the batch fails together; callers see the error
            return None, e, True
        if not np.all(np.isfinite(out)):
            return out, None, True
        return out, None, False

    def _account(self, batch: list[BatchRequest], err, done_t: float) -> None:
        rows = sum(r.n for r in batch)
        fill = rows / max(1, self.max_batch)
        with self._cond:
            self._batches += 1
            if err is None:
                self._completed += len(batch)
            else:
                self._errored += len(batch)
            self._fill_ewma = (fill if self._fill_ewma is None
                               else 0.3 * fill + 0.7 * self._fill_ewma)
            exec_s = batch[0].execute_s
            self._batch_s_ewma = (exec_s if self._batch_s_ewma is None
                                  else 0.3 * exec_s + 0.7 * self._batch_s_ewma)
            if self._last_dispatch_t is not None:
                dt = max(1e-6, done_t - self._last_dispatch_t)
                rate = len(batch) / dt
                self._qps_ewma = (rate if self._qps_ewma is None
                                  else 0.3 * rate + 0.7 * self._qps_ewma)
            self._last_dispatch_t = done_t
            fill_ewma, qps_ewma = self._fill_ewma, self._qps_ewma
        BATCHES.inc()
        BATCH_FILL.set(fill_ewma)
        if qps_ewma is not None:
            QPS_GAUGE.set(qps_ewma)

    # -- lifecycle / stats ----------------------------------------------------
    def stats(self) -> dict:
        with self._cond:
            return {
                "completed": self._completed,
                "rejected": self._rejected,
                "errored": self._errored,
                "batches": self._batches,
                "queue_depth": len(self._queue),
                "batch_fill_ewma": (round(self._fill_ewma, 4)
                                    if self._fill_ewma is not None else None),
                "qps_ewma": (round(self._qps_ewma, 2)
                             if self._qps_ewma is not None else None),
                "max_batch": self.max_batch,
                "max_queue": self.max_queue,
            }

    def stop(self, drain_timeout_s: float = 5.0) -> None:
        """Stop accepting work; the dispatcher drains what is queued (every
        accepted request resolves — shutdown must not drop in-flight work)."""
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        self._thread.join(timeout=max(0.1, drain_timeout_s))


def percentile_from_histogram(hist, q: float) -> Optional[float]:
    """Approximate quantile (upper bucket bound at the cumulative crossing)
    from a registry histogram — how the bench reads p50/p99 out of the
    ``fedml_serving_*`` families."""
    snap = hist._snapshot()
    if not snap["samples"]:
        return None
    counts = snap["samples"][0]["counts"]
    total = sum(counts)
    if total <= 0:
        return None
    target = math.ceil(q * total)
    cum = 0
    for bound, n in zip(snap["buckets"], counts):
        cum += n
        if cum >= target:
            return float(bound)
    return float(snap["buckets"][-1])
