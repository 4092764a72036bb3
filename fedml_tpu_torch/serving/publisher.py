"""Continuous model publication + hot swap.

The port of ``fedml_tpu/serving/publisher.py``: host code, the reference's
logic over the port's metrics registry, so its families, file names, the
manifest and every promote / rollback decision are the reference's for the
same sequence of observations (``tests/test_torch_serving_mixed.py``).

- **Server side** (:class:`ModelPublisher`, behind ``extra.model_publish_dir``):
  at every version bump the cross-silo server (sync and async) atomically
  writes ``params-v<version>.wire`` (the pytree wire bytes of its host
  global: numpy, flax layout, bitwise what the reference's server writes
  for the same global) via tmp + ``os.replace``, then rewrites
  ``MANIFEST.json`` the same way.  The manifest is the commit record:
  readers see the previous or the complete new version, never a torn one.
  Old param files are pruned past ``extra.model_publish_keep``.
- **Worker side** (:class:`ManifestWatcher` + :class:`HotSwapController`):
  a serving worker polls the manifest and hot-swaps the variables BETWEEN
  micro-batches with zero dropped in-flight requests: the new tree is
  decoded, moved to the device and warmed (one padded forward) while the
  old tree keeps serving; only then does the route flip.  With
  ``canary_fraction`` set, the new version first serves that fraction of
  micro-batches while a multiplicative health score (errors / non-finite
  outputs, latency against the stable EWMA, and an optional labeled eval
  batch's accuracy) accumulates; a score under ``regress_threshold`` after
  ``canary_min_batches`` rolls the version back, and it is never re-offered.

``publisher_from_config`` returns ``None`` when ``extra.model_publish_dir``
is unset: no publisher object, no disk writes, the server's rounds as before.

Thread model: the publisher is called only from the server's locked round
boundary; the controller's state mutates under its own ``_lock`` (``route``
/ ``observe_batch`` on the batcher's dispatcher thread, ``offer`` on the
watcher thread, ``stats`` on request threads).
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import re
import tempfile
import threading
import time
from typing import Any, Callable, Optional

from ..core.flags import cfg_extra
from ..obs import registry as obsreg

log = logging.getLogger("fedml_tpu_torch.serving.publisher")

__all__ = [
    "ModelPublisher", "publisher_from_config", "ManifestWatcher",
    "HotSwapController", "MANIFEST_NAME",
]

MANIFEST_NAME = "MANIFEST.json"
_PARAMS_RE = re.compile(r"^params-v(\d{8})\.wire$")

PUBLISHES = obsreg.REGISTRY.counter(
    "fedml_serving_publishes_total",
    "Model versions published to the serving manifest by the training server.",
)
PUBLISHED_VERSION = obsreg.REGISTRY.gauge(
    "fedml_serving_published_version",
    "Latest model version committed to the serving manifest.",
)
SERVED_VERSION = obsreg.REGISTRY.gauge(
    "fedml_serving_served_version",
    "Model version the stable (non-canary) serving route currently uses.",
)
SWAPS = obsreg.REGISTRY.counter(
    "fedml_serving_hot_swaps_total",
    "Model versions promoted to the stable serving route (hot swaps).",
)
ROLLBACKS = obsreg.REGISTRY.counter(
    "fedml_serving_rollbacks_total",
    "Canary versions rolled back on a health regression.",
)
CANARY_BATCHES = obsreg.REGISTRY.counter(
    "fedml_serving_canary_batches_total",
    "Micro-batches routed to a canary version, by outcome.",
    labels=("outcome",),
)


# ---------------------------------------------------------------------------
# server side
# ---------------------------------------------------------------------------
class ModelPublisher:
    """Atomic version-stamped publication into one directory (see module
    docstring).  ``publish`` never raises into the caller's round — a disk
    failure logs and skips the version (the next bump retries)."""

    def __init__(self, root: str, keep: int = 5):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.keep = max(1, int(keep))
        self.published = 0
        self.last_version: Optional[int] = None

    def _params_name(self, version: int) -> str:
        return f"params-v{int(version):08d}.wire"

    def _atomic_write(self, name: str, blob: bytes) -> str:
        path = os.path.join(self.root, name)
        fd, tmp = tempfile.mkstemp(dir=self.root, prefix=".tmp_", suffix=".pub")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)  # readers see old or complete new
        except OSError:
            with contextlib.suppress(OSError):
                os.remove(tmp)
            raise
        return path

    def publish(self, version: int, variables: Any, meta: Optional[dict] = None) -> Optional[str]:
        """Write ``variables`` as version ``version`` and commit the manifest.
        Returns the params path, or None when the write failed (logged)."""
        from ..comm import wire

        try:
            blob = wire.encode_pytree(variables)
            name = self._params_name(version)
            self._atomic_write(name, blob)
            manifest = {
                "version": int(version),
                "path": name,
                "nbytes": len(blob),
                "created_unix": round(time.time(), 3),
                **(meta or {}),
            }
            self._atomic_write(
                MANIFEST_NAME,
                json.dumps(manifest, sort_keys=True, indent=1).encode())
        except Exception:
            log.warning("model publish of version %s failed; the next version "
                        "bump retries", version, exc_info=True)
            return None
        self.published += 1
        self.last_version = int(version)
        PUBLISHES.inc()
        PUBLISHED_VERSION.set(float(version))
        self._prune(keep_name=name)
        return os.path.join(self.root, name)

    def _prune(self, keep_name: str) -> None:
        """Retain the newest ``keep`` param files; the manifest-referenced
        file is never pruned regardless of age."""
        try:
            entries = sorted(
                f for f in os.listdir(self.root) if _PARAMS_RE.match(f))
        except OSError:
            return
        for stale in entries[:-self.keep]:
            if stale == keep_name:
                continue
            with contextlib.suppress(OSError):
                os.remove(os.path.join(self.root, stale))


def publisher_from_config(cfg) -> Optional[ModelPublisher]:
    """The one gate: ``extra.model_publish_dir`` unset/falsy → ``None``
    (no publisher object, no writes)."""
    if cfg is None or not cfg_extra(cfg, "model_publish_dir"):
        return None
    root = str(cfg_extra(cfg, "model_publish_dir"))
    keep = int(cfg_extra(cfg, "model_publish_keep"))
    try:
        return ModelPublisher(root, keep=keep)
    except OSError as e:
        log.warning("model publish dir %s unusable (%s) — publication "
                    "disabled for this run", root, e)
        return None


# ---------------------------------------------------------------------------
# worker side
# ---------------------------------------------------------------------------
class ManifestWatcher:
    """Poll-side reader of a publisher directory: ``poll()`` returns
    ``(version, params_path, manifest)`` when the manifest names a version
    newer than the last one returned, else ``None``.  Corrupt or missing
    manifests read as "nothing new" (the atomic replace means the previous
    complete manifest was the last good state)."""

    def __init__(self, root: str, last_version: int = -1):
        self.root = os.path.abspath(root)
        self.last_version = int(last_version)

    def read_manifest(self) -> Optional[dict]:
        try:
            with open(os.path.join(self.root, MANIFEST_NAME)) as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            return None
        if not isinstance(manifest, dict) or "version" not in manifest:
            return None
        return manifest

    def poll(self) -> Optional[tuple[int, str, dict]]:
        manifest = self.read_manifest()
        if manifest is None:
            return None
        version = int(manifest["version"])
        if version <= self.last_version:
            return None
        path = os.path.join(self.root, str(manifest.get("path", "")))
        if not os.path.exists(path):
            return None  # manifest ahead of a pruned/failed params write
        self.last_version = version
        return version, path, manifest

    def wait_for_version(self, min_version: int = 0, timeout_s: float = 30.0,
                         poll_s: float = 0.05) -> Optional[tuple[int, str, dict]]:
        """Block until the manifest reaches ``min_version`` (worker
        bootstrap: serve the first published model without a --params file)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            got = self.poll()
            if got is not None and got[0] >= min_version:
                return got
            time.sleep(poll_s)
        return None


class HotSwapController:
    """Stable/canary routing + promotion/rollback for one serving worker.

    The batcher calls :meth:`route` per micro-batch and reports the outcome
    through :meth:`observe_batch`; the watcher thread calls :meth:`offer`
    with a WARMED predictor for a new version.  ``canary_fraction <= 0``
    means direct promotion (the zero-downtime swap: old tree serves until
    the new one warmed, then the route flips between micro-batches).
    """

    def __init__(self, predictor, version: int = 0, *,
                 canary_fraction: float = 0.0, canary_min_batches: int = 8,
                 regress_threshold: float = 0.5, latency_factor: float = 3.0,
                 error_weight: float = 4.0, eval_batch=None):
        self._lock = threading.Lock()
        self._stable = (predictor, int(version))
        self._canary: Optional[tuple[Any, int]] = None
        self.canary_fraction = float(canary_fraction)
        self.canary_min_batches = max(1, int(canary_min_batches))
        self.regress_threshold = float(regress_threshold)
        self.latency_factor = float(latency_factor)
        self.error_weight = float(error_weight)
        #: optional labeled eval batch ``(x, y)``: each offered canary is
        #: scored on REAL held-out accuracy (off the serving path, on the
        #: watcher thread) and an accuracy regression vs the stable version
        #: multiplies into the health score — a numerically healthy but
        #: WRONG model now rolls back too
        self.eval_batch = None
        if eval_batch is not None:
            import numpy as _np

            ex, ey = eval_batch
            self.eval_batch = (_np.asarray(ex, dtype=_np.float32),
                               _np.asarray(ey))
        self.swaps = 0
        self.rollbacks = 0
        self.rejected: set[int] = set()
        self._batch_idx = 0
        self._stable_lat_ewma: Optional[float] = None
        self._canary_errors = 0.0
        self._canary_lat_ewma: Optional[float] = None
        self._canary_batches = 0
        self._stable_eval_acc = self._eval_accuracy(predictor)
        self._canary_eval_acc: Optional[float] = None
        SERVED_VERSION.set(float(version))

    def _eval_accuracy(self, predictor) -> Optional[float]:
        """Accuracy of ``predictor`` on the labeled eval batch (None without
        one, or when the predictor cannot score it — never raises into the
        swap path)."""
        if self.eval_batch is None or predictor is None:
            return None
        import numpy as _np

        ex, ey = self.eval_batch
        try:
            logits = _np.asarray(predictor.predict_rows(ex))
            return float(_np.mean(_np.argmax(logits, axis=-1)
                                  == _np.asarray(ey).reshape(-1)))
        except Exception:
            log.warning("canary eval-batch scoring failed; accuracy factor "
                        "skipped for this version", exc_info=True)
            return None

    # -- routing (batcher dispatcher thread) ----------------------------------
    def route(self) -> tuple[Any, int, bool]:
        with self._lock:
            self._batch_idx += 1
            if self._canary is not None and self.canary_fraction > 0:
                period = max(1, round(1.0 / self.canary_fraction))
                if self._batch_idx % period == 0:
                    pred, ver = self._canary
                    return pred, ver, True
            pred, ver = self._stable
            return pred, ver, False

    def stable(self) -> tuple[Any, int, bool]:
        with self._lock:
            pred, ver = self._stable
            return pred, ver, False

    def observe_batch(self, version: int, ok: bool, execute_s: float,
                      is_canary: bool, fallback: bool = False) -> None:
        """One micro-batch outcome.  ``fallback`` marks a canary batch that
        regressed (exception or non-finite outputs) and was re-run on the
        stable route — the hardest possible evidence against the canary."""
        with self._lock:
            if not is_canary:
                self._stable_lat_ewma = (
                    execute_s if self._stable_lat_ewma is None
                    else 0.3 * execute_s + 0.7 * self._stable_lat_ewma)
                return
            if self._canary is None or self._canary[1] != version:
                return  # stale report from a canary already decided
            self._canary_batches += 1
            if fallback or not ok:
                self._canary_errors += 1.0
                CANARY_BATCHES.inc(outcome="error")
            else:
                self._canary_lat_ewma = (
                    execute_s if self._canary_lat_ewma is None
                    else 0.3 * execute_s + 0.7 * self._canary_lat_ewma)
                CANARY_BATCHES.inc(outcome="ok")
            if self._canary_batches >= self.canary_min_batches:
                if self._health_score_locked() >= self.regress_threshold:
                    self._promote_locked()
                else:
                    self._rollback_locked()

    def _health_score_locked(self) -> float:  # the caller holds _lock
        """Multiplicative health in [0,1] (the reference's health-ledger shape):
        an error factor ``1/(1 + w*errors)`` times a latency factor that
        only kicks in past ``latency_factor`` x the stable EWMA."""
        score = 1.0 / (1.0 + self.error_weight * self._canary_errors)
        if self._stable_lat_ewma and self._canary_lat_ewma:
            limit = self.latency_factor * self._stable_lat_ewma
            if self._canary_lat_ewma > limit:
                score *= limit / self._canary_lat_ewma
        # real eval-set factor: a canary whose held-out accuracy fell below
        # the stable version's is penalized proportionally (same
        # multiplicative shape as the other factors — an improvement never
        # boosts past 1.0)
        if (self._canary_eval_acc is not None
                and self._stable_eval_acc is not None
                and self._stable_eval_acc > 0
                and self._canary_eval_acc < self._stable_eval_acc):
            score *= self._canary_eval_acc / self._stable_eval_acc
        return score

    def _promote_locked(self) -> None:  # the caller holds _lock
        pred, ver = self._canary
        self._stable = (pred, ver)
        self._canary = None
        if self._canary_eval_acc is not None:
            self._stable_eval_acc = self._canary_eval_acc
        self._canary_eval_acc = None
        self.swaps += 1
        SWAPS.inc()
        SERVED_VERSION.set(float(ver))
        log.info("hot swap: version %d promoted to the stable route "
                 "(swap #%d)", ver, self.swaps)

    def _rollback_locked(self) -> None:  # the caller holds _lock
        _pred, ver = self._canary
        self._canary = None
        self.rejected.add(ver)
        self.rollbacks += 1
        ROLLBACKS.inc()
        log.warning("canary rollback: version %d health %.3f < %.3f after "
                    "%d batches (%.0f errors, eval acc %s vs stable %s) — "
                    "stable version %d keeps serving", ver,
                    self._health_score_locked(), self.regress_threshold,
                    self._canary_batches, self._canary_errors,
                    self._canary_eval_acc, self._stable_eval_acc,
                    self._stable[1])
        self._canary_eval_acc = None

    # -- publication intake (watcher thread) ----------------------------------
    def wants_version(self, version: int) -> bool:
        with self._lock:
            return (version > self._stable[1]
                    and version not in self.rejected
                    and (self._canary is None or version > self._canary[1]))

    def offer(self, version: int, predictor) -> None:
        """Install a WARMED predictor for ``version``: direct promotion when
        canary routing is off, else as the canary under a fresh score.  With
        an eval batch configured, the candidate is scored on it HERE (the
        watcher thread, off the serving path) so the accuracy factor is in
        place before the first canary batch reports."""
        eval_acc = self._eval_accuracy(predictor)
        with self._lock:
            if version <= self._stable[1] or version in self.rejected:
                return
            if self.canary_fraction <= 0:
                self._canary = (predictor, version)
                self._canary_eval_acc = eval_acc
                self._promote_locked()
                return
            self._canary = (predictor, version)
            self._canary_errors = 0.0
            self._canary_lat_ewma = None
            self._canary_batches = 0
            self._canary_eval_acc = eval_acc

    # -- introspection --------------------------------------------------------
    @property
    def version(self) -> int:
        with self._lock:
            return self._stable[1]

    def stats(self) -> dict:
        with self._lock:
            return {
                "served_version": self._stable[1],
                "canary_version": self._canary[1] if self._canary else None,
                "swaps": self.swaps,
                "rollbacks": self.rollbacks,
                "rejected_versions": sorted(self.rejected),
                "canary_fraction": self.canary_fraction,
                "stable_eval_acc": self._stable_eval_acc,
                "canary_eval_acc": self._canary_eval_acc,
            }


def watch_and_swap(watcher: ManifestWatcher, controller: HotSwapController,
                   load_predictor: Callable[[int, str, dict], Any],
                   stop: threading.Event, poll_s: float = 0.25) -> threading.Thread:
    """The worker's hot-swap loop on a daemon thread: poll the manifest,
    decode + warm the new tree via ``load_predictor`` (called OFF the
    serving path — the old tree serves throughout), then ``offer`` it.
    Load failures are logged and retried at the next poll."""

    def loop():
        while not stop.wait(poll_s):
            got = watcher.poll()
            if got is None:
                continue
            version, path, manifest = got
            if not controller.wants_version(version):
                continue
            try:
                predictor = load_predictor(version, path, manifest)
            except Exception:
                log.warning("could not load published version %d from %s; "
                            "retrying at the next poll", version, path,
                            exc_info=True)
                watcher.last_version = version - 1  # re-see it next poll
                continue
            controller.offer(version, predictor)

    t = threading.Thread(target=loop, name="fedml-serving-watcher", daemon=True)
    t.start()
    return t
