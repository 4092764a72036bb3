"""Event-driven server runtime: a timer wheel on one daemon thread (the
port of ``fedml_tpu/cross_silo/runtime.py``'s ``ServerRuntime``).

The thread starts lazily at the first ``arm``.  ``arm(owner, name, delay,
fn)`` schedules ``fn``; re-arming the same ``(owner, name)`` supersedes the
previous entry, and ``cancel(owner)`` drops everything an owner scheduled,
so managers hold no timer handles.

Callbacks run outside the runtime's lock (a callback that takes a server's
lock never nests it inside this one); a callback that raises is logged and
contained.  Not ported yet: the reference's ``post`` dispatch queue (no
caller on this slice's path) and its ``GangScheduler`` (the multi-tenant
round gate).
"""

from __future__ import annotations

import heapq
import itertools
import logging
import threading
import time
from typing import Callable, Optional

log = logging.getLogger("fedml_tpu_torch.cross_silo.runtime")


class ServerRuntime:
    """One daemon thread driving a timer wheel.  Every structure below is
    touched only under ``_cond``."""

    def __init__(self, name: str = "fedml-server-runtime"):
        self.name = name
        self._cond = threading.Condition()
        #: min-heap of (due_monotonic, seq); entries resolve through _timers
        self._heap: list[tuple[float, int]] = []
        #: (owner-id, name) -> (seq, due, fn); seq identifies the live entry
        self._timers: dict[tuple[int, str], tuple[int, float, Callable]] = {}
        self._by_seq: dict[int, tuple[int, str]] = {}
        self._seq = itertools.count(1)
        self._closed = False
        self._thread: Optional[threading.Thread] = None

    def arm(self, owner: object, name: str, delay_s: float, fn: Callable) -> None:
        """Schedule ``fn`` after ``delay_s``; supersedes any previous timer
        armed under the same ``(owner, name)``."""
        key = (id(owner), str(name))
        due = time.monotonic() + max(0.0, float(delay_s))
        with self._cond:
            if self._closed:
                return
            old = self._timers.pop(key, None)
            if old is not None:
                self._by_seq.pop(old[0], None)
            seq = next(self._seq)
            self._timers[key] = (seq, due, fn)
            self._by_seq[seq] = key
            heapq.heappush(self._heap, (due, seq))
            self._ensure_thread()
            self._cond.notify()

    def cancel(self, owner: object, name: Optional[str] = None) -> None:
        """Cancel one named timer, or every timer of ``owner`` when ``name``
        is None.  A callback already dequeued keeps running."""
        oid = id(owner)
        with self._cond:
            keys = ([(oid, str(name))] if name is not None
                    else [k for k in self._timers if k[0] == oid])
            for key in keys:
                entry = self._timers.pop(key, None)
                if entry is not None:
                    self._by_seq.pop(entry[0], None)

    def close(self) -> None:
        """Stop the loop thread and drop every pending timer.  Idempotent;
        safe to call from a callback."""
        with self._cond:
            self._closed = True
            self._timers.clear()
            self._by_seq.clear()
            self._heap.clear()
            self._cond.notify_all()
            t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5.0)

    def _ensure_thread(self) -> None:  # caller holds _cond
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._loop, name=self.name, daemon=True)
            self._thread.start()

    def _next_work(self) -> tuple[Optional[Callable], bool]:
        """(callback-or-None, closed): one bounded wait for a due timer."""
        with self._cond:
            if self._closed:
                return None, True
            now = time.monotonic()
            while self._heap and self._heap[0][0] <= now:
                _due, seq = heapq.heappop(self._heap)
                key = self._by_seq.pop(seq, None)
                if key is None:
                    continue  # superseded or cancelled
                entry = self._timers.pop(key, None)
                if entry is None or entry[0] != seq:
                    continue
                return entry[2], False
            timeout = 0.2
            if self._heap:
                timeout = min(timeout, max(0.0, self._heap[0][0] - now))
            self._cond.wait(timeout=max(0.001, timeout))
            return None, self._closed

    def _loop(self) -> None:
        while True:
            fn, closed = self._next_work()
            if closed:
                return
            if fn is None:
                continue
            try:
                fn()
            except Exception:
                log.exception("runtime callback failed on %s", self.name)
