"""Abstract communication backend + observer interface (the port of
``fedml_tpu/comm/base.py``).

A backend moves ``Message``s between numbered endpoints and notifies its
observers on receive.  :class:`ObserverLoopMixin` is the receive loop every
backend shares, the reference's one for one:

- a transport chunk frame feeds the per-peer :class:`ChunkAssembler`; only
  a stream's final frame yields a message, and a stream idle past
  ``extra.comm_chunk_idle_sweep_s`` is evicted and charged to its sender;
- a payload that does not decode (``KeyError`` / ``ValueError``: corrupt
  framing) is dropped loudly;
- any other decode failure is transient: the payload waits with a
  not-before time (:func:`backoff_delay` under its own purpose) and is
  retried up to ``DECODE_RETRY_LIMIT`` times while healthy messages keep
  draining;
- a handler that raises is contained: one poisoned message must not kill
  the endpoint.

The reference meters these in its process-wide registry, which is not
ported (ROADMAP item 10): the loop keeps plain counts on itself instead
(``chunk_frames``, ``decode_retries``, ``handler_errors``, ``received``,
``dropped`` by reason), and the comm event sinks (:func:`add_comm_event_sink`)
hear each drop and retry, with the sender where it is known.
"""

from __future__ import annotations

import logging
import queue
import time
from abc import ABC, abstractmethod

from . import wire
from .message import ChunkAssembler, Message

log = logging.getLogger(__name__)

#: transient decode failures are retried this many times, on a capped
#: exponential schedule with deterministic jitter (:func:`backoff_delay`)
DECODE_RETRY_LIMIT = 3
DECODE_RETRY_BACKOFF_S = 0.2   # base of the exponential schedule
DECODE_RETRY_CAP_S = 2.0       # its ceiling

#: the default idle time after which a half-received chunk stream is
#: evicted (``extra.comm_chunk_idle_sweep_s`` overrides it)
CHUNK_STREAM_TIMEOUT_S = 120.0

#: purpose constants namespacing the jitter streams of :func:`backoff_delay`
#: (the reference's values, so both packages draw the same delays)
BACKOFF_PURPOSE_DECODE_RETRY = 0x44454352    # "DECR": receive-loop decode retry
BACKOFF_PURPOSE_RECONNECT = 0x52434E54       # "RCNT": client upload reconnect
BACKOFF_PURPOSE_STATUS_PROBE = 0x53545052    # "STPR": server status re-probe


def backoff_delay(attempt: int, *, base: float = DECODE_RETRY_BACKOFF_S,
                  cap: float = DECODE_RETRY_CAP_S, seed: int = 0, purpose: int = 0) -> float:
    """Capped exponential backoff with deterministic jitter: ``base *
    2**attempt`` clipped at ``cap``, scaled by a factor in ``[0.5, 1.0)``
    drawn from ``default_rng([purpose, seed, attempt])``."""
    import numpy as np

    raw = min(float(cap), float(base) * (2.0 ** int(attempt)))
    frac = float(np.random.default_rng([int(purpose), int(seed), int(attempt)]).random())
    return raw * (0.5 + 0.5 * frac)


def decode_retry_delay(attempt: int) -> float:
    """The receive loop's wait before retry ``attempt + 1`` of a transiently
    undecodable payload."""
    return backoff_delay(attempt, purpose=BACKOFF_PURPOSE_DECODE_RETRY)


#: process-wide comm event sinks ``fn(event, **info)``: ``"dropped"``
#: (``reason``, and ``client`` when the payload names its sender) and
#: ``"retried"``.  A sink that raises is ignored.
_event_sinks: list = []


def add_comm_event_sink(fn):
    _event_sinks.append(fn)
    return fn


def remove_comm_event_sink(fn) -> None:
    try:
        _event_sinks.remove(fn)
    except ValueError:
        pass


def _emit_comm_event(event: str, **info) -> None:
    for fn in list(_event_sinks):
        try:
            fn(event, **info)
        except Exception:
            pass


class Observer(ABC):
    @abstractmethod
    def receive_message(self, msg_type: int, msg: Message) -> None: ...


class ObserverLoopMixin:
    """Observer registry + the poll/decode/dispatch receive loop.  Backends
    set ``self._inbox`` (a queue of raw payloads)."""

    _observers: list
    _inbox: "queue.Queue"
    _running: bool = False

    def _init_observer_loop(self, inbox: "queue.Queue" = None) -> None:
        self._observers = []
        self._inbox = inbox if inbox is not None else queue.Queue()
        self._running = False
        self._chunk_assembler = None  # built at the first chunk frame
        self._chunk_sweep_s = CHUNK_STREAM_TIMEOUT_S
        #: the loop's counts (the reference's registry counters)
        self.received = 0
        self.chunk_frames = 0
        self.decode_retries = 0
        self.handler_errors = 0
        self.dropped: dict[str, int] = {}

    def configure_chunk_sweep(self, seconds: float) -> None:
        """The idle-stream eviction timeout (``extra.comm_chunk_idle_sweep_s``),
        for streams opened after the call."""
        self._chunk_sweep_s = float(seconds)
        if self._chunk_assembler is not None:
            self._chunk_assembler.stream_timeout_s = float(seconds)

    def add_observer(self, observer: Observer) -> None:
        self._observers.append(observer)

    def _drop(self, reason: str, client=None) -> None:
        self.dropped[reason] = self.dropped.get(reason, 0) + 1
        if client is None:
            _emit_comm_event("dropped", reason=reason)
        else:
            _emit_comm_event("dropped", reason=reason, client=client)

    def handle_receive_message(self) -> None:
        self._running = True
        # transiently undecodable payloads wait here with a not-before time,
        # so healthy messages keep draining in arrival order
        retry_pending: list[tuple[float, bytes, int]] = []
        while self._running:
            item = None
            if retry_pending:
                now = time.monotonic()
                for i, (not_before, data, attempts) in enumerate(retry_pending):
                    if not_before <= now:
                        item = (data, attempts)
                        del retry_pending[i]
                        break
            if item is None:
                try:
                    raw = self._inbox.get(timeout=0.05)
                except queue.Empty:
                    self._sweep_chunk_streams()
                    continue
                item = raw if isinstance(raw, tuple) else (raw, 0)
            data, attempts = item
            if isinstance(data, (bytes, bytearray, memoryview)) and wire.is_chunk_frame(data):
                self.chunk_frames += 1
                if self._chunk_assembler is None:
                    self._chunk_assembler = ChunkAssembler(self._chunk_sweep_s)
                msg, err, sender = self._chunk_assembler.feed(data)
                if err is not None:
                    self._drop(err, client=sender)
                    log.error("dropping chunk stream from sender %s: %s", sender, err)
                    continue
                if msg is None:
                    continue  # stream still in flight
                self.received += 1
                self._dispatch(msg)
                continue
            try:
                msg = Message.decode(data)
            except (KeyError, ValueError):
                # poisoned payload (corrupt framing): dropped loudly, the
                # loop lives on
                self._drop("undecodable")
                log.exception("dropping undecodable message (%d bytes)", len(data))
                continue
            except Exception:
                # transient (a store briefly unreachable): retried later
                if attempts < DECODE_RETRY_LIMIT:
                    self.decode_retries += 1
                    _emit_comm_event("retried")
                    log.warning("transient decode failure (attempt %d): deferring",
                                attempts + 1, exc_info=True)
                    retry_pending.append(
                        (time.monotonic() + decode_retry_delay(attempts), data, attempts + 1))
                else:
                    self._drop("retries_exhausted")
                    log.exception("dropping message after %d decode attempts", attempts + 1)
                continue
            self.received += 1
            self._dispatch(msg)

    def _dispatch(self, msg: Message) -> None:
        if msg.recv_monotonic is None:
            msg.recv_monotonic = time.monotonic()
        for obs in list(self._observers):
            try:
                obs.receive_message(msg.get_type(), msg)
            except Exception:
                # a handler crash must not kill the loop: one poisoned
                # message, not a dead endpoint
                self.handler_errors += 1
                log.exception("observer %r failed on message type %s", obs, msg.get_type())

    def _sweep_chunk_streams(self) -> None:
        """Evict chunk streams whose sender went dark mid-upload, each a
        drop charged to that sender."""
        if self._chunk_assembler is None:
            return
        for sender, stream_id in self._chunk_assembler.sweep():
            self._drop("chunk_stream_timeout", client=sender)
            log.warning("evicting stale chunk stream %s from sender %s", stream_id, sender)

    def stop_receive_message(self) -> None:
        self._running = False


class BaseCommunicationManager(ABC):
    @abstractmethod
    def send_message(self, msg: Message) -> None: ...

    @abstractmethod
    def add_observer(self, observer: Observer) -> None: ...

    @abstractmethod
    def handle_receive_message(self) -> None:
        """Block, dispatching received messages to observers, until
        stop_receive_message is called."""

    @abstractmethod
    def stop_receive_message(self) -> None: ...
