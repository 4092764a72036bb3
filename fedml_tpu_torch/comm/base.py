"""Abstract communication backend + observer interface (the port of
``fedml_tpu/comm/base.py``).

A backend moves ``Message``s between numbered endpoints and notifies its
observers on receive.  :class:`ObserverLoopMixin` is the receive loop every
backend shares: take a raw payload from the inbox, decode it, dispatch it.
A payload that does not decode is dropped loudly and a handler that raises
is contained: one poisoned message must not kill the endpoint.

Not ported yet (Queue 1 item 10 / later comm slices): the registry counters
of the reference's loop, the comm-event sinks, the deferred retry of
transiently undecodable payloads (an object-store transport's concern; the
in-process fabric has none) and chunk-frame reassembly.
"""

from __future__ import annotations

import logging
import queue
from abc import ABC, abstractmethod

from .message import Message

log = logging.getLogger(__name__)

#: purpose constant namespacing the server's status re-probe jitter stream
#: (the reference's value, so both packages draw the same delays)
BACKOFF_PURPOSE_STATUS_PROBE = 0x53545052    # "STPR"


def backoff_delay(attempt: int, *, base: float = 0.2, cap: float = 2.0, seed: int = 0,
                  purpose: int = 0) -> float:
    """Capped exponential backoff with deterministic jitter: ``base *
    2**attempt`` clipped at ``cap``, scaled by a factor in ``[0.5, 1.0)``
    drawn from ``default_rng([purpose, seed, attempt])``."""
    import numpy as np

    raw = min(float(cap), float(base) * (2.0 ** int(attempt)))
    frac = float(np.random.default_rng([int(purpose), int(seed), int(attempt)]).random())
    return raw * (0.5 + 0.5 * frac)


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

    def add_observer(self, observer: Observer) -> None:
        self._observers.append(observer)

    def handle_receive_message(self) -> None:
        self._running = True
        while self._running:
            try:
                data = self._inbox.get(timeout=0.05)
            except queue.Empty:
                continue
            try:
                msg = Message.decode(data)
            except (KeyError, ValueError, NotImplementedError):
                log.exception("dropping undecodable message (%d bytes)", len(data))
                continue
            self._dispatch(msg)

    def _dispatch(self, msg: Message) -> None:
        for obs in list(self._observers):
            try:
                obs.receive_message(msg.get_type(), msg)
            except Exception:
                # a handler crash must not kill the loop: one poisoned
                # message, not a dead endpoint
                log.exception("observer %r failed on message type %s", obs, msg.get_type())

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
