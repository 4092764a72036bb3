"""In-process loopback transport (the port of ``fedml_tpu/comm/inproc.py``).

Every endpoint of a run has a queue, routed through a shared
``InProcRouter`` keyed by run_id, so a server and its clients run as
threads of one process.  Every send goes through ``Message.encode`` and the
receiver's ``Message.decode``: the fabric carries exactly the bytes a remote
backend would.  With ``chunk_bytes`` (``extra.comm_chunk_bytes``) a frame
past the bound crosses as transport chunk frames, on both legs.
"""

from __future__ import annotations

import itertools
import queue
import threading
from collections import defaultdict

from . import wire
from .base import BaseCommunicationManager, ObserverLoopMixin
from .message import Message


class InProcRouter:
    """Shared message fabric for one run_id (the 'broker')."""

    _routers: dict[str, "InProcRouter"] = {}
    _lock = threading.Lock()

    def __init__(self):
        self.queues: dict[int, queue.Queue] = defaultdict(queue.Queue)
        self._stream_seq = itertools.count()

    @classmethod
    def get(cls, run_id: str) -> "InProcRouter":
        with cls._lock:
            if run_id not in cls._routers:
                cls._routers[run_id] = cls()
            return cls._routers[run_id]

    @classmethod
    def reset(cls, run_id: str) -> None:
        with cls._lock:
            cls._routers.pop(run_id, None)

    def route(self, msg: Message, chunk_bytes: int = 0) -> None:
        """Deliver one message: one whole frame, or chunk frames when
        ``chunk_bytes`` > 0 and the frame is larger."""
        data = msg.encode()  # the wire round trip
        if chunk_bytes and len(data) > chunk_bytes:
            stream_id = f"{msg.get_sender_id()}.{next(self._stream_seq)}"
            frames = list(wire.encode_chunk_frames(data, stream_id=stream_id,
                                                   sender=msg.get_sender_id(),
                                                   chunk_bytes=chunk_bytes))
        else:
            frames = [data]
        target = self.queues[msg.get_receiver_id()]
        for frame in frames:
            target.put(frame)


class InProcCommManager(ObserverLoopMixin, BaseCommunicationManager):
    def __init__(self, run_id: str, rank: int, chunk_bytes: int = 0):
        self.run_id = str(run_id)
        self.rank = rank
        self.chunk_bytes = int(chunk_bytes or 0)
        self.router = InProcRouter.get(self.run_id)
        self._init_observer_loop(inbox=self.router.queues[rank])

    def send_message(self, msg: Message) -> None:
        self.router.route(msg, chunk_bytes=self.chunk_bytes)

    def send_raw(self, receiver_id: int, payload: bytes) -> None:
        """Raw frame bytes into a peer's inbox, past the Message round trip
        (the chaos wrapper's corrupt-frame injection point)."""
        self.router.queues[receiver_id].put(payload)
