"""In-process loopback transport (the port of ``fedml_tpu/comm/inproc.py``).

Every endpoint of a run has a queue, routed through a shared
``InProcRouter`` keyed by run_id, so a server and its clients run as
threads of one process.  Every send goes through ``Message.encode`` and the
receiver's ``Message.decode``: the fabric carries exactly the bytes a remote
backend would.
"""

from __future__ import annotations

import queue
import threading
from collections import defaultdict

from .base import BaseCommunicationManager, ObserverLoopMixin
from .message import Message


class InProcRouter:
    """Shared message fabric for one run_id (the 'broker')."""

    _routers: dict[str, "InProcRouter"] = {}
    _lock = threading.Lock()

    def __init__(self):
        self.queues: dict[int, queue.Queue] = defaultdict(queue.Queue)

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

    def route(self, msg: Message) -> None:
        self.queues[msg.get_receiver_id()].put(msg.encode())


class InProcCommManager(ObserverLoopMixin, BaseCommunicationManager):
    def __init__(self, run_id: str, rank: int):
        self.run_id = str(run_id)
        self.rank = rank
        self.router = InProcRouter.get(self.run_id)
        self._init_observer_loop(inbox=self.router.queues[rank])

    def send_message(self, msg: Message) -> None:
        self.router.route(msg)
