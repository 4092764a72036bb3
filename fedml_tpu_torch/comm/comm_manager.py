"""FedMLCommManager — handler registry + backend factory (the port of
``fedml_tpu/comm/comm_manager.py``).

Server and client managers subclass this, register one handler per message
type and run a blocking receive loop.  Ported backend: ``INPROC``.  Every
other backend, chaos injection (``extra.chaos_*``) and transport chunking
(``extra.comm_chunk_bytes``) raise ``NotImplementedError``.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from .. import constants as C
from ..core.flags import cfg_extra
from .base import BaseCommunicationManager, Observer
from .message import Message

_CHAOS_FLAGS = ("chaos_seed", "chaos_drop_prob", "chaos_delay_prob", "chaos_duplicate_prob",
                "chaos_reorder_prob", "chaos_corrupt_prob", "chaos_reset_prob",
                "chaos_partition")


def refuse_unported_transport(cfg, backend: str) -> None:
    """Raise for a transport feature this slice does not serve."""
    if backend != C.COMM_BACKEND_INPROC:
        raise NotImplementedError(f"comm backend {backend!r} is not ported yet "
                                  f"(ported: {C.COMM_BACKEND_INPROC!r})")
    for flag in _CHAOS_FLAGS:
        if cfg_extra(cfg, flag):
            raise NotImplementedError(f"extra.{flag} (chaos injection) is not ported yet")
    if cfg_extra(cfg, "comm_chunk_bytes"):
        raise NotImplementedError("extra.comm_chunk_bytes (transport chunk frames) is not "
                                  "ported yet")


class FedMLCommManager(Observer):
    def __init__(self, cfg, rank: int = 0, size: int = 0, backend: Optional[str] = None):
        self.cfg = cfg
        self.rank = rank
        self.size = size
        self.backend = backend or getattr(cfg, "backend", C.COMM_BACKEND_INPROC)
        refuse_unported_transport(cfg, self.backend)
        self.message_handler_dict: dict[int, Callable[[Message], None]] = {}
        self.com_manager: BaseCommunicationManager = self._init_manager()
        self.com_manager.add_observer(self)

    def register_message_receive_handler(self, msg_type: int, handler: Callable) -> None:
        self.message_handler_dict[msg_type] = handler

    def send_message(self, message: Message) -> None:
        self.com_manager.send_message(message)

    def receive_message(self, msg_type: int, msg: Message) -> None:
        handler = self.message_handler_dict.get(msg_type)
        if handler is None:
            raise KeyError(
                f"no handler registered for msg_type {msg_type} (rank {self.rank}); "
                f"registered: {sorted(self.message_handler_dict)}")
        handler(msg)

    def run(self) -> None:
        """Blocking receive loop (reference ``FedMLCommManager.run``)."""
        self.register_message_receive_handlers()
        self.com_manager.handle_receive_message()

    def run_in_thread(self) -> threading.Thread:
        t = threading.Thread(target=self.run, daemon=True)
        t.start()
        return t

    def finish(self) -> None:
        self.com_manager.stop_receive_message()

    def register_message_receive_handlers(self) -> None:
        """Subclasses register their protocol handlers here."""
        raise NotImplementedError

    def _init_manager(self) -> BaseCommunicationManager:
        from .inproc import InProcCommManager

        return InProcCommManager(getattr(self.cfg, "run_id", "0"), self.rank)
