"""FedMLCommManager — handler registry + backend factory (the port of
``fedml_tpu/comm/comm_manager.py``).

Server and client managers subclass this, register one handler per message
type and run a blocking receive loop.  Ported backends: ``INPROC`` and
``TCP`` (both honour ``extra.comm_chunk_bytes``); any ``extra.chaos_*``
fault wraps the backend in the seeded fault scheduler (``comm/chaos.py``),
and ``extra.comm_chunk_idle_sweep_s`` reaches the receive loop before it
starts.  ``GRPC`` and ``MQTT_S3`` need packages (``grpcio``, a broker) this
port does not depend on, and ``WEB3`` / ``THETASTORE`` are not ported:
they raise ``NotImplementedError``.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from .. import constants as C
from ..core.flags import cfg_extra
from .base import BaseCommunicationManager, Observer
from .message import Message

PORTED_BACKENDS = (C.COMM_BACKEND_INPROC, C.COMM_BACKEND_TCP)
_KNOWN_BACKENDS = (C.COMM_BACKEND_INPROC, C.COMM_BACKEND_GRPC, C.COMM_BACKEND_MQTT_S3,
                   C.COMM_BACKEND_TCP, C.COMM_BACKEND_WEB3, C.COMM_BACKEND_THETA)


def refuse_unported_transport(backend: str) -> None:
    """Raise for a backend this port does not serve."""
    if backend in PORTED_BACKENDS:
        return
    if backend in _KNOWN_BACKENDS:
        raise NotImplementedError(f"comm backend {backend!r} is not ported yet "
                                  f"(ported: {PORTED_BACKENDS})")
    raise ValueError(f"unknown comm backend {backend!r}; known: {list(_KNOWN_BACKENDS)}")


class FedMLCommManager(Observer):
    def __init__(self, cfg, rank: int = 0, size: int = 0, backend: Optional[str] = None):
        self.cfg = cfg
        self.rank = rank
        self.size = size
        self.backend = backend or getattr(cfg, "backend", C.COMM_BACKEND_INPROC)
        refuse_unported_transport(self.backend)
        self.message_handler_dict: dict[int, Callable[[Message], None]] = {}
        self.com_manager: BaseCommunicationManager = self._init_manager()
        from .chaos import wrap_with_chaos

        self.com_manager = wrap_with_chaos(self.com_manager, cfg, rank)
        self.com_manager.configure_chunk_sweep(float(cfg_extra(cfg, "comm_chunk_idle_sweep_s")))
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
        chunk = int(cfg_extra(self.cfg, "comm_chunk_bytes") or 0)
        if self.backend == C.COMM_BACKEND_TCP:
            from .tcp_backend import TCPCommManager

            base_port = int(cfg_extra(self.cfg, "tcp_base_port"))
            return TCPCommManager("0.0.0.0", base_port + self.rank if base_port else 0, self.rank,
                                  ip_config=cfg_extra(self.cfg, "tcp_ip_config", {}),
                                  base_port=base_port, chunk_bytes=chunk)
        from .inproc import InProcCommManager

        return InProcCommManager(getattr(self.cfg, "run_id", "0"), self.rank, chunk_bytes=chunk)
