"""FedMLCommManager — handler registry + backend factory (the port of
``fedml_tpu/comm/comm_manager.py``).

Server and client managers subclass this, register one handler per message
type and run a blocking receive loop.  The backends, the reference's six:

- ``INPROC``: the in-process fabric (``comm/inproc.py``);
- ``TCP``: one socket per endpoint on ``extra.tcp_base_port + rank``
  (``comm/tcp_backend.py``);
- ``GRPC``: one gRPC server per endpoint on ``extra.grpc_base_port + rank``
  (``comm/grpc_backend.py``; needs ``grpcio``, imported for this backend
  alone);
- ``MQTT_S3``: broker topics and an object store (``comm/mqtt_s3.py``): the
  in-memory pair of one process, or with ``extra.mqtt_host`` a real MQTT
  3.1.1 session (``comm/mqtt_real.TcpMqttBroker``, to ``MiniMqttBroker`` or
  any broker) and the HTTP store at ``extra.object_store_url``, which is
  then required;
- ``WEB3`` / ``THETASTORE``: transactions on the in-memory ledger of one
  process (``comm/blockchain.py``).

``INPROC``, ``TCP`` and ``GRPC`` honour ``extra.comm_chunk_bytes``; the
MQTT and ledger backends do not take chunk frames, as in the reference.
Any ``extra.chaos_*`` fault wraps the backend in the seeded fault scheduler
(``comm/chaos.py``), and ``extra.comm_chunk_idle_sweep_s`` reaches the
receive loop before it starts.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from .. import constants as C
from ..core.flags import cfg_extra
from .base import BaseCommunicationManager, Observer
from .message import Message

PORTED_BACKENDS = (C.COMM_BACKEND_INPROC, C.COMM_BACKEND_GRPC, C.COMM_BACKEND_MQTT_S3,
                   C.COMM_BACKEND_TCP, C.COMM_BACKEND_WEB3, C.COMM_BACKEND_THETA)
#: the ledger backends (their in-memory ledger serves the endpoints of one
#: process)
LEDGER_BACKENDS = (C.COMM_BACKEND_WEB3, C.COMM_BACKEND_THETA)


def reset_in_memory_fabric(run_id) -> None:
    """Forget run ``run_id``'s in-process router, in-memory MQTT broker and
    store, and in-memory ledger, so a group built next starts on empty
    queues, topics and blocks."""
    from .blockchain import InMemoryLedger
    from .inproc import InProcRouter
    from .mqtt_s3 import InMemoryBroker, InMemoryObjectStore

    run_id = str(run_id)
    InProcRouter.reset(run_id)
    InMemoryBroker.reset(run_id)
    InMemoryObjectStore.reset(run_id)
    InMemoryLedger.reset(run_id)


def check_backend(backend: str) -> None:
    """Raise ``ValueError`` for a backend name the reference does not know."""
    if backend not in PORTED_BACKENDS:
        raise ValueError(f"unknown comm backend {backend!r}; known: {list(PORTED_BACKENDS)}")


class FedMLCommManager(Observer):
    def __init__(self, cfg, rank: int = 0, size: int = 0, backend: Optional[str] = None):
        self.cfg = cfg
        self.rank = rank
        self.size = size
        self.backend = backend or getattr(cfg, "backend", C.COMM_BACKEND_INPROC)
        check_backend(self.backend)
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
        """The backend factory (the reference's ``_init_manager``)."""
        chunk = int(cfg_extra(self.cfg, "comm_chunk_bytes") or 0)
        run_id = getattr(self.cfg, "run_id", "0")
        b = self.backend
        if b == C.COMM_BACKEND_TCP:
            from .tcp_backend import TCPCommManager

            base_port = int(cfg_extra(self.cfg, "tcp_base_port"))
            return TCPCommManager("0.0.0.0", base_port + self.rank if base_port else 0, self.rank,
                                  ip_config=cfg_extra(self.cfg, "tcp_ip_config", {}),
                                  base_port=base_port, chunk_bytes=chunk)
        if b == C.COMM_BACKEND_GRPC:
            from .grpc_backend import GRPCCommManager

            base_port = int(cfg_extra(self.cfg, "grpc_base_port"))
            return GRPCCommManager("0.0.0.0", base_port + self.rank if base_port else 0,
                                   self.rank, ip_config=cfg_extra(self.cfg, "grpc_ip_config", {}),
                                   base_port=base_port, chunk_bytes=chunk)
        if b == C.COMM_BACKEND_MQTT_S3:
            from .mqtt_s3 import MqttS3CommManager

            broker = store = None
            mqtt_host = cfg_extra(self.cfg, "mqtt_host")
            if mqtt_host:
                store_url = cfg_extra(self.cfg, "object_store_url")
                if not store_url:
                    # with a broker between processes, the in-memory store
                    # of each process would strand every long payload
                    raise ValueError(
                        "extra.mqtt_host is set but extra.object_store_url is not; a real "
                        "broker needs a shared payload store "
                        "(comm.object_store_http.MiniObjectStoreServer or S3)")
                from .mqtt_real import TcpMqttBroker
                from .object_store_http import HttpObjectStore

                broker = TcpMqttBroker(mqtt_host, int(cfg_extra(self.cfg, "mqtt_port")),
                                       client_id=f"{run_id}_{self.rank}")
                store = HttpObjectStore(store_url)
            return MqttS3CommManager(run_id, self.rank, broker=broker, store=store)
        if b in LEDGER_BACKENDS:
            from .blockchain import BlockchainCommManager

            return BlockchainCommManager(run_id, self.rank)
        from .inproc import InProcCommManager

        return InProcCommManager(run_id, self.rank, chunk_bytes=chunk)
