"""gRPC communication backend (the port of ``fedml_tpu/comm/grpc_backend.py``).

Each endpoint is a gRPC server with one generic unary method,
``/fedml_tpu.CommService/SendMessage`` (bytes in, empty bytes out: no
generated stubs), and one channel for each peer it sends to.  A message is one call
carrying its ``Message.encode`` bytes; with ``chunk_bytes`` a longer message
crosses as transport chunk frames, one call each, so uploads interleave
through the server's thread pool.  Messages up to 1 GB, the reference's cap.
A failed call raises ``ConnectionError`` (the reference lets gRPC's
``RpcError`` through; the port's senders read an ``OSError`` as a
transport fault).  Endpoint ``i`` listens on ``base_port + i`` and sends to ``base_port + j`` on
``ip_config[j]`` (default loopback).

``base_port`` 0 binds a port the system picks, and the endpoints of one
process learn each other's from ``comm/tcp_backend.link_ports``, as over TCP
(the reference would bind ``0 + i``).

``grpcio`` is imported with this module, which the backend factory imports
only for ``backend: GRPC``.
"""

from __future__ import annotations

import itertools
import queue
from concurrent import futures
from typing import Optional

import grpc

from . import wire
from .base import BaseCommunicationManager, ObserverLoopMixin
from .message import Message

SERVICE_METHOD = "/fedml_tpu.CommService/SendMessage"
MAX_MESSAGE_BYTES = 1024 * 1024 * 1024
_GRPC_OPTS = [
    ("grpc.max_send_message_length", MAX_MESSAGE_BYTES),
    ("grpc.max_receive_message_length", MAX_MESSAGE_BYTES),
]
CALL_TIMEOUT_S = 60.0


def _identity(b: bytes) -> bytes:
    return b


class _Servicer(grpc.GenericRpcHandler):
    def __init__(self, inbox: queue.Queue):
        self.inbox = inbox

    def service(self, handler_call_details):
        if handler_call_details.method != SERVICE_METHOD:
            return None

        def handler(request: bytes, context) -> bytes:
            self.inbox.put(request)
            return b""

        return grpc.unary_unary_rpc_method_handler(
            handler, request_deserializer=_identity, response_serializer=_identity)


class GRPCCommManager(ObserverLoopMixin, BaseCommunicationManager):
    """Endpoint ``rank``: a gRPC server on ``host:port`` and a channel for
    each peer; a send to rank ``j`` goes to ``port_map[j]`` when the map names
    it, else ``base_port + j``."""

    def __init__(self, host: str, port: int, rank: int, ip_config: Optional[dict] = None,
                 base_port: int = 8890, chunk_bytes: int = 0):
        self.rank = rank
        self.ip_config = {int(k): v for k, v in (ip_config or {}).items()}
        self.base_port = base_port
        self.chunk_bytes = int(chunk_bytes or 0)
        #: rank -> listening port of the peers whose port is not base + rank
        self.port_map: dict[int, int] = {}
        self._stream_seq = itertools.count()
        self._init_observer_loop()
        self._channels: dict[int, grpc.Channel] = {}
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=8), options=_GRPC_OPTS)
        self._server.add_generic_rpc_handlers((_Servicer(self._inbox),))
        #: the port this endpoint listens on (the system's pick for port 0)
        self.listen_port = self._server.add_insecure_port(f"{host}:{port}")
        if self.listen_port == 0:
            raise OSError(f"gRPC endpoint {rank} failed to bind {host}:{port} (port in use?); "
                          "refusing to start a deaf endpoint")
        self._server.start()

    def _target_for(self, receiver_id: int) -> str:
        rid = int(receiver_id)
        host = self.ip_config.get(rid, "127.0.0.1")
        return f"{host}:{self.port_map.get(rid, self.base_port + rid)}"

    def _stub(self, receiver_id: int):
        rid = int(receiver_id)
        if rid not in self._channels:
            self._channels[rid] = grpc.insecure_channel(self._target_for(rid),
                                                        options=_GRPC_OPTS)
        return self._channels[rid].unary_unary(
            SERVICE_METHOD, request_serializer=_identity, response_deserializer=_identity)

    def _call(self, receiver_id: int, frames) -> None:
        stub = self._stub(receiver_id)
        try:
            for frame in frames:
                stub(frame, timeout=CALL_TIMEOUT_S)
        except grpc.RpcError as e:
            # the port's callers read a transport fault as an OSError (a
            # best-effort probe, the upload's reconnect loop)
            raise ConnectionError(f"gRPC send to rank {receiver_id} failed: {e}") from e

    def send_message(self, msg: Message) -> None:
        payload = msg.encode()
        if self.chunk_bytes and len(payload) > self.chunk_bytes:
            stream_id = f"{self.rank}.{next(self._stream_seq)}"
            frames = wire.encode_chunk_frames(payload, stream_id=stream_id, sender=self.rank,
                                              chunk_bytes=self.chunk_bytes)
        else:
            frames = (payload,)
        self._call(msg.get_receiver_id(), frames)

    def send_raw(self, receiver_id: int, payload: bytes) -> None:
        """One raw call to a peer, past ``Message.encode`` (the chaos
        wrapper's corrupt-frame injection point)."""
        self._call(receiver_id, (payload,))

    def stop_receive_message(self) -> None:
        super().stop_receive_message()
        self._server.stop(grace=0.2)
        for ch in self._channels.values():
            ch.close()
