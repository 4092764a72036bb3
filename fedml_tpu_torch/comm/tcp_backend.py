"""Plain-TCP communication backend (the port of
``fedml_tpu/comm/tcp_backend.py``).

One listening socket per endpoint and one short-lived connection per
message, frames of::

    [8-byte LE frame length][Message bytes]

the reference's bytes (``Message.encode``; with ``chunk_bytes`` a large
message crosses as several transport chunk frames on one connection).
Endpoint ``i`` listens on ``base_port + i`` and sends to ``base_port + j``
on ``ip_config[j]`` (default loopback).

``base_port`` 0 (``extra.tcp_base_port: 0``) binds an ephemeral port the
system picks; the endpoints of one process then learn each other's ports
from :func:`link_ports`, which the in-process group calls.  (The reference
would bind ``0 + i``; this is how a test or a loopback run stays clear of
ports in use.)  Endpoints in different processes meet only on the fixed
ports ``base_port + i``.  The listener sets ``SO_REUSEADDR``, so an
endpoint restarted after a SIGKILL rebinds its port past the predecessor's
TIME_WAIT connections; a port still held (the predecessor not yet reaped)
is retried for up to ``BIND_RETRY_S``.
"""

from __future__ import annotations

import errno
import itertools
import logging
import socket
import struct
import threading
import time
from typing import Optional

from . import wire
from .base import BaseCommunicationManager, ObserverLoopMixin
from .message import Message

log = logging.getLogger("fedml_tpu_torch.comm.tcp")

FRAME_HEADER = struct.Struct("<Q")
MAX_FRAME_BYTES = 1 << 30  # 1 GB, the reference's cap
BIND_RETRY_S = 5.0  # a fixed port still held is retried this long


def read_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            raise ConnectionError(f"peer closed mid-frame ({len(buf)}/{n} bytes)")
        buf.extend(chunk)
    return bytes(buf)


def send_frame(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(FRAME_HEADER.pack(len(payload)) + payload)


def recv_frame(sock: socket.socket) -> bytes:
    (n,) = FRAME_HEADER.unpack(read_exact(sock, FRAME_HEADER.size))
    if n > MAX_FRAME_BYTES:
        raise ValueError(f"frame of {n} bytes exceeds {MAX_FRAME_BYTES}")
    return read_exact(sock, n)


class TCPCommManager(ObserverLoopMixin, BaseCommunicationManager):
    """Endpoint ``rank`` listening on ``port``; a send to rank ``j`` goes
    to ``port_map[j]`` when the map names it, else ``base_port + j``."""

    def __init__(self, host: str, port: int, rank: int, ip_config: Optional[dict] = None,
                 base_port: int = 9690, chunk_bytes: int = 0):
        self._init_observer_loop()
        self.rank = rank
        self.base_port = base_port
        self.ip_config = {int(k): v for k, v in (ip_config or {}).items()}
        self.chunk_bytes = int(chunk_bytes or 0)
        #: rank -> listening port of the peers whose port is not base + rank
        self.port_map: dict[int, int] = {}
        self._stream_seq = itertools.count()
        self._listener = _bind_listener(host, port)
        #: the port this endpoint listens on (the system's pick for port 0)
        self.listen_port = self._listener.getsockname()[1]
        self._accept_thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return  # listener closed
            threading.Thread(target=self._serve_conn, args=(conn,), daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            with conn:
                while True:
                    self._inbox.put(recv_frame(conn))
        except (ConnectionError, OSError):
            pass  # a connection closes after its message
        except ValueError as e:
            # an oversized or corrupt frame: the sender saw success, so this
            # line is the only trace of the lost message
            log.error("rank %d dropping connection: %s", self.rank, e)

    def _address(self, rid: int) -> tuple:
        rid = int(rid)
        return (self.ip_config.get(rid, "127.0.0.1"),
                self.port_map.get(rid, self.base_port + rid))

    def send_message(self, msg: Message) -> None:
        payload = msg.encode()
        with socket.create_connection(self._address(msg.get_receiver_id()), timeout=30.0) as s:
            if self.chunk_bytes and len(payload) > self.chunk_bytes:
                stream_id = f"{self.rank}.{next(self._stream_seq)}"
                for frame in wire.encode_chunk_frames(payload, stream_id=stream_id,
                                                      sender=self.rank,
                                                      chunk_bytes=self.chunk_bytes):
                    send_frame(s, frame)
            else:
                send_frame(s, payload)

    def send_raw(self, receiver_id: int, payload: bytes) -> None:
        """One raw frame to a peer, past ``Message.encode`` (the chaos
        wrapper's corrupt-frame injection point)."""
        with socket.create_connection(self._address(receiver_id), timeout=30.0) as s:
            send_frame(s, payload)

    def stop_receive_message(self) -> None:
        super().stop_receive_message()
        try:
            self._listener.close()
        except OSError:
            pass


def _bind_listener(host: str, port: int) -> socket.socket:
    """A listening socket on ``(host, port)`` with ``SO_REUSEADDR``; a fixed
    port in use is retried for ``BIND_RETRY_S``."""
    deadline = time.monotonic() + (BIND_RETRY_S if port else 0.0)
    while True:
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            sock.bind((host, port))
            sock.listen(64)
            return sock
        except OSError as e:
            sock.close()
            if e.errno != errno.EADDRINUSE or time.monotonic() >= deadline:
                raise
            time.sleep(0.1)


def link_ports(managers) -> dict:
    """Tell every TCP endpoint among ``managers`` (comm managers, or their
    ``com_manager``, chaos-wrapped or not) the listening ports of all the
    others; returns the shared ``{rank: port}`` map.  Call it again after an
    endpoint restarts on a new port."""
    eps = []
    for m in managers:
        cm = getattr(m, "com_manager", m)
        cm = getattr(cm, "inner", cm)
        if isinstance(cm, TCPCommManager):
            eps.append(cm)
    ports = {cm.rank: cm.listen_port for cm in eps}
    for cm in eps:
        cm.port_map.update(ports)
    return ports
