"""A small MQTT 3.1.1 broker and client on stdlib sockets (the port of
``fedml_tpu/comm/mqtt_wire.py``; the frames are the reference's, bit for
bit).

- :class:`MiniMqttBroker`: CONNECT (with a last will and session takeover:
  a second CONNECT under a client id closes the first session, whose will
  fires), SUBSCRIBE / UNSUBSCRIBE with ``+`` / ``#`` filters
  (:func:`topic_matches`), PUBLISH at QoS 0 / 1 / 2 (PUBACK; PUBREC,
  PUBREL, PUBCOMP exactly once on both legs: an inbound QoS 2 message waits
  for its PUBREL, a redelivery under the same packet id replaces it),
  PINGREQ / PINGRESP, and the will firing on an abrupt loss alone (a
  DISCONNECT discards it).  :meth:`MiniMqttBroker.kick` closes a session
  without a DISCONNECT; :meth:`MiniMqttBroker.session_count` counts them.
- :class:`SocketMqttClient`: connect with a will, reconnect after a lost
  socket and re-subscribe every filter (clean sessions), keepalive pings,
  QoS 1 / 2 publishes acknowledged end to end (one packet id across a
  retry, DUP set).  Each ``connect`` starts a generation; reader and ping
  threads of an older one retire, so a client reconnected after
  ``disconnect`` never runs two readers on one socket.
"""

from __future__ import annotations

import logging
import socket
import struct
import threading
import time
from typing import Callable, Optional

log = logging.getLogger("fedml_tpu_torch.mqtt")

CONNECT, CONNACK, PUBLISH, PUBACK = 1, 2, 3, 4
PUBREC, PUBREL, PUBCOMP = 5, 6, 7
SUBSCRIBE, SUBACK, UNSUBSCRIBE, UNSUBACK = 8, 9, 10, 11
PINGREQ, PINGRESP, DISCONNECT = 12, 13, 14


# ---------------------------------------------------------------------------
# wire helpers
# ---------------------------------------------------------------------------
def _enc_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        d = n % 128
        n //= 128
        out.append(d | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _enc_str(s: str) -> bytes:
    b = s.encode()
    return struct.pack(">H", len(b)) + b


def _packet(ptype: int, flags: int, body: bytes) -> bytes:
    return bytes([(ptype << 4) | flags]) + _enc_varint(len(body)) + body


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("socket closed")
        buf += chunk
    return buf


def _read_packet(sock: socket.socket) -> tuple[int, int, bytes]:
    head = _read_exact(sock, 1)[0]
    ptype, flags = head >> 4, head & 0x0F
    length, mult = 0, 1
    for _ in range(4):
        d = _read_exact(sock, 1)[0]
        length += (d & 0x7F) * mult
        if not d & 0x80:
            break
        mult *= 128
    else:
        raise ValueError("malformed remaining length")
    body = _read_exact(sock, length) if length else b""
    return ptype, flags, body


def _take_str(body: bytes, off: int) -> tuple[str, int]:
    (n,) = struct.unpack_from(">H", body, off)
    off += 2
    return body[off:off + n].decode(), off + n


def topic_matches(filt: str, topic: str) -> bool:
    """MQTT 3.1.1 topic-filter matching (``+`` one level, ``#`` tail)."""
    fp, tp = filt.split("/"), topic.split("/")
    for i, f in enumerate(fp):
        if f == "#":
            return True
        if i >= len(tp):
            return False
        if f != "+" and f != tp[i]:
            return False
    return len(fp) == len(tp)


# ---------------------------------------------------------------------------
# broker
# ---------------------------------------------------------------------------
class _BrokerSession:
    def __init__(self, broker: "MiniMqttBroker", sock: socket.socket):
        self.broker = broker
        self.sock = sock
        self.client_id = ""
        self.subs: list[tuple[str, int]] = []
        self.will: Optional[tuple[str, bytes, int]] = None
        self.alive = True
        self._wlock = threading.Lock()
        self._next_pid = 1
        # QoS2 exactly-once state: inbound PUBLISHes stashed until PUBREL
        # (pid -> (topic, payload))
        self._qos2_in: dict[int, tuple[str, bytes]] = {}

    def send(self, data: bytes) -> None:
        with self._wlock:
            self.sock.sendall(data)

    def close(self, fire_will: bool) -> None:
        if not self.alive:
            return
        self.alive = False
        will = self.will if fire_will else None
        self.will = None
        try:
            # shutdown BEFORE close: close() alone doesn't send FIN while the
            # session's reader thread is still blocked in recv() on the same
            # socket (the open file description stays referenced), so the
            # peer would never observe the loss
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
        self.broker._drop(self)
        if will:
            topic, payload, qos = will
            self.broker._route(topic, payload, qos)

    # -- packet loop --------------------------------------------------------
    def run(self) -> None:
        try:
            ptype, _flags, body = _read_packet(self.sock)
            if ptype != CONNECT:
                raise ValueError("first packet must be CONNECT")
            self._handle_connect(body)
            while self.alive:
                ptype, flags, body = _read_packet(self.sock)
                if ptype == PUBLISH:
                    self._handle_publish(flags, body)
                elif ptype == PUBACK:
                    pass  # at-least-once: no broker-side redelivery queue
                elif ptype == PUBREL:
                    self._handle_pubrel(body)
                elif ptype == PUBREC:
                    (pid,) = struct.unpack_from(">H", body, 0)
                    self.send(_packet(PUBREL, 0x02, struct.pack(">H", pid)))
                elif ptype == PUBCOMP:
                    pass  # outbound QoS2 handshake complete
                elif ptype == SUBSCRIBE:
                    self._handle_subscribe(body)
                elif ptype == UNSUBSCRIBE:
                    self._handle_unsubscribe(body)
                elif ptype == PINGREQ:
                    self.send(_packet(PINGRESP, 0, b""))
                elif ptype == DISCONNECT:
                    self.close(fire_will=False)  # graceful: discard the will
                    return
                else:
                    raise ValueError(f"unsupported packet type {ptype}")
        except (ConnectionError, OSError, ValueError):
            self.close(fire_will=True)  # abrupt: the will fires

    def _handle_connect(self, body: bytes) -> None:
        proto, off = _take_str(body, 0)
        level = body[off]
        flags = body[off + 1]
        off += 4  # level + connect flags + keepalive(2)
        if proto != "MQTT" or level != 4:
            raise ValueError(f"unsupported protocol {proto!r} level {level}")
        self.client_id, off = _take_str(body, off)
        if flags & 0x04:  # will flag
            wt, off = _take_str(body, off)
            (n,) = struct.unpack_from(">H", body, off)
            off += 2
            wp = body[off:off + n]
            off += n
            self.will = (wt, wp, (flags >> 3) & 0x03)
        self.broker._register(self)
        self.send(_packet(CONNACK, 0, b"\x00\x00"))

    def _handle_publish(self, flags: int, body: bytes) -> None:
        qos = (flags >> 1) & 0x03
        topic, off = _take_str(body, 0)
        if qos == 2:
            # exactly-once inbound: stash until PUBREL; a redelivered
            # PUBLISH with the same pid just refreshes the stash (no double
            # route), and PUBREC is re-sent idempotently
            (pid,) = struct.unpack_from(">H", body, off)
            off += 2
            self._qos2_in[pid] = (topic, body[off:])
            self.send(_packet(PUBREC, 0, struct.pack(">H", pid)))
            return
        if qos == 1:
            (pid,) = struct.unpack_from(">H", body, off)
            off += 2
            self.send(_packet(PUBACK, 0, struct.pack(">H", pid)))
        self.broker._route(topic, body[off:], qos)

    def _handle_pubrel(self, body: bytes) -> None:
        (pid,) = struct.unpack_from(">H", body, 0)
        stashed = self._qos2_in.pop(pid, None)
        if stashed is not None:  # duplicate PUBREL after release: no re-route
            self.broker._route(stashed[0], stashed[1], 2)
        self.send(_packet(PUBCOMP, 0, struct.pack(">H", pid)))

    def _handle_subscribe(self, body: bytes) -> None:
        (pid,) = struct.unpack_from(">H", body, 0)
        off = 2
        granted = bytearray()
        while off < len(body):
            filt, off = _take_str(body, off)
            qos = min(body[off] & 0x03, 2)
            off += 1
            with self.broker._lock:
                self.subs = [s for s in self.subs if s[0] != filt] + [(filt, qos)]
            granted.append(qos)
        self.send(_packet(SUBACK, 0, struct.pack(">H", pid) + bytes(granted)))

    def _handle_unsubscribe(self, body: bytes) -> None:
        (pid,) = struct.unpack_from(">H", body, 0)
        off = 2
        while off < len(body):
            filt, off = _take_str(body, off)
            with self.broker._lock:
                self.subs = [s for s in self.subs if s[0] != filt]
        self.send(_packet(UNSUBACK, 0, struct.pack(">H", pid)))

    def deliver(self, topic: str, payload: bytes, qos: int) -> None:
        flags = qos << 1
        body = _enc_str(topic)
        if qos:
            with self._wlock:
                pid = self._next_pid
                self._next_pid = pid % 65535 + 1
            body += struct.pack(">H", pid)
        try:
            self.send(_packet(PUBLISH, flags, body + payload))
        except OSError:
            self.close(fire_will=True)


class MiniMqttBroker:
    """The MQTT 3.1.1 broker (module docstring).  ``start()`` returns
    the bound port (0 -> ephemeral); one daemon thread per connection."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host, self.port = host, port
        self._srv: Optional[socket.socket] = None
        self._sessions: list[_BrokerSession] = []
        self._lock = threading.Lock()
        self._accepting = False

    def start(self) -> int:
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((self.host, self.port))
        self._srv.listen(64)
        self.port = self._srv.getsockname()[1]
        self._accepting = True
        threading.Thread(target=self._accept_loop, daemon=True).start()
        return self.port

    def _accept_loop(self) -> None:
        while self._accepting:
            try:
                sock, _addr = self._srv.accept()
            except OSError:
                return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sess = _BrokerSession(self, sock)
            threading.Thread(target=sess.run, daemon=True).start()

    def stop(self) -> None:
        self._accepting = False
        try:
            self._srv.close()
        except OSError:
            pass
        with self._lock:
            sessions = list(self._sessions)
        for s in sessions:
            s.close(fire_will=False)

    # -- session management --------------------------------------------------
    def _register(self, sess: _BrokerSession) -> None:
        with self._lock:
            old = [s for s in self._sessions if s.client_id == sess.client_id]
            self._sessions.append(sess)
        for s in old:  # MQTT-3.1.4-2 session takeover: old connection closes
            s.close(fire_will=True)

    def _drop(self, sess: _BrokerSession) -> None:
        with self._lock:
            if sess in self._sessions:
                self._sessions.remove(sess)

    def _route(self, topic: str, payload: bytes, qos: int) -> None:
        with self._lock:
            targets = []
            for s in self._sessions:
                for filt, sub_qos in s.subs:
                    if topic_matches(filt, topic):
                        targets.append((s, min(qos, sub_qos)))
                        break  # one delivery per session
        for s, q in targets:
            s.deliver(topic, payload, q)

    def kick(self, client_id: str) -> None:
        """Force-close a client's socket WITHOUT a DISCONNECT — the test
        lever for abrupt-loss behavior (will fires, client must reconnect)."""
        with self._lock:
            victims = [s for s in self._sessions if s.client_id == client_id]
        for s in victims:
            s.close(fire_will=True)

    def session_count(self) -> int:
        with self._lock:
            return len(self._sessions)


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------
class SocketMqttClient:
    """MQTT 3.1.1 client with auto-reconnect + re-subscribe.

    Mirrors the paho surface the backend adapter needs: ``connect``,
    ``subscribe(topic, cb)``, ``publish(topic, payload, qos)`` (QoS-1 blocks
    for the PUBACK, retrying once through a reconnect), ``will_set`` before
    connect, ``disconnect``.  A reconnect replays every subscription —
    clean-session semantics, same as ``PahoMqttBroker._on_connect``.
    """

    def __init__(self, host: str, port: int, client_id: str,
                 keepalive: float = 30.0, reconnect_delay: float = 0.1):
        self.host, self.port, self.client_id = host, port, client_id
        self.keepalive = keepalive
        self.reconnect_delay = reconnect_delay
        self._will: Optional[tuple[str, bytes, int]] = None
        self._subs: dict[str, Callable[[str, bytes], None]] = {}
        self._sock: Optional[socket.socket] = None
        self._wlock = threading.Lock()
        self._slock = threading.Lock()
        self._next_pid = 1
        self._acks: dict[int, threading.Event] = {}
        # QoS2 state: outbound pid -> stage event pair; inbound stash until
        # the broker's PUBREL releases it (exactly-once dispatch)
        self._qos2_recs: dict[int, threading.Event] = {}
        self._qos2_comps: dict[int, threading.Event] = {}
        self._qos2_in: dict[int, tuple[str, bytes]] = {}
        self._connected = threading.Event()
        self._stopping = False
        # connection generation: each connect() bumps it, and reader/ping
        # threads exit when their generation is stale — a re-connect after
        # disconnect() must not revive the OLD threads (they would clobber
        # _connected and dial a competing session under the same client id)
        self._gen = 0
        self.reconnects = 0

    # -- lifecycle -----------------------------------------------------------
    def will_set(self, topic: str, payload: bytes, qos: int = 1) -> None:
        self._will = (topic, payload, qos)

    def connect(self) -> None:
        # a client may be re-connected after disconnect() (the adapter's
        # lazy-connect contract).  Order matters: retire the old generation
        # BEFORE clearing the stop flag — the other way round, a parked old
        # reader could pass both loop guards in the window between the two
        # writes and attach to the new socket (two readers on one socket
        # interleave partial reads and corrupt the framing).
        self._gen += 1
        gen = self._gen
        self._stopping = False
        self._do_connect()
        threading.Thread(target=self._reader_loop, args=(gen,), daemon=True).start()
        threading.Thread(target=self._ping_loop, args=(gen,), daemon=True).start()

    def _do_connect(self) -> None:
        # clean-session connect: the broker forgets the QoS2 handshake, so a
        # PUBLISH stashed between PUBREC and PUBREL will never see its PUBREL
        # — drop the stash or it is stranded (never dispatched, never freed).
        # Outbound _acks/_qos2_recs/_qos2_comps are owned by their publish()
        # threads, which time out and retire their own entries.
        self._qos2_in.clear()
        sock = socket.create_connection((self.host, self.port), timeout=10)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        flags = 0x02  # clean session
        body = _enc_str("MQTT") + bytes([4])
        will_part = b""
        if self._will:
            wt, wp, wq = self._will
            flags |= 0x04 | (wq << 3)
            will_part = _enc_str(wt) + struct.pack(">H", len(wp)) + wp
        body += bytes([flags]) + struct.pack(">H", int(self.keepalive))
        body += _enc_str(self.client_id) + will_part
        sock.sendall(_packet(CONNECT, 0, body))
        sock.settimeout(10)
        ptype, _f, ack = _read_packet(sock)
        if ptype != CONNACK or ack[1] != 0:
            raise ConnectionError(f"CONNACK refused: type={ptype} rc={ack!r}")
        sock.settimeout(None)
        self._sock = sock
        self._connected.set()
        # clean-session reconnect: replay every subscription or all FL-round
        # traffic silently stops (the exact trap PahoMqttBroker guards)
        with self._slock:
            topics = list(self._subs)
        for t in topics:
            self._send_subscribe(t)

    def disconnect(self) -> None:
        self._stopping = True
        self._connected.clear()
        sock = self._sock
        if sock is not None:
            try:
                with self._wlock:
                    sock.sendall(_packet(DISCONNECT, 0, b""))
            except OSError:
                pass
            try:
                sock.shutdown(socket.SHUT_RDWR)  # wake the blocked reader
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        self._sock = None

    # -- io loops ------------------------------------------------------------
    def _reader_loop(self, gen: int) -> None:
        while not self._stopping and gen == self._gen:
            sock = self._sock
            if sock is None or not self._connected.is_set():
                time.sleep(0.01)
                continue
            try:
                ptype, flags, body = _read_packet(sock)
            except (ConnectionError, OSError, ValueError):
                if self._stopping or gen != self._gen:
                    return  # retired generation: a newer connect() owns state
                self._connected.clear()
                self._reconnect(gen)
                continue
            if ptype == PUBLISH:
                self._handle_publish(flags, body)
            elif ptype == PUBACK:
                (pid,) = struct.unpack_from(">H", body, 0)
                ev = self._acks.pop(pid, None)
                if ev:
                    ev.set()
            elif ptype == PUBREC:
                (pid,) = struct.unpack_from(">H", body, 0)
                ev = self._qos2_recs.pop(pid, None)
                if ev:
                    ev.set()  # publish() sends the PUBREL (its thread owns retry)
            elif ptype == PUBCOMP:
                (pid,) = struct.unpack_from(">H", body, 0)
                ev = self._qos2_comps.pop(pid, None)
                if ev:
                    ev.set()
            elif ptype == PUBREL:
                (pid,) = struct.unpack_from(">H", body, 0)
                stashed = self._qos2_in.pop(pid, None)
                try:
                    self._send(_packet(PUBCOMP, 0, struct.pack(">H", pid)))
                except OSError:
                    pass
                if stashed is not None:  # duplicate PUBREL: no re-dispatch
                    self._dispatch(*stashed)
            elif ptype in (SUBACK, UNSUBACK, PINGRESP):
                pass
            else:
                log.warning("client %s: unexpected packet type %d", self.client_id, ptype)

    def _reconnect(self, gen: int) -> None:
        while not self._stopping and gen == self._gen:
            time.sleep(self.reconnect_delay)
            # re-check AFTER the sleep: a disconnect()+connect() during the
            # delay owns the state now — dialing here would open a second
            # session under the same client id and get both kicked
            if self._stopping or gen != self._gen:
                return
            try:
                self._do_connect()
                self.reconnects += 1
                return
            except OSError as e:
                log.debug("client %s reconnect failed: %s", self.client_id, e)

    def _ping_loop(self, gen: int) -> None:
        interval = max(self.keepalive / 2.0, 0.5)
        while not self._stopping and gen == self._gen:
            time.sleep(interval)
            if self._connected.is_set() and gen == self._gen:
                try:
                    self._send(_packet(PINGREQ, 0, b""))
                except OSError:
                    pass  # the reader loop owns reconnection

    def _handle_publish(self, flags: int, body: bytes) -> None:
        qos = (flags >> 1) & 0x03
        topic, off = _take_str(body, 0)
        if qos == 2:
            # exactly-once inbound: stash until the broker's PUBREL releases
            (pid,) = struct.unpack_from(">H", body, off)
            off += 2
            self._qos2_in[pid] = (topic, body[off:])
            try:
                self._send(_packet(PUBREC, 0, struct.pack(">H", pid)))
            except OSError:
                pass
            return
        if qos == 1:
            (pid,) = struct.unpack_from(">H", body, off)
            off += 2
            try:
                self._send(_packet(PUBACK, 0, struct.pack(">H", pid)))
            except OSError:
                pass
        self._dispatch(topic, body[off:])

    def _dispatch(self, topic: str, payload: bytes) -> None:
        with self._slock:
            cbs = [cb for t, cb in self._subs.items() if topic_matches(t, topic)]
        for cb in cbs:
            try:
                cb(topic, payload)
            except Exception:  # a handler crash must not kill the reader
                log.exception("client %s: on_message handler failed", self.client_id)

    def _send(self, data: bytes) -> None:
        sock = self._sock
        if sock is None:
            raise OSError("not connected")
        with self._wlock:
            sock.sendall(data)

    # -- API -----------------------------------------------------------------
    def subscribe(self, topic: str, cb: Callable[[str, bytes], None]) -> None:
        with self._slock:
            self._subs[topic] = cb
        if self._connected.is_set():
            self._send_subscribe(topic)

    def _send_subscribe(self, topic: str) -> None:
        with self._wlock:
            pid = self._next_pid
            self._next_pid = pid % 65535 + 1
        body = struct.pack(">H", pid) + _enc_str(topic) + bytes([2])
        self._send(_packet(SUBSCRIBE, 0x02, body))

    def publish(self, topic: str, payload: bytes, qos: int = 1,
                timeout: float = 10.0) -> None:
        # ONE packet id for all attempts: MQTT DUP redelivery must reuse the
        # pid — the receiver's exactly-once dedup (and the broker's QoS2
        # stash) key on it, so a fresh pid per retry would deliver twice
        with self._wlock:
            pid = self._next_pid
            self._next_pid = pid % 65535 + 1
        body = _enc_str(topic) + struct.pack(">H", pid) + payload
        rec_seen = False  # QoS2 stage: once PUBREC arrived, retries resend
        #                   PUBREL only — re-publishing after the broker
        #                   routed would not be deduped by a clean session
        for attempt in (0, 1):
            if not self._connected.wait(timeout):
                raise TimeoutError(f"client {self.client_id}: not connected")
            dup = 0x08 if attempt else 0
            if qos == 0:
                try:
                    self._send(_packet(PUBLISH, 0, _enc_str(topic) + payload))
                    return
                except OSError:
                    continue  # reader loop reconnects; one retry
            if qos == 1:
                ev = threading.Event()
                self._acks[pid] = ev
                try:
                    self._send(_packet(PUBLISH, dup | 0x02, body))
                    if ev.wait(timeout):
                        return
                except OSError:
                    pass  # fall through to the retry (reader loop reconnects)
                finally:
                    # always retire the pending entry: a stranded Event would
                    # leak per failed publish, and after the pid wrap a fresh
                    # PUBACK could route to a stale entry
                    self._acks.pop(pid, None)
                continue
            # QoS2 exactly-once: PUBLISH -> PUBREC -> PUBREL -> PUBCOMP
            rec, comp = threading.Event(), threading.Event()
            self._qos2_recs[pid] = rec
            self._qos2_comps[pid] = comp
            try:
                if not rec_seen:
                    self._send(_packet(PUBLISH, dup | 0x04, body))
                    if not rec.wait(timeout):
                        continue  # no PUBREC: redeliver (same pid, DUP set)
                    rec_seen = True
                self._send(_packet(PUBREL, 0x02, struct.pack(">H", pid)))
                if comp.wait(timeout):
                    return
            except OSError:
                pass
            finally:
                self._qos2_recs.pop(pid, None)
                self._qos2_comps.pop(pid, None)
        raise TimeoutError(
            f"client {self.client_id}: qos{qos} handshake incomplete for {topic}"
        )
