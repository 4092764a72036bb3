"""Port parity: the MQTT + object-store backend (``fedml_tpu_torch/comm/``
``mqtt_wire.py``, ``mqtt_s3.py``, ``object_store_http.py``, ``mqtt_real.py``
and the receive loop's ``_decode_bytes`` hook in ``base.py``) against
``fedml_tpu/comm/`` on the CPU.

Tolerances:

- host layers, bitwise: the MQTT packet codecs and the frames each
  package's client and broker put on a socket (CONNECT with a will,
  SUBSCRIBE, PUBLISH at each QoS, the broker's deliveries), the topic
  payloads (``D`` + the message, or ``R`` + the store reference, whose key
  is a fresh ``uuid4`` in both packages and is compared by its form), the
  blobs in the store, and ``topic_matches``;
- behaviour, equal: pub/sub with ``+`` / ``#``, the will on an abrupt loss
  only, reconnect with re-subscribe, QoS 2 exactly once (a duplicate
  PUBLISH included), session takeover, each with the port's client against
  the port's broker and each package's client against the other's broker;
  the paho / boto3 adapters against the reference's fakes;
- a cross-silo run over real MQTT framing and the HTTP store (the LR, 2
  silos, 4 rounds, payloads over 512 bytes through the store, silo 2's
  session kicked at round 1's close): local SGD is not bitwise between XLA
  and PyTorch, so the globals are held to ``RUN_TOL`` = 2e-6 (the LR's
  spread over 3 rounds is 1.2e-7, measured), the test accuracy to 1e-6.

Every socket binds an ephemeral port; every wait has its own timeout.
"""

import json
import socket
import struct
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from .conftest import tiny_config
from .test_mqtt_real import FakePaho1, FakePaho2

torch.set_num_threads(1)

RUN_TOL = 2e-6
PAIRS = [("port", "port"), ("port", "ref"), ("ref", "port")]  # (client, broker)


def _wire(pkg):
    if pkg == "ref":
        from fedml_tpu.comm import mqtt_wire
    else:
        from fedml_tpu_torch.comm import mqtt_wire
    return mqtt_wire


def _wait(pred, timeout=10.0, msg="condition"):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


def _subscribed(broker, client_id, *filters):
    """Wait until ``broker`` (either package's) holds a live session of
    ``client_id`` subscribed to every filter."""
    def held():
        with broker._lock:
            return any(sess.client_id == client_id and sess.alive
                       and set(filters) <= {f for f, _ in sess.subs}
                       for sess in broker._sessions)

    _wait(held, msg=f"{client_id}'s subscriptions {filters}")


@pytest.fixture
def brokers():
    """Started brokers by package, stopped at the end."""
    started = {}

    def get(pkg):
        if pkg not in started:
            b = _wire(pkg).MiniMqttBroker()
            b.start()
            started[pkg] = b
        return started[pkg]

    yield get
    for b in started.values():
        b.stop()


@pytest.fixture
def clients():
    """Clients by (package, broker, client id), disconnected at the end."""
    made = []

    def make(pkg, broker, cid, **kw):
        c = _wire(pkg).SocketMqttClient("127.0.0.1", broker.port, cid, **kw)
        made.append(c)
        return c

    yield make
    for c in made:
        c.disconnect()


# -- the packet codecs ------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 127, 128, 16383, 16384, 2097151, 2097152, 268435455])
def test_packet_codecs_bitwise(n):
    """The remaining-length varint, strings and packets, and the packet
    reader on each other's bytes."""
    port, ref = _wire("port"), _wire("ref")
    assert port._enc_varint(n) == ref._enc_varint(n)
    topic = f"fedml_run_{n}/to/ü"
    assert port._enc_str(topic) == ref._enc_str(topic)
    assert port._take_str(ref._enc_str(topic) + b"x", 0) == ref._take_str(
        ref._enc_str(topic) + b"x", 0)
    body = bytes(range(256)) * (1 + n % 7)
    for ptype in range(1, 15):
        for flags in (0, 0x02, 0x0C):
            assert port._packet(ptype, flags, body) == ref._packet(ptype, flags, body)
    a, b = socket.socketpair()
    try:
        a.sendall(ref._packet(3, 0x02, body) + port._packet(12, 0, b""))
        assert port._read_packet(b) == (3, 0x02, body)
        assert ref._read_packet(b) == (12, 0, b"")
    finally:
        a.close()
        b.close()
    assert (port.CONNECT, port.PUBREL, port.DISCONNECT) == (ref.CONNECT, ref.PUBREL,
                                                             ref.DISCONNECT)


@pytest.mark.parametrize("filt,topic", [
    ("a/b", "a/b"), ("a/b", "a/c"), ("a/+", "a/b"), ("a/+", "a/b/c"), ("a/#", "a"),
    ("a/#", "a/b/c"), ("#", "x/y"), ("+/+", "a/b"), ("+", "a/b"), ("a/+/c", "a/b/c"),
    ("a/b/c", "a/b"), ("fedml_r_to_0", "fedml_r_to_0")])
def test_topic_matches_like_the_reference(filt, topic):
    assert _wire("port").topic_matches(filt, topic) == _wire("ref").topic_matches(filt, topic)


def _raw_peer():
    """A listening socket that accepts one client, answers its CONNECT with
    CONNACK and records every byte it sends after."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    state = {"frames": []}

    def serve():
        w = _wire("ref")
        conn, _ = srv.accept()
        state["conn"] = conn
        try:
            while True:
                ptype, flags, body = w._read_packet(conn)
                state["frames"].append(w._packet(ptype, flags, body))
                if ptype == w.CONNECT:
                    conn.sendall(w._packet(w.CONNACK, 0, b"\x00\x00"))
                elif ptype == w.PUBLISH and (flags >> 1) & 0x03 == 1:
                    (n,) = struct.unpack_from(">H", body, 0)
                    conn.sendall(w._packet(w.PUBACK, 0, body[2 + n:4 + n]))
        except (ConnectionError, OSError, ValueError):
            pass

    threading.Thread(target=serve, daemon=True).start()
    return srv, state


def test_client_and_broker_frames_bitwise(brokers):
    """Each package's client puts the same CONNECT (clean session, will),
    SUBSCRIBE, QoS 0 PUBLISH and DISCONNECT bytes on the socket, and each
    broker delivers a QoS 1 message to a raw subscriber in the same PUBLISH
    frame."""
    sent = {}
    for pkg in ("port", "ref"):
        srv, state = _raw_peer()
        c = _wire(pkg).SocketMqttClient("127.0.0.1", srv.getsockname()[1], "silo_7",
                                        keepalive=30.0)
        c.will_set("fedml_r_status", b'{"ID": 7, "status": "OFFLINE"}', qos=1)
        c.connect()
        c.subscribe("fedml_r_to_7", lambda t, p: None)
        c.publish("fedml_r_to_0", b"D\x00\x01payload", qos=0)
        time.sleep(0.2)
        c.disconnect()
        _wait(lambda: len(state["frames"]) >= 4, msg="client frames")
        sent[pkg] = state["frames"][:4]
        srv.close()
    assert sent["port"] == sent["ref"]
    assert [f[0] >> 4 for f in sent["port"]] == [1, 8, 3, 14]

    delivered = {}
    for pkg in ("port", "ref"):
        w = _wire(pkg)
        broker = brokers(pkg)
        raw = socket.create_connection(("127.0.0.1", broker.port), timeout=5)
        body = w._enc_str("MQTT") + bytes([4, 0x02]) + struct.pack(">H", 30) + w._enc_str("raw")
        raw.sendall(w._packet(w.CONNECT, 0, body))
        assert w._read_packet(raw) == (w.CONNACK, 0, b"\x00\x00")
        raw.sendall(w._packet(w.SUBSCRIBE, 0x02, struct.pack(">H", 1) + w._enc_str("t/+") +
                              bytes([1])))
        assert w._read_packet(raw) == (w.SUBACK, 0, struct.pack(">H", 1) + bytes([1]))
        pub = w.SocketMqttClient("127.0.0.1", broker.port, "pub")
        pub.connect()
        pub.publish("t/x", b"\xff" * 300, qos=1)
        pub.disconnect()
        delivered[pkg] = w._packet(*w._read_packet(raw))
        raw.close()
    assert delivered["port"] == delivered["ref"]


def test_tcp_broker_adapter_frames_bitwise():
    """The manager's real-broker adapter (``TcpMqttBroker``) of each
    package: no connection until the first subscribe (lazy), the will set
    before it rides the CONNECT at QoS 1, and a publish goes out at QoS 1
    and waits for its PUBACK; the same bytes from both packages."""
    sent = {}
    for pkg in ("port", "ref"):
        srv, state = _raw_peer()
        real = _real(pkg)
        b = real.TcpMqttBroker("127.0.0.1", srv.getsockname()[1], client_id="run_3")
        b.set_will("run_3", "fedml_run_status", b'{"ID": 3, "status": "OFFLINE"}')
        time.sleep(0.1)
        assert "conn" not in state  # lazy: nothing dialled yet
        b.subscribe("fedml_run_to_3", lambda t, p: None)
        b.publish("fedml_run_to_0", b"D" + bytes(range(200)))  # returns on the PUBACK
        b.disconnect()
        _wait(lambda: len(state["frames"]) >= 4, msg="adapter frames")
        sent[pkg] = state["frames"][:4]
        srv.close()
    assert sent["port"] == sent["ref"]
    connect, subscribe, publish, disconnect = sent["port"]
    assert [f[0] >> 4 for f in sent["port"]] == [1, 8, 3, 14]
    assert publish[0] & 0x06 == 0x02 and connect.endswith(b'"OFFLINE"}')


# -- behaviour, each client against each broker -------------------------------------

@pytest.mark.parametrize("client_pkg,broker_pkg", PAIRS)
def test_pubsub_roundtrip_and_wildcards(brokers, clients, client_pkg, broker_pkg):
    broker = brokers(broker_pkg)
    got = []
    a, b = clients(client_pkg, broker, "a"), clients(client_pkg, broker, "b")
    a.connect()
    b.connect()
    a.subscribe("fl/1/exact", lambda t, p: got.append(("exact", t, p)))
    a.subscribe("fl/+/plus", lambda t, p: got.append(("plus", t, p)))
    a.subscribe("deep/#", lambda t, p: got.append(("hash", t, p)))
    _subscribed(broker, "a", "fl/1/exact", "fl/+/plus", "deep/#")
    b.publish("fl/1/exact", b"\x00\x01binary\xff")
    b.publish("fl/42/plus", b"p")
    b.publish("deep/x/y/z", b"h")
    b.publish("fl/2/exact", b"MISS")
    _wait(lambda: len(got) >= 3, msg="3 deliveries")
    time.sleep(0.1)
    assert sorted(got) == sorted([("exact", "fl/1/exact", b"\x00\x01binary\xff"),
                                  ("plus", "fl/42/plus", b"p"), ("hash", "deep/x/y/z", b"h")])


@pytest.mark.parametrize("client_pkg,broker_pkg", PAIRS)
def test_will_fires_on_abrupt_loss_only(brokers, clients, client_pkg, broker_pkg):
    broker = brokers(broker_pkg)
    status = []
    watcher = clients(client_pkg, broker, "watcher")
    watcher.connect()
    watcher.subscribe("status", lambda t, p: status.append(p))
    _subscribed(broker, "watcher", "status")
    doomed = clients(client_pkg, broker, "doomed")
    doomed.will_set("status", b"doomed-OFFLINE")
    doomed.connect()
    _wait(lambda: broker.session_count() == 2, msg="doomed connected")
    doomed._stopping = True  # no reconnect after the kick
    broker.kick("doomed")
    _wait(lambda: b"doomed-OFFLINE" in status, msg="will delivery")
    polite = clients(client_pkg, broker, "polite")
    polite.will_set("status", b"polite-OFFLINE")
    polite.connect()
    _wait(lambda: broker.session_count() == 2, msg="polite connected")
    polite.disconnect()
    time.sleep(0.3)
    assert status == [b"doomed-OFFLINE"]


@pytest.mark.parametrize("client_pkg,broker_pkg", PAIRS)
def test_reconnect_resubscribes_and_traffic_resumes(brokers, clients, client_pkg, broker_pkg):
    broker = brokers(broker_pkg)
    got = []
    sub = clients(client_pkg, broker, "sub", reconnect_delay=0.05)
    pub = clients(client_pkg, broker, "pub")
    sub.connect()
    pub.connect()
    sub.subscribe("fl/round", lambda t, p: got.append(p))
    _subscribed(broker, "sub", "fl/round")
    pub.publish("fl/round", b"before")
    _wait(lambda: b"before" in got, msg="delivery before the kick")
    broker.kick("sub")
    _wait(lambda: sub.reconnects >= 1, msg="reconnect")
    _subscribed(broker, "sub", "fl/round")  # the re-SUBSCRIBE landed
    pub.publish("fl/round", b"after")
    _wait(lambda: b"after" in got, msg="delivery after the reconnect")
    assert got == [b"before", b"after"]


@pytest.mark.parametrize("client_pkg,broker_pkg", PAIRS)
def test_qos2_exactly_once_roundtrip(brokers, clients, client_pkg, broker_pkg):
    broker = brokers(broker_pkg)
    got = []
    sub, pub = clients(client_pkg, broker, "q2sub"), clients(client_pkg, broker, "q2pub")
    sub.connect()
    pub.connect()
    sub.subscribe("fl/q2", lambda t, p: got.append(p))
    _subscribed(broker, "q2sub", "fl/q2")
    for i in range(5):
        pub.publish("fl/q2", f"m{i}".encode(), qos=2)
    _wait(lambda: len(got) >= 5, msg="qos2 deliveries")
    time.sleep(0.2)
    assert got == [f"m{i}".encode() for i in range(5)]
    assert not pub._qos2_recs and not pub._qos2_comps and not sub._qos2_in


@pytest.mark.parametrize("client_pkg,broker_pkg", PAIRS)
def test_qos2_duplicate_publish_delivered_once(brokers, clients, client_pkg, broker_pkg):
    """A redelivered QoS 2 PUBLISH (same packet id, DUP) before PUBREL, and
    a second PUBREL after it, reach the subscriber once (the raw frames of
    the client's package)."""
    broker = brokers(broker_pkg)
    w = _wire(client_pkg)
    got = []
    sub = clients(client_pkg, broker, "dupsub")
    sub.connect()
    sub.subscribe("fl/dup", lambda t, p: got.append(p))
    _subscribed(broker, "dupsub", "fl/dup")
    raw = socket.create_connection(("127.0.0.1", broker.port), timeout=5)
    try:
        body = w._enc_str("MQTT") + bytes([4, 0x02]) + struct.pack(">H", 30) + \
            w._enc_str("rawdup")
        raw.sendall(w._packet(w.CONNECT, 0, body))
        assert w._read_packet(raw)[0] == w.CONNACK
        pub_body = w._enc_str("fl/dup") + struct.pack(">H", 7) + b"once"
        raw.sendall(w._packet(w.PUBLISH, 0x04, pub_body))
        assert w._read_packet(raw) == (w.PUBREC, 0, struct.pack(">H", 7))
        raw.sendall(w._packet(w.PUBLISH, 0x0C, pub_body))
        assert w._read_packet(raw)[0] == w.PUBREC
        time.sleep(0.3)
        assert got == []
        raw.sendall(w._packet(w.PUBREL, 0x02, struct.pack(">H", 7)))
        assert w._read_packet(raw) == (w.PUBCOMP, 0, struct.pack(">H", 7))
        _wait(lambda: got == [b"once"], msg="exactly-once delivery")
        raw.sendall(w._packet(w.PUBREL, 0x02, struct.pack(">H", 7)))
        assert w._read_packet(raw)[0] == w.PUBCOMP
        time.sleep(0.3)
        assert got == [b"once"]
    finally:
        raw.close()


@pytest.mark.parametrize("client_pkg,broker_pkg", PAIRS)
def test_session_takeover_closes_old_connection(brokers, clients, client_pkg, broker_pkg):
    broker = brokers(broker_pkg)
    first = clients(client_pkg, broker, "same-id")
    first.connect()
    first._stopping = True
    second = clients(client_pkg, broker, "same-id")
    second.connect()
    _wait(lambda: broker.session_count() == 1, msg="takeover")


# -- the HTTP store -------------------------------------------------------------------

def _store_mods(pkg):
    if pkg == "ref":
        from fedml_tpu.comm import object_store_http
    else:
        from fedml_tpu_torch.comm import object_store_http
    return object_store_http


@pytest.mark.parametrize("client_pkg,server_pkg", PAIRS)
def test_http_object_store_roundtrip(client_pkg, server_pkg):
    """PUT / GET through each package's client against each package's
    server: the blob back bitwise, a missing key a ``KeyError``, a dead
    server an ``OSError`` (the loop's transient failure)."""
    srv = _store_mods(server_pkg).MiniObjectStoreServer()
    srv.start()
    try:
        store = _store_mods(client_pkg).HttpObjectStore(srv.url)
        blob = bytes(range(256)) * 200
        assert store.put("run/abc", blob) == "run/abc"
        assert store.get("run/abc") == blob and srv._blobs["run/abc"] == blob
        with pytest.raises(KeyError):
            store.get("run/missing")
    finally:
        srv.stop()
    with pytest.raises(OSError):
        _store_mods(client_pkg).HttpObjectStore(srv.url, timeout=2.0).get("run/abc")


# -- the manager: payloads, the store, the decode hook ----------------------------------

class _RecordingBroker:
    """The broker interface, keeping every publish."""

    def __init__(self):
        self.published, self.subs, self.wills = [], {}, {}

    def publish(self, topic, payload):
        self.published.append((topic, payload))
        for cb in self.subs.get(topic, []):
            cb(topic, payload)

    def subscribe(self, topic, cb):
        self.subs.setdefault(topic, []).append(cb)

    def set_will(self, client_id, topic, payload):
        self.wills[client_id] = (topic, payload)


class _DictStore:
    def __init__(self):
        self.blobs = {}

    def put(self, key, data):
        self.blobs[key] = data
        return key

    def get(self, key):
        return self.blobs[key]


def _mqtt_mods(pkg):
    if pkg == "ref":
        from fedml_tpu.comm import mqtt_s3
        from fedml_tpu.comm.message import Message
    else:
        from fedml_tpu_torch.comm import mqtt_s3
        from fedml_tpu_torch.comm.message import Message
    return mqtt_s3, Message


def _big_message(Message, n, receiver=0):
    m = Message(3, 2, receiver)
    m.add_params("round_idx", 1)
    m.add_params("model_params", {"w": np.arange(n, dtype=np.float32), "b": np.ones(3, np.int32)})
    return m


def test_topic_payloads_and_store_blobs_bitwise():
    """The same messages through each package's manager: the status topic's
    will and ONLINE, the direct payloads and the store blobs bitwise; a
    store reference ``R{"store_key": "<run>/<32 hex>"}`` in both."""
    out = {}
    for pkg in ("port", "ref"):
        mqtt_s3, Message = _mqtt_mods(pkg)
        broker, store = _RecordingBroker(), _DictStore()
        mgr = mqtt_s3.MqttS3CommManager("payrun", 2, broker=broker, store=store)
        for n in (16, 4000):  # 64 B inline; 16 KB to the store
            mgr.send_message(_big_message(Message, n))
        out[pkg] = (broker, store)
    (pb, ps), (rb, rs) = out["port"], out["ref"]
    assert pb.wills == rb.wills and list(pb.subs) == list(rb.subs) == ["fedml_payrun_to_2"]
    assert pb.published[0] == rb.published[0] == (
        "fedml_payrun_status", b'{"ID": 2, "status": "ONLINE"}')
    assert pb.published[1] == rb.published[1] and pb.published[1][1][:1] == b"D"
    refs = []
    for broker, store in out.values():
        topic, payload = broker.published[2]
        assert topic == "fedml_payrun_to_0" and payload[:1] == b"R"
        key = json.loads(payload[1:].decode())["store_key"]
        assert payload == b"R" + json.dumps({"store_key": key}).encode()
        run, hexkey = key.split("/")
        assert run == "payrun" and len(hexkey) == 32 and int(hexkey, 16) >= 0
        refs.append(store.blobs[key])
    assert refs[0] == refs[1] and len(refs[0]) > 8 * 1024


def _loop(mgr):
    got = []

    class Obs:
        def receive_message(self, t, m):
            got.append(m)

    mgr.add_observer(Obs())
    t = threading.Thread(target=mgr.handle_receive_message, daemon=True)
    t.start()
    return got, t


def test_store_reference_resolved_by_the_decode_hook():
    """A message over the inline limit crosses the in-memory broker as a
    store reference; the receive loop resolves it through the manager's
    ``_decode_bytes`` and delivers the message (without the hook the loop
    would drop it as undecodable); INPROC and TCP decode through the base
    hook, ``Message.decode``."""
    from fedml_tpu_torch.comm.base import ObserverLoopMixin
    from fedml_tpu_torch.comm.message import Message
    from fedml_tpu_torch.comm.mqtt_s3 import InMemoryObjectStore, MqttS3CommManager
    from fedml_tpu_torch.comm.tcp_backend import TCPCommManager

    a, b = MqttS3CommManager("hookrun", 0), MqttS3CommManager("hookrun", 1)
    got, t = _loop(b)
    try:
        a.send_message(_big_message(Message, 4000, receiver=1))
        _wait(lambda: got, msg="the offloaded message")
    finally:
        b.stop_receive_message()
        t.join(timeout=5.0)
    assert b.dropped == {} and b.received == 1 and a.store_bytes > 8 * 1024
    assert len(InMemoryObjectStore.get_store("hookrun").blobs) == 1
    np.testing.assert_array_equal(got[0].get("model_params")["w"], np.arange(4000, dtype=np.float32))
    assert TCPCommManager._decode_bytes is ObserverLoopMixin._decode_bytes
    back = ObserverLoopMixin._decode_bytes(None, _big_message(Message, 8).encode())
    np.testing.assert_array_equal(back.get("model_params")["w"], np.arange(8, dtype=np.float32))


def test_poisoned_and_transient_payloads_through_the_hook():
    """Over a real MQTT session and the HTTP store: a reference to a blob
    never put (``KeyError``) and a bad marker (``ValueError``) are dropped
    as undecodable and the loop lives on; a store that fails once (a
    refused connection) is retried and the message delivered."""
    from fedml_tpu_torch.comm.message import Message
    from fedml_tpu_torch.comm.mqtt_real import TcpMqttBroker
    from fedml_tpu_torch.comm.mqtt_s3 import MqttS3CommManager
    from fedml_tpu_torch.comm.mqtt_wire import MiniMqttBroker, SocketMqttClient
    from fedml_tpu_torch.comm.object_store_http import HttpObjectStore, MiniObjectStoreServer

    broker = MiniMqttBroker()
    broker.start()
    srv = MiniObjectStoreServer()
    srv.start()

    class FlakyStore(HttpObjectStore):
        """Refuses the first GET of a blob that exists."""
        fails = 1

        def get(self, key):
            if self.fails and not key.startswith("poison/never"):
                self.fails -= 1
                raise ConnectionRefusedError("store briefly unreachable")
            return super().get(key)

    mgr = peer = evil = None
    try:
        mgr = MqttS3CommManager("poison", 0, store=FlakyStore(srv.url),
                                broker=TcpMqttBroker("127.0.0.1", broker.port, "poison_0"))
        got, t = _loop(mgr)
        _subscribed(broker, "poison_0", "fedml_poison_to_0")
        evil = SocketMqttClient("127.0.0.1", broker.port, "evil")
        evil.connect()
        evil.publish("fedml_poison_to_0", b"R" + json.dumps({"store_key": "poison/never"}).encode())
        evil.publish("fedml_poison_to_0", b"X\xde\xad\xbe\xef")
        peer = MqttS3CommManager("poison", 1, store=HttpObjectStore(srv.url),
                                 broker=TcpMqttBroker("127.0.0.1", broker.port, "poison_1"))
        peer.send_message(_big_message(Message, 4000))
        _wait(lambda: got, msg="the message after the poison")
        assert mgr.dropped == {"undecodable": 2} and mgr.decode_retries == 1
        assert mgr.received == 1
        np.testing.assert_array_equal(got[0].get("model_params")["w"],
                                      np.arange(4000, dtype=np.float32))
    finally:
        for m_ in (mgr, peer):
            if m_ is not None:
                m_.stop_receive_message()
        if evil is not None:
            evil.disconnect()
        broker.stop()
        srv.stop()


def test_in_memory_last_will_and_status():
    from fedml_tpu_torch.comm.mqtt_s3 import InMemoryBroker, MqttS3CommManager

    InMemoryBroker.reset("willrun")
    statuses = []
    a = MqttS3CommManager("willrun", 0)
    a.subscribe_status(statuses.append)
    b = MqttS3CommManager("willrun", 1)
    InMemoryBroker.get("willrun").disconnect_ungraceful(b.client_id)
    assert statuses == [{"ID": 1, "status": "ONLINE"}, {"ID": 1, "status": "OFFLINE"}]


# -- the adapters ------------------------------------------------------------------------

def _real(pkg):
    if pkg == "ref":
        from fedml_tpu.comm import mqtt_real
    else:
        from fedml_tpu_torch.comm import mqtt_real
    return mqtt_real


@pytest.mark.parametrize("paho", [FakePaho1, FakePaho2], ids=["paho1", "paho2"])
def test_paho_adapter_like_the_reference(paho):
    """Constructor shape of paho 1.x / 2.x, credentials, the will before a
    single lazy connect, QoS 2 everywhere, re-subscription on a reconnect,
    dispatch by topic and an idempotent disconnect: the same calls on the
    reference's fake client from both packages."""
    calls = {}
    for pkg in ("port", "ref"):
        b = _real(pkg).PahoMqttBroker("broker.test", 1883, client_id="c0", username="u",
                                      password="pw", paho_module=paho)
        got = []
        b.set_will("c0", "t/status", b"bye")
        assert b._client.connect_calls == []
        b.subscribe("t/x", lambda t, p: got.append(p))
        b.publish("t/a", b"one")
        b.publish("t/a", b"two")
        b._client.on_connect(b._client, None, None, 0)  # a broker restart
        b._client.deliver("t/x", b"in")
        b.disconnect()
        b.disconnect()
        c = b._client
        calls[pkg] = (c.ctor_args, c.ctor_kwargs, c.userpass, c.will, c.connect_calls,
                      c.loop_started, c.loop_stopped, c.disconnected, c.subscriptions,
                      c.published, got)
    assert calls["port"] == calls["ref"]
    assert calls["port"][9] == [("t/a", b"one", 2), ("t/a", b"two", 2)]
    assert calls["port"][8] == [("t/x", 2)] * 3  # connect, subscribe, the restart


def test_s3_store_and_missing_packages(monkeypatch):
    """The S3 store on an injected client (the prefix applied, as the
    reference's), and the ``ImportError`` of each adapter without its
    package."""
    from fedml_tpu_torch.comm import mqtt_real

    blobs = {}

    class FakeS3:
        def put_object(self, Bucket, Key, Body):
            blobs[(Bucket, Key)] = Body

        def get_object(self, Bucket, Key):
            import io

            return {"Body": io.BytesIO(blobs[(Bucket, Key)])}

    for pkg in ("port", "ref"):
        store = _real(pkg).S3ObjectStore(bucket="bkt", client=FakeS3())
        assert store.put(f"{pkg}-r1", b"\x01\x02") == f"{pkg}-r1"
        assert store.get(f"{pkg}-r1") == b"\x01\x02"
    assert sorted(blobs) == [("bkt", "fedml_tpu/port-r1"), ("bkt", "fedml_tpu/ref-r1")]
    monkeypatch.setattr(mqtt_real, "_paho_module", lambda: None)
    monkeypatch.setattr(mqtt_real, "_boto3_module", lambda: None)
    with pytest.raises(ImportError, match="paho-mqtt"):
        mqtt_real.PahoMqttBroker("h")
    with pytest.raises(ImportError, match="boto3"):
        mqtt_real.S3ObjectStore(bucket="b")


def test_manager_rides_the_paho_adapter():
    """The manager over the paho adapter (the reference's fake): the will
    before the first connect, ONLINE announced, its topic subscribed at
    QoS 2, a direct payload out, and the frame back through the hook."""
    from fedml_tpu_torch.comm.message import Message
    from fedml_tpu_torch.comm.mqtt_real import PahoMqttBroker
    from fedml_tpu_torch.comm.mqtt_s3 import MqttS3CommManager

    b = PahoMqttBroker("broker.test", 1883, client_id="c1", paho_module=FakePaho2)
    mgr = MqttS3CommManager("run9", 1, broker=b, store=_DictStore())
    assert b._client.will[0] == "fedml_run9_status"
    assert json.loads(b._client.will[1].decode())["status"] == "OFFLINE"
    assert ("fedml_run9_to_1", 2) in b._client.subscriptions
    out = Message(3, sender_id=1, receiver_id=2)
    out.add_params("k", 1.5)
    mgr.send_message(out)
    sent = [p for t, p, _q in b._client.published if t == "fedml_run9_to_2"]
    assert len(sent) == 1 and sent[0][:1] == b"D"
    b._client.deliver("fedml_run9_to_1", sent[0])
    m = mgr._decode_bytes(mgr._inbox.get(timeout=2))
    assert m.get_type() == 3 and float(m.get("k")) == 1.5


def test_mqtt_host_needs_a_store_in_both_factories():
    from fedml_tpu.comm.comm_manager import FedMLCommManager as RefManager
    from fedml_tpu_torch.comm.comm_manager import FedMLCommManager

    extra = {"mqtt_host": "127.0.0.1", "mqtt_port": 1}
    for cls, cfg in ((RefManager, tiny_config(backend="MQTT_S3", extra=dict(extra))),
                     (FedMLCommManager, _port_cfg("nostore", backend="MQTT_S3",
                                                  extra=dict(extra)))):
        with pytest.raises(ValueError, match="object_store_url"):
            cls(cfg, rank=0)


# -- cross-silo over real MQTT framing and the HTTP store ----------------------------------

def _port_cfg(run_id, **kw):
    import fedml_tpu_torch.arguments as args

    ref = tiny_config(training_type="cross_silo", client_num_in_total=2, client_num_per_round=2,
                      comm_round=4, learning_rate=0.3, frequency_of_the_test=2, run_id=run_id,
                      role="server", **kw)
    fields = {k: v for k, v in vars(ref).items() if k in args.Config.__dataclass_fields__}
    return args.Config(**fields)


def _kick_at_round_close(server, broker, client_id, rnd, kicked, reconnected, wait_reconnect):
    """Kick ``client_id``'s session when ``server`` closes round ``rnd``
    (every upload in, no dispatch in flight), and hold the round's close
    until the session is back and subscribed, so the next dispatch finds
    it."""
    agg = server.aggregator
    aggregate = agg.aggregate

    def tapped(round_idx, *a, **k):
        if round_idx == rnd and not kicked.is_set():
            broker.kick(client_id)
            kicked.set()
            _wait(wait_reconnect, timeout=20.0, msg="the kicked silo's reconnect")
            run_id, rank = client_id.rsplit("_", 1)
            _subscribed(broker, client_id, f"fedml_{run_id}_to_{rank}")
            reconnected.set()
        return aggregate(round_idx, *a, **k)

    agg.aggregate = tapped


def _mqtt_run(pkg, monkeypatch, run_id, init=None):
    """``pkg``'s cross-silo LR run over its MiniMqttBroker and HTTP store,
    payloads over 512 bytes through the store, silo 2 kicked at round 1's
    close: ``(history, final global leaves, initial global, store blobs,
    reconnects)``."""
    if pkg == "ref":
        import fedml_tpu as top
        from fedml_tpu.comm import mqtt_s3 as mqtt_mod
        from fedml_tpu.comm.mqtt_wire import MiniMqttBroker
        from fedml_tpu.comm.object_store_http import MiniObjectStoreServer
        from fedml_tpu.cross_silo import build_client, build_server
        from fedml_tpu.data import loader
        from fedml_tpu.models import model_hub
    else:
        import fedml_tpu_torch as top
        from fedml_tpu_torch.comm import mqtt_s3 as mqtt_mod
        from fedml_tpu_torch.comm.mqtt_wire import MiniMqttBroker
        from fedml_tpu_torch.comm.object_store_http import MiniObjectStoreServer
        from fedml_tpu_torch.cross_silo import build_client, build_server
        from fedml_tpu_torch.data import loader
        from fedml_tpu_torch.models import model_hub
    monkeypatch.setattr(mqtt_mod, "PAYLOAD_INLINE_LIMIT", 512)
    broker = MiniMqttBroker()
    broker.start()
    store = MiniObjectStoreServer()
    store.start()
    extra = {"mqtt_host": "127.0.0.1", "mqtt_port": broker.port, "object_store_url": store.url,
             "straggler_timeout_s": 20.0, "straggler_quorum_frac": 0.5}
    if pkg == "ref":
        cfg = tiny_config(training_type="cross_silo", client_num_in_total=2,
                          client_num_per_round=2, comm_round=4, learning_rate=0.3,
                          frequency_of_the_test=2, run_id=run_id, extra=extra)
        top.init(cfg)
        ds = loader.load(cfg)
        model = model_hub.create(cfg, ds.class_num)
        clients = [build_client(cfg, ds, model, rank=r, backend="MQTT_S3") for r in (1, 2)]
        server = build_server(cfg, ds, model, backend="MQTT_S3")
    else:
        from fedml_tpu_torch import weights

        from .test_torch_secagg import JaxPerms

        cfg = top.init(_port_cfg(run_id, extra=extra))
        ds = loader.load(cfg)
        model = model_hub.create(cfg, ds.class_num, input_shape=ds.train_x.shape[1:])
        perms = JaxPerms(cfg.random_seed)
        clients = [build_client(cfg, ds, model, r, "cpu", backend="MQTT_S3", perms=perms)
                   for r in (1, 2)]
        server = build_server(cfg, ds, model, "cpu", backend="MQTT_S3",
                              global_vars=weights.to_torch(weights.flax_to_torch(init)))
    start = jax.tree_util.tree_map(np.asarray, jax.device_get(server.aggregator.global_vars)) \
        if pkg == "ref" else None
    wire_client = clients[1].com_manager.broker._client
    kicked, reconnected = threading.Event(), threading.Event()
    _kick_at_round_close(server, broker, f"{run_id}_2", 1, kicked, reconnected,
                         lambda: wire_client.reconnects >= 1)
    for c in clients:
        c.run_in_thread()
    try:
        history = server.run_until_done(timeout=120.0)
    finally:
        for c in clients:
            c.finish()
        server.finish()
        for c in (*clients, server):
            c.com_manager.broker.disconnect()
        broker.stop()
        store.stop()
    assert kicked.is_set() and reconnected.is_set()
    return history, _flat_global(pkg, server), start, dict(store._blobs), wire_client.reconnects


def _flat_global(pkg, server):
    if pkg == "ref":
        tree = jax.device_get(server.aggregator.global_vars)
    else:
        from fedml_tpu_torch import weights

        tree = weights.torch_to_flax(weights.to_numpy(server.aggregator.global_vars))
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def test_cross_silo_fedavg_over_real_mqtt_matches_the_reference(monkeypatch):
    """The reference's ``test_cross_silo_fedavg_over_real_mqtt`` on both
    packages, each over its own broker and store: silo 2's session is
    kicked (no DISCONNECT) as round 1 closes, reconnects and re-subscribes,
    and every round takes both silos; the payloads over 512 bytes rode the
    store; the port's history and global are the reference's (module
    docstring's tolerance)."""
    ref_hist, ref_global, init_tree, ref_blobs, ref_rc = _mqtt_run("ref", monkeypatch,
                                                                   "mqtt_e2e_ref")
    hist, got, _, blobs, rc = _mqtt_run("port", monkeypatch, "mqtt_e2e_port", init=init_tree)
    init = jax.tree_util.tree_leaves(init_tree)
    assert ref_rc >= 1 and rc >= 1 and ref_blobs and blobs
    from fedml_tpu_torch.comm.message import Message

    assert all(Message.decode(b).get_type() in (1, 2, 3) for b in blobs.values())
    assert [h["round"] for h in hist] == [h["round"] for h in ref_hist] == [0, 1, 2, 3]
    accs = [h["test_acc"] for h in hist if "test_acc" in h]
    ref_accs = [h["test_acc"] for h in ref_hist if "test_acc" in h]
    np.testing.assert_allclose(accs, ref_accs, atol=1e-6)
    assert accs[-1] > 0.3
    for a, b in zip(got, ref_global):
        np.testing.assert_allclose(a, b, rtol=0, atol=RUN_TOL)
    assert max(float(np.abs(b - s).max()) for b, s in zip(ref_global, init)) > 1e-2


# -- the optional packages ------------------------------------------------------------------

HIDDEN_PACKAGES_CHILD = r'''
import importlib.abc, sys
HIDDEN = ("grpc", "paho", "boto3", "web3", "jax", "fedml_tpu")

class Hide(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in HIDDEN:
            raise ImportError(f"{name} is hidden")
        return None

sys.meta_path.insert(0, Hide())
import torch
torch.set_num_threads(1)
import fedml_tpu_torch
from fedml_tpu_torch.arguments import Config
from fedml_tpu_torch.comm.mqtt_wire import MiniMqttBroker
from fedml_tpu_torch.comm.object_store_http import MiniObjectStoreServer
from fedml_tpu_torch.cross_silo import run_in_process_group
from fedml_tpu_torch.data import loader
from fedml_tpu_torch.models import model_hub

broker, store = MiniMqttBroker(), MiniObjectStoreServer()
broker.start(); store.start()
accs = {}
for name, backend, extra in (("inproc", "INPROC", {}), ("tcp", "TCP", {"tcp_base_port": 0}),
                             ("mqtt_memory", "MQTT_S3", {}),
                             ("mqtt_wire", "MQTT_S3", {"mqtt_host": "127.0.0.1",
                                                       "mqtt_port": broker.port,
                                                       "object_store_url": store.url}),
                             ("web3", "WEB3", {}), ("theta", "THETASTORE", {})):
    cfg = fedml_tpu_torch.init(Config(
        training_type="cross_silo", role="server", dataset="synthetic", model="lr",
        client_num_in_total=2, client_num_per_round=2, comm_round=1, batch_size=16,
        synthetic_train_size=128, synthetic_test_size=32, compute_dtype="float32",
        run_id="hidden_" + name, extra=extra))
    ds = loader.load(cfg)
    model = model_hub.create(cfg, ds.class_num, input_shape=ds.train_x.shape[1:])
    accs[name] = run_in_process_group(cfg, ds, model, "cpu", backend=backend,
                                      timeout=60.0)[-1]["test_acc"]
broker.stop(); store.stop()
loaded = sorted(m for m in sys.modules if m.split(".")[0] in HIDDEN)
print("RESULT", accs, loaded)
assert len(set(accs.values())) == 1 and not loaded
'''


def test_paths_run_without_the_optional_packages():
    """``import fedml_tpu_torch`` and the INPROC, TCP, MQTT_S3 (in memory and
    over the wire) and WEB3 / THETASTORE groups run in a process where
    ``grpc``, ``paho``, ``boto3``, ``web3`` (and ``jax``, ``fedml_tpu``)
    cannot be imported, and none of them is loaded; every backend ends at
    the same accuracy."""
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", HIDDEN_PACKAGES_CHILD], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    assert "RESULT" in out.stdout
