"""MQTT + object-store backend, the control / payload split (the port of
``fedml_tpu/comm/mqtt_s3.py``).

A message rides the broker topic ``fedml_{run_id}_to_{receiver}``; one whose
``Message.encode`` bytes pass ``PAYLOAD_INLINE_LIMIT`` goes to the object
store under ``{run_id}/{uuid4 hex}`` and the topic carries only the key.
The topic payload is a marker byte and a body::

    b"D" + Message bytes                        (direct)
    b"R" + {"store_key": "<run_id>/<hex>"}      (store reference, JSON)

the reference's bytes.  Each endpoint sets an OFFLINE last will on
``fedml_{run_id}_status`` and announces ONLINE there when it is built;
:meth:`MqttS3CommManager.subscribe_status` hears both.

The broker and the store are two small interfaces: ``publish`` /
``subscribe`` / ``set_will`` and ``put`` / ``get``.
:class:`InMemoryBroker` and :class:`InMemoryObjectStore` serve endpoints of
one process (keyed by run); ``comm/mqtt_real.py``'s ``TcpMqttBroker`` (a
real MQTT 3.1.1 session, ``comm/mqtt_wire.py``) and
``comm/object_store_http.py``'s ``HttpObjectStore`` serve endpoints in
different processes or hosts, and the paho / boto3 adapters a deployment's
own broker and S3.
"""

from __future__ import annotations

import json
import threading
import uuid
from collections import defaultdict
from typing import Callable

from .base import BaseCommunicationManager, ObserverLoopMixin
from .message import Message

#: a message longer than this rides the object store (module attribute:
#: tests lower it, as the reference's do)
PAYLOAD_INLINE_LIMIT = 8 * 1024


class InMemoryBroker:
    """Topic pub/sub with last wills, one broker per run namespace."""

    _brokers: dict[str, "InMemoryBroker"] = {}
    _lock = threading.Lock()

    def __init__(self):
        self.subs: dict[str, list[Callable[[str, bytes], None]]] = defaultdict(list)
        self.wills: dict[str, tuple[str, bytes]] = {}

    @classmethod
    def get(cls, namespace: str) -> "InMemoryBroker":
        with cls._lock:
            if namespace not in cls._brokers:
                cls._brokers[namespace] = cls()
            return cls._brokers[namespace]

    @classmethod
    def reset(cls, namespace: str) -> None:
        """Forget a run's broker (its subscribers and wills); the in-process
        group calls it, as it resets the in-process router."""
        with cls._lock:
            cls._brokers.pop(namespace, None)

    def publish(self, topic: str, payload: bytes) -> None:
        for cb in list(self.subs.get(topic, [])):
            cb(topic, payload)

    def subscribe(self, topic: str, cb: Callable[[str, bytes], None]) -> None:
        self.subs[topic].append(cb)

    def set_will(self, client_id: str, topic: str, payload: bytes) -> None:
        self.wills[client_id] = (topic, payload)

    def disconnect_ungraceful(self, client_id: str) -> None:
        """A dropped connection: the client's will fires."""
        will = self.wills.pop(client_id, None)
        if will:
            self.publish(*will)


class InMemoryObjectStore:
    """Blobs by key (the S3 role), one store per run namespace."""

    _stores: dict[str, "InMemoryObjectStore"] = {}
    _lock = threading.Lock()

    def __init__(self):
        self.blobs: dict[str, bytes] = {}

    @classmethod
    def get_store(cls, namespace: str) -> "InMemoryObjectStore":
        with cls._lock:
            if namespace not in cls._stores:
                cls._stores[namespace] = cls()
            return cls._stores[namespace]

    @classmethod
    def reset(cls, namespace: str) -> None:
        with cls._lock:
            cls._stores.pop(namespace, None)

    def put(self, key: str, data: bytes) -> str:
        self.blobs[key] = data
        return key

    def get(self, key: str) -> bytes:
        return self.blobs[key]


class MqttS3CommManager(ObserverLoopMixin, BaseCommunicationManager):
    """Endpoint ``rank`` of run ``run_id`` over ``broker`` and ``store``
    (default: the run's in-memory pair).  ``payload_bytes`` counts the
    bytes published on topics, ``store_bytes`` those put in the store."""

    def __init__(self, run_id: str, rank: int, broker=None, store=None):
        self.run_id = str(run_id)
        self.rank = rank
        self.broker = broker or InMemoryBroker.get(self.run_id)
        self.store = store or InMemoryObjectStore.get_store(self.run_id)
        self._init_observer_loop()
        self.payload_bytes = 0
        self.store_bytes = 0
        self.client_id = f"{self.run_id}_{rank}"
        self.broker.set_will(self.client_id, self._status_topic(),
                             json.dumps({"ID": rank, "status": "OFFLINE"}).encode())
        self.broker.subscribe(self._my_topic(), self._on_message)
        self.broker.publish(self._status_topic(),
                            json.dumps({"ID": rank, "status": "ONLINE"}).encode())

    def _my_topic(self) -> str:
        return f"fedml_{self.run_id}_to_{self.rank}"

    def _status_topic(self) -> str:
        return f"fedml_{self.run_id}_status"

    def subscribe_status(self, cb: Callable[[dict], None]) -> None:
        self.broker.subscribe(self._status_topic(), lambda _t, p: cb(json.loads(p.decode())))

    def _on_message(self, topic: str, payload: bytes) -> None:
        self._inbox.put(payload)

    def send_message(self, msg: Message) -> None:
        body = msg.encode()
        if len(body) > PAYLOAD_INLINE_LIMIT:
            key = f"{self.run_id}/{uuid.uuid4().hex}"
            self.store.put(key, body)
            self.store_bytes += len(body)
            payload = b"R" + json.dumps({"store_key": key}).encode()
        else:
            payload = b"D" + body
        self.payload_bytes += len(payload)
        self.broker.publish(f"fedml_{self.run_id}_to_{msg.get_receiver_id()}", payload)

    def _decode_bytes(self, payload: bytes) -> Message:
        marker, rest = payload[:1], payload[1:]
        if marker == b"R":
            rest = self.store.get(json.loads(rest.decode())["store_key"])
        elif marker != b"D":
            raise ValueError(f"unknown payload marker {marker!r}")
        return Message.decode(rest)

    def stop_receive_message(self) -> None:
        """Stop the loop and close a real broker session gracefully (its
        will is discarded; the reference leaves the session to the process's
        end)."""
        super().stop_receive_message()
        disconnect = getattr(self.broker, "disconnect", None)
        if disconnect is not None:
            disconnect()
