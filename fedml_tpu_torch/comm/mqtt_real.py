"""Brokers and stores between processes for the MQTT + object-store backend
(the port of ``fedml_tpu/comm/mqtt_real.py``).

Each implements the interface ``comm/mqtt_s3.py``'s manager takes
(``publish`` / ``subscribe`` / ``set_will``, ``put`` / ``get``):

- :class:`TcpMqttBroker`: a real MQTT 3.1.1 session
  (``comm/mqtt_wire.SocketMqttClient``, stdlib sockets) to any 3.1.1
  broker, ``MiniMqttBroker`` among them; what ``extra.mqtt_host`` selects;
- :class:`PahoMqttBroker`: paho-mqtt (1.x or 2.x), everything at QoS 2;
- :class:`S3ObjectStore`: boto3's S3 client.

paho-mqtt and boto3 are imported when their adapter is built, and only
then; without them the adapter raises ``ImportError`` naming the package.
Both take the module or client as an argument, so they run against fakes.
"""

from __future__ import annotations

import importlib
import threading
from typing import Callable, Optional


def _optional_module(name: str):
    """The module ``name``, or None when it is not installed."""
    try:
        return importlib.import_module(name)
    except ImportError:
        return None


def _paho_module():
    return _optional_module("paho.mqtt.client")


def _boto3_module():
    return _optional_module("boto3")


class PahoMqttBroker:
    """The broker interface over paho-mqtt: QoS 2, the will set before the
    first connect, one lazy connect with paho's loop thread, every
    subscription re-issued on a (re)connect.  ``paho_module`` stands in for
    ``paho.mqtt.client``."""

    def __init__(self, host: str, port: int = 1883, client_id: str = "",
                 username: Optional[str] = None, password: Optional[str] = None,
                 keepalive: int = 180, paho_module=None):
        paho = paho_module if paho_module is not None else _paho_module()
        if paho is None:
            raise ImportError("paho-mqtt is not installed; install it for a real broker or "
                              "use comm.mqtt_s3.InMemoryBroker for hermetic runs")
        if hasattr(paho, "CallbackAPIVersion"):
            # paho-mqtt >= 2.0 takes the callback API version and no
            # clean_session argument
            self._client = paho.Client(paho.CallbackAPIVersion.VERSION1, client_id=client_id)
        else:  # paho-mqtt 1.x
            self._client = paho.Client(client_id=client_id, clean_session=True)
        if username:
            self._client.username_pw_set(username, password or "")
        self._subs: dict[str, list[Callable[[str, bytes], None]]] = {}
        self._lock = threading.Lock()
        self._client.on_message = self._dispatch
        # a clean-session reconnect starts with no subscriptions
        self._client.on_connect = self._on_connect
        self._host, self._port, self._keepalive = host, port, keepalive
        self._connected = False

    def _on_connect(self, client, userdata, *args, **kwargs) -> None:
        with self._lock:
            topics = list(self._subs)
        for t in topics:
            client.subscribe(t, qos=2)

    def _ensure_connected(self) -> None:
        if not self._connected:
            self._client.connect(self._host, self._port, self._keepalive)
            self._client.loop_start()
            self._connected = True

    def _dispatch(self, client, userdata, m) -> None:
        with self._lock:
            cbs = list(self._subs.get(m.topic, []))
        for cb in cbs:
            cb(m.topic, m.payload)

    def publish(self, topic: str, payload: bytes) -> None:
        self._ensure_connected()
        self._client.publish(topic, payload, qos=2)

    def subscribe(self, topic: str, cb: Callable[[str, bytes], None]) -> None:
        with self._lock:
            self._subs.setdefault(topic, []).append(cb)
        self._ensure_connected()
        self._client.subscribe(topic, qos=2)

    def set_will(self, client_id: str, topic: str, payload: bytes) -> None:
        self._client.will_set(topic, payload, qos=2, retain=False)

    def disconnect(self) -> None:
        if self._connected:
            self._client.loop_stop()
            self._client.disconnect()
            self._connected = False


class TcpMqttBroker:
    """The broker interface over one MQTT 3.1.1 session
    (:class:`~fedml_tpu_torch.comm.mqtt_wire.SocketMqttClient`): the will set
    before the first connect, one lazy connect (a lock, so concurrent
    publishers never dial two sessions under one client id), reconnect and
    re-subscribe inside the wire client."""

    def __init__(self, host: str, port: int, client_id: str, keepalive: float = 30.0):
        from .mqtt_wire import SocketMqttClient

        self._client = SocketMqttClient(host, port, client_id, keepalive=keepalive)
        self._connected = False
        self._lock = threading.Lock()

    def _ensure_connected(self) -> None:
        with self._lock:
            if not self._connected:
                self._client.connect()
                self._connected = True

    def publish(self, topic: str, payload: bytes) -> None:
        self._ensure_connected()
        # QoS 1 on purpose, as the reference argues: under clean sessions a
        # loss between the subscriber's PUBREC and the broker's PUBREL
        # strands a QoS 2 message that QoS 1 would have delivered, and the
        # protocol's handlers tolerate a duplicate (round gates, dedup keys)
        self._client.publish(topic, payload, qos=1)

    def subscribe(self, topic: str, cb: Callable[[str, bytes], None]) -> None:
        self._client.subscribe(topic, cb)
        self._ensure_connected()

    def set_will(self, client_id: str, topic: str, payload: bytes) -> None:
        self._client.will_set(topic, payload, qos=1)

    def disconnect(self) -> None:
        with self._lock:
            if self._connected:
                self._client.disconnect()
                self._connected = False


class S3ObjectStore:
    """The store interface over S3: blob ``key`` at ``prefix + key`` in
    ``bucket``.  ``client`` stands in for ``boto3.client("s3")``."""

    def __init__(self, bucket: str, prefix: str = "fedml_tpu/", client=None):
        if client is None:
            boto3 = _boto3_module()
            if boto3 is None:
                raise ImportError("boto3 is not installed; install it for S3 payloads or use "
                                  "comm.mqtt_s3.InMemoryObjectStore for hermetic runs")
            client = boto3.client("s3")
        self._s3 = client
        self.bucket = bucket
        self.prefix = prefix

    def put(self, key: str, data: bytes) -> str:
        self._s3.put_object(Bucket=self.bucket, Key=self.prefix + key, Body=data)
        return key

    def get(self, key: str) -> bytes:
        return self._s3.get_object(Bucket=self.bucket, Key=self.prefix + key)["Body"].read()
