"""Message — the unit of cross-process FL communication (the port of
``fedml_tpu/comm/message.py``).

A typed dict with msg_type / sender / receiver plus params.  Encoding puts
the non-array params in a JSON control section and the array-valued ones
through the pytree wire (``comm.wire``); for the same params the bytes equal
the reference's.  Decoding parses the control section and validates the
tensor header at once, and restores the tensors at first access; until then
a streaming consumer reads the tensor section leaf by leaf
(:meth:`Message.tensor_frame`, decoded; :meth:`Message.tensor_segments`,
the raw segments) and control keys (:meth:`Message.get_control`) without
restoring it.

A message larger than ``extra.comm_chunk_bytes`` crosses as transport chunk
frames (``wire.encode_chunk_frames``); :class:`ChunkAssembler` reassembles
them per ``(sender, stream)``, with a reorder buffer for out-of-order frames
and an idle sweep; :class:`MessageStreamDecoder` joins a stream's payloads
and decodes them as one whole frame, so the server's device fold takes a
reassembled upload exactly as it takes a whole one.
"""

from __future__ import annotations

import json
import time
from typing import Any

import numpy as np

from . import wire

MSG_ARG_KEY_TYPE = "msg_type"
MSG_ARG_KEY_SENDER = "sender"
MSG_ARG_KEY_RECEIVER = "receiver"


class Message:
    def __init__(self, msg_type: int = 0, sender_id: int = 0, receiver_id: int = 0):
        self.msg_params: dict[str, Any] = {
            MSG_ARG_KEY_TYPE: msg_type,
            MSG_ARG_KEY_SENDER: sender_id,
            MSG_ARG_KEY_RECEIVER: receiver_id,
        }
        # undecoded tensor section of a received frame: (header, offset, blob)
        self._tensor_stream = None
        #: wire size of the frame this message was decoded from (0 if local)
        self.wire_nbytes: int = 0

    def add_params(self, key: str, value: Any) -> None:
        self.msg_params[key] = value

    def get(self, key: str, default=None) -> Any:
        if key not in self.msg_params and self._tensor_stream is not None:
            self._materialize_tensors()
        return self.msg_params.get(key, default)

    def get_control(self, key: str, default=None) -> Any:
        """``get`` restricted to the JSON control section: never restores
        the tensors, so an optional control key (the delta flag) can be read
        before the frame it describes is folded."""
        return self.msg_params.get(key, default)

    def get_type(self) -> int:
        return self.msg_params[MSG_ARG_KEY_TYPE]

    def get_sender_id(self) -> int:
        return self.msg_params[MSG_ARG_KEY_SENDER]

    def get_receiver_id(self) -> int:
        return self.msg_params[MSG_ARG_KEY_RECEIVER]

    def encode(self) -> bytes:
        """Control fields as JSON; array-valued params via the pytree wire."""
        control, tensors = {}, {}
        for k, v in self.msg_params.items():
            (tensors if _is_arraylike(v) else control)[k] = v
        cbytes = json.dumps(control, separators=(",", ":")).encode("utf-8")
        parts = [len(cbytes).to_bytes(4, "little"), cbytes]
        parts.extend(wire.encode_pytree_chunks(tensors))
        return b"".join(parts)

    @classmethod
    def decode(cls, data: bytes) -> "Message":
        clen = int.from_bytes(data[:4], "little")
        control = json.loads(bytes(data[4:4 + clen]).decode("utf-8"))
        msg = cls()
        msg.msg_params = dict(control)
        blob = memoryview(data)[4 + clen:]
        header, offset = wire.decode_header(blob)
        msg._tensor_stream = (header, offset, blob)
        msg.wire_nbytes = len(data)
        return msg

    def tensor_frame(self):
        """``(wire header, iterator of (index, spec, dense array))`` over the
        still-unrestored tensor section, else None."""
        if self._tensor_stream is None:
            return None
        header, offset, blob = self._tensor_stream
        return header, wire.iter_leaf_arrays(blob, header=header, offset=offset)

    def tensor_segments(self):
        """:meth:`tensor_frame` with each leaf's raw segments in place of its
        decode (``wire.iter_leaf_segments``), else None."""
        if self._tensor_stream is None:
            return None
        header, offset, blob = self._tensor_stream
        return header, wire.iter_leaf_segments(blob, header=header, offset=offset)

    def _materialize_tensors(self) -> None:
        header, offset, blob = self._tensor_stream
        self._tensor_stream = None
        tensors = wire.decode_pytree(blob, header=header, offset=offset)
        if isinstance(tensors, dict):
            self.msg_params.update(tensors)

    def __repr__(self) -> str:
        keys = [k for k in self.msg_params
                if k not in (MSG_ARG_KEY_TYPE, MSG_ARG_KEY_SENDER, MSG_ARG_KEY_RECEIVER)]
        return (f"Message(type={self.get_type()}, {self.get_sender_id()}->"
                f"{self.get_receiver_id()}, params={keys})")


class MessageStreamDecoder:
    """The payloads of one chunked message, in wire order.  Unlike the
    reference's, it decodes nothing while frames land: :meth:`message` joins
    them and decodes the whole frame (:meth:`Message.decode`, each leaf's
    segments walked once), so a reassembled upload is the same lazy message
    as one that crossed whole.  A corrupt control or tensor header is thus
    found at the stream's last frame, where the reference's incremental
    decoder finds it at the frame that completes that section; the drop
    reason is the reference's."""

    def __init__(self):
        self._parts: list = []

    def feed(self, chunk) -> None:
        self._parts.append(bytes(chunk))

    def message(self) -> tuple:
        """``(message, None)``, or ``(None, "chunk_incomplete")`` where a
        length field asks for bytes that never came, ``(None,
        "chunk_decode")`` where the bytes came and do not parse."""
        data = b"".join(self._parts)
        try:
            msg = Message.decode(data)
            for _ in msg.tensor_segments()[1]:
                pass
            return msg, None
        except (ValueError, KeyError):
            return None, "chunk_incomplete" if _cut_short(data) else "chunk_decode"


def _cut_short(data: bytes) -> bool:
    """Whether the reference's incremental decoder would still be waiting on
    ``data`` (a declared length runs past its end) rather than failing: each
    section is parsed in wire order, as that decoder parses it."""
    if len(data) < 4:
        return True
    clen = int.from_bytes(data[:4], "little")
    if len(data) < 4 + clen:
        return True
    try:
        json.loads(data[4:4 + clen].decode("utf-8"))
    except ValueError:
        return False
    blob = data[4 + clen:]
    hlen = int.from_bytes(blob[:4], "little")
    if len(blob) < 4 or len(blob) < 4 + hlen:
        return True
    try:
        header = json.loads(blob[4:4 + hlen].decode("utf-8"))
        if header.get("version") not in (wire.WIRE_VERSION, wire.WIRE_VERSION_V2):
            return False
        need = sum(int(spec["nbytes"]) for spec in header["leaves"])
    except (ValueError, KeyError):
        return False
    return len(blob) < 4 + hlen + need


class ChunkAssembler:
    """Per-peer reassembly of transport chunk frames (reference
    ``ChunkAssembler``).  Streams are keyed ``(sender, stream_id)``, so
    frames of concurrent uploads interleave freely; within a stream an
    out-of-order frame waits in a reorder buffer and in-order frames feed
    the stream's :class:`MessageStreamDecoder` at once.  A stream idle past
    ``stream_timeout_s`` is evicted by :meth:`sweep`.  One assembler belongs
    to one receive loop, which alone calls :meth:`feed` and :meth:`sweep`."""

    def __init__(self, stream_timeout_s: float = 120.0):
        self.stream_timeout_s = float(stream_timeout_s)
        self._streams: dict[tuple, dict] = {}

    def pending_streams(self) -> int:
        return len(self._streams)

    def feed(self, data) -> tuple:
        """One chunk frame in; ``(message or None, drop reason or None,
        sender or None)`` out."""
        try:
            sub, payload = wire.parse_chunk_frame(data)
        except (ValueError, KeyError, TypeError):
            return None, "chunk_corrupt", None
        sender = int(sub["sender"])
        key = (sender, str(sub["stream"]))
        now = time.monotonic()
        st = self._streams.get(key)
        if st is None:
            st = self._streams[key] = {"dec": MessageStreamDecoder(), "next": 0, "pending": {},
                                       "last": now}
        st["last"] = now
        st["pending"][int(sub["seq"])] = bytes(payload)
        while st["next"] in st["pending"]:
            st["dec"].feed(st["pending"].pop(st["next"]))
            st["next"] += 1
        if st["next"] < int(sub["chunks"]) or st["pending"]:
            return None, None, sender
        # every declared frame is in: the stream ends here, whole or not
        del self._streams[key]
        msg, reason = st["dec"].message()
        return msg, reason, sender

    def sweep(self) -> list:
        """Evict streams idle past the timeout; ``[(sender, stream_id)]``."""
        now = time.monotonic()
        evicted = []
        for key, st in list(self._streams.items()):
            if now - st["last"] > self.stream_timeout_s:
                del self._streams[key]
                evicted.append(key)
        return evicted


def _is_arraylike(v) -> bool:
    if isinstance(v, (np.ndarray, wire.CompressedLeaf)):
        return True
    if isinstance(v, dict):
        return bool(v) and all(_is_arraylike(x) for x in v.values())
    if isinstance(v, (list, tuple)):
        return bool(v) and all(_is_arraylike(x) for x in v)
    return hasattr(v, "__array_interface__")
