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
"""

from __future__ import annotations

import json
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


def _is_arraylike(v) -> bool:
    if isinstance(v, (np.ndarray, wire.CompressedLeaf)):
        return True
    if isinstance(v, dict):
        return bool(v) and all(_is_arraylike(x) for x in v.values())
    if isinstance(v, (list, tuple)):
        return bool(v) and all(_is_arraylike(x) for x in v)
    return hasattr(v, "__array_interface__")
