"""Pytree wire format (the port of ``fedml_tpu/comm/wire.py``, v1 frames).

A tree of numpy arrays serializes to a self-describing, polyglot layout::

    [4-byte LE header length][header JSON][per-leaf segments...]

header = ``{"version": 1, "treedef": <json skeleton>, "leaves": [{dtype,
shape, nbytes}...]}``.  Frames are byte-identical to the reference's for the
same tree: sorted dict keys, depth first, the same JSON separators.  Models
travel as numpy trees in flax layout (``weights.torch_to_flax`` before a
send), so a torch party and a JAX party read each other's frames.

Wire v2 (compressed leaves) and transport chunk frames are a later slice:
a v2 header is refused with ``NotImplementedError``.
"""

from __future__ import annotations

import json
import struct
from typing import Any, Iterator, Optional

import numpy as np

WIRE_VERSION = 1

# JSON pytree skeleton: dict -> {"d": {k: skel}}, list/tuple -> {"l"/"t": [...]},
# leaf -> {"x": leaf_index}


def _build_skeleton(obj, leaves: list):
    if isinstance(obj, dict):
        return {"d": {str(k): _build_skeleton(v, leaves) for k, v in sorted(obj.items())}}
    if isinstance(obj, (list, tuple)):
        tag = "l" if isinstance(obj, list) else "t"
        return {tag: [_build_skeleton(v, leaves) for v in obj]}
    leaves.append(obj)
    return {"x": len(leaves) - 1}


def _restore_skeleton(skel, leaves: list):
    if "d" in skel:
        return {k: _restore_skeleton(v, leaves) for k, v in skel["d"].items()}
    if "l" in skel:
        return [_restore_skeleton(v, leaves) for v in skel["l"]]
    if "t" in skel:
        return tuple(_restore_skeleton(v, leaves) for v in skel["t"])
    return leaves[skel["x"]]


def flatten_with_skeleton(tree: Any) -> tuple:
    """(skeleton, leaves) in wire order (sorted dict keys, depth first)."""
    leaves: list = []
    skel = _build_skeleton(tree, leaves)
    return skel, leaves


def _raw_view(a: np.ndarray):
    """Zero-copy read view of an array's bytes."""
    a = np.ascontiguousarray(a)
    if a.nbytes == 0:
        return b""
    return memoryview(a.reshape(-1).view(np.uint8))


def encode_pytree_chunks(tree: Any) -> Iterator:
    """The frame as bytes-like pieces: header first, then one view per leaf
    (the views alias the source arrays)."""
    leaves: list = []
    skel = _build_skeleton(tree, leaves)
    specs, buffers = [], []
    for leaf in leaves:
        if not isinstance(leaf, np.ndarray) and not hasattr(leaf, "__array_interface__"):
            raise TypeError(f"wire leaves are numpy arrays, got {type(leaf).__name__} "
                            "(move tensors to numpy before a send)")
        # spec shape from np.asarray, not ascontiguousarray: the latter makes
        # 0-d scalars (1,) and would change the bytes
        a = np.asarray(leaf)
        specs.append({"dtype": a.dtype.str, "shape": list(a.shape), "nbytes": int(a.nbytes)})
        buffers.append(_raw_view(a))
    header = {"version": WIRE_VERSION, "treedef": skel, "leaves": specs}
    hbytes = json.dumps(header, separators=(",", ":")).encode("utf-8")
    yield struct.pack("<I", len(hbytes)) + hbytes
    yield from (b for b in buffers if len(b))


def encode_pytree(tree: Any) -> bytes:
    """Tree of numpy arrays/scalars -> wire bytes (one output allocation)."""
    return b"".join(encode_pytree_chunks(tree))


def _as_bytes_view(data) -> memoryview:
    mv = data if isinstance(data, memoryview) else memoryview(data)
    if mv.format != "B" or mv.ndim != 1:
        mv = mv.cast("B")
    return mv


def decode_header(data) -> tuple:
    """Parse + validate the frame header; returns ``(header, payload_offset)``.
    Framing corruption fails here, before any leaf is read."""
    mv = _as_bytes_view(data)
    if len(mv) < 4:
        raise ValueError(f"wire frame too short ({len(mv)} bytes)")
    (hlen,) = struct.unpack_from("<I", mv, 0)
    if 4 + hlen > len(mv):
        raise ValueError(f"wire header truncated ({hlen} declared, {len(mv) - 4} present)")
    header = json.loads(bytes(mv[4:4 + hlen]).decode("utf-8"))
    version = header.get("version")
    if version == 2:
        raise NotImplementedError("wire v2 (compressed leaves) is not ported yet")
    if version != WIRE_VERSION:
        raise ValueError(f"unsupported wire version {version}")
    payload = sum(int(spec["nbytes"]) for spec in header["leaves"])
    if 4 + hlen + payload != len(mv):
        raise ValueError(
            f"wire payload length mismatch: header declares {payload} leaf "
            f"bytes, buffer has {len(mv) - 4 - hlen}")
    return header, 4 + hlen


def iter_leaf_arrays(data, header: Optional[dict] = None,
                     offset: Optional[int] = None) -> Iterator:
    """``(index, spec, array)`` per leaf in wire order; arrays are read-only
    ``np.frombuffer`` views into ``data``."""
    mv = _as_bytes_view(data)
    if header is None:
        header, offset = decode_header(mv)
    off = int(offset)
    for i, spec in enumerate(header["leaves"]):
        dtype = np.dtype(spec["dtype"])
        n = int(spec["nbytes"])
        yield i, spec, np.frombuffer(mv, dtype=dtype, count=n // dtype.itemsize,
                                     offset=off).reshape(tuple(spec["shape"]))
        off += n


def decode_pytree(data, header: Optional[dict] = None, offset: Optional[int] = None) -> Any:
    """Wire bytes -> tree of numpy arrays (read-only views: copy before
    mutating)."""
    mv = _as_bytes_view(data)
    if header is None:
        header, offset = decode_header(mv)
    leaves = [arr for _, _, arr in iter_leaf_arrays(mv, header=header, offset=offset)]
    return _restore_skeleton(header["treedef"], leaves)
