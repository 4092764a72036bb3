"""Pytree wire format (the port of ``fedml_tpu/comm/wire.py``, v1 and v2
frames).

A tree of numpy arrays serializes to a self-describing, polyglot layout::

    [4-byte LE header length][header JSON][per-leaf segments...]

v1 header = ``{"version": 1, "treedef": <json skeleton>, "leaves": [{dtype,
shape, nbytes}...]}``.  Frames are byte-identical to the reference's for the
same tree: sorted dict keys, depth first, the same JSON separators.  Models
travel as numpy trees in flax layout (``weights.torch_to_flax`` before a
send), so a torch party and a JAX party read each other's frames.

**Wire v2** (compressed uploads) adds a ``codec`` field to every leaf spec
and keeps the envelope:

- ``raw``   -- the v1 layout.
- ``qsgd8`` -- block-scaled stochastic int8 (``ops/quantize.py``): the
  segment is the per-block f32 scales, then the int8 values; the spec
  carries ``blocks`` and the unpadded ``length``.
- ``topk``  -- a sparse delta: int32 indices, then f32 values; the spec
  carries the dense ``size`` and ``k``.

A frame is v2 only when the tree holds a :class:`CompressedLeaf`; plain trees
keep their v1 bytes.  Decoding is numpy alone (no torch), as in the
reference: it is the polyglot decoder and the tests' oracle.
:func:`iter_leaf_segments` hands out a leaf's raw segments without decoding
them, for a consumer that decodes elsewhere (the server's device fold).

**Transport chunk frames** (``extra.comm_chunk_bytes``): a message larger
than the bound ships as bounded frames of ``CHUNK_MAGIC + <4-byte LE
subheader length> + subheader JSON + chunk bytes`` (the reference's bytes),
so concurrent uploads interleave at the socket level;
``message.ChunkAssembler`` takes them back.
"""

from __future__ import annotations

import json
import struct
from typing import Any, Iterator, Optional

import numpy as np

WIRE_VERSION = 1
WIRE_VERSION_V2 = 2

#: bound on the buffer views :func:`encode_pytree_chunks` yields
CHUNK_BYTES_DEFAULT = 1 << 20

#: transport chunk-frame magic: a legacy payload starts with a 4-byte
#: control length, which these bytes would make ~1.2 GB, so the two never
#: collide
CHUNK_MAGIC = b"FMLCHNK1"

#: elements per qsgd8 block (the reference's (8, 128) f32 tile)
QSGD8_BLOCK = 1024

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


def restore_skeleton(skel, leaves: list) -> Any:
    return _restore_skeleton(skel, leaves)


class CompressedLeaf:
    """A compressed wire-v2 leaf: codec name, dense dtype and shape, codec
    metadata and the segment arrays whose bytes go on the wire.

    ``qsgd8``: segments = (f32 scales ``(blocks,)``, int8 values
    ``(blocks*1024,)``), meta = {"blocks", "length"}.
    ``topk``: segments = (int32 indices ``(k,)``, f32 values ``(k,)``),
    meta = {"size", "k"}.
    """

    __slots__ = ("codec", "dtype", "shape", "meta", "segments")

    def __init__(self, codec: str, dtype, shape, meta: dict, segments):
        self.codec = str(codec)
        self.dtype = np.dtype(dtype).str
        self.shape = tuple(int(s) for s in shape)
        self.meta = dict(meta)
        self.segments = tuple(np.ascontiguousarray(s) for s in segments)

    @property
    def nbytes(self) -> int:
        return sum(int(s.nbytes) for s in self.segments)

    def spec(self) -> dict:
        d = {"codec": self.codec, "dtype": self.dtype,
             "shape": list(self.shape), "nbytes": int(self.nbytes)}
        d.update(self.meta)
        return d

    def dense(self) -> np.ndarray:
        """The dense array the wire decodes this leaf to."""
        raw = b"".join(_raw_view(s) for s in self.segments)
        return _decode_leaf(self.spec(), memoryview(raw), 0)

    def __repr__(self) -> str:
        return (f"CompressedLeaf({self.codec}, dtype={self.dtype}, "
                f"shape={self.shape}, nbytes={self.nbytes})")


def _raw_view(a: np.ndarray):
    """Zero-copy read view of an array's bytes."""
    a = np.ascontiguousarray(a)
    if a.nbytes == 0:
        return b""
    return memoryview(a.reshape(-1).view(np.uint8))


def _prepare_frame(tree: Any) -> tuple:
    """``(header, [buffer views])``: v2 when any leaf is a
    :class:`CompressedLeaf`, else v1 with the reference's key order."""
    leaves: list = []
    skel = _build_skeleton(tree, leaves)
    specs, buffers = [], []
    compressed = False
    for leaf in leaves:
        if isinstance(leaf, CompressedLeaf):
            compressed = True
            specs.append(leaf.spec())
            buffers.extend(_raw_view(s) for s in leaf.segments)
            continue
        if not isinstance(leaf, np.ndarray) and not hasattr(leaf, "__array_interface__"):
            raise TypeError(f"wire leaves are numpy arrays, got {type(leaf).__name__} "
                            "(move tensors to numpy before a send)")
        # spec shape from np.asarray, not ascontiguousarray: the latter makes
        # 0-d scalars (1,) and would change the bytes
        a = np.asarray(leaf)
        specs.append({"dtype": a.dtype.str, "shape": list(a.shape), "nbytes": int(a.nbytes)})
        buffers.append(_raw_view(a))
    if compressed:
        for spec in specs:
            spec.setdefault("codec", "raw")
    header = {"version": WIRE_VERSION_V2 if compressed else WIRE_VERSION, "treedef": skel,
              "leaves": specs}
    return header, buffers


def encode_pytree_chunks(tree: Any, chunk_bytes: int = CHUNK_BYTES_DEFAULT) -> Iterator:
    """The frame as bytes-like pieces: the header first, then each leaf's
    segments in views of at most ``chunk_bytes`` (aliasing the source
    arrays; joined they are :func:`encode_pytree`'s bytes)."""
    header, buffers = _prepare_frame(tree)
    hbytes = json.dumps(header, separators=(",", ":")).encode("utf-8")
    yield struct.pack("<I", len(hbytes)) + hbytes
    for mv in buffers:
        n = len(mv)
        if n == 0:
            continue
        if n <= chunk_bytes:
            yield mv
        else:
            for s in range(0, n, chunk_bytes):
                yield mv[s:s + chunk_bytes]


def encode_pytree(tree: Any) -> bytes:
    """Tree of numpy arrays / scalars (and :class:`CompressedLeaf`) -> wire
    bytes (one output allocation)."""
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
    if version not in (WIRE_VERSION, WIRE_VERSION_V2):
        raise ValueError(f"unsupported wire version {version}")
    payload = sum(int(spec["nbytes"]) for spec in header["leaves"])
    if 4 + hlen + payload != len(mv):
        raise ValueError(
            f"wire payload length mismatch: header declares {payload} leaf "
            f"bytes, buffer has {len(mv) - 4 - hlen}")
    return header, 4 + hlen


def leaf_segments(spec: dict, mv: memoryview, offset: int) -> tuple:
    """One leaf's segments as read-only ``np.frombuffer`` views, undecoded:
    ``raw`` -> ``(array,)`` in its shape; ``qsgd8`` -> ``(f32 scales,
    int8 values)``; ``topk`` -> ``(int32 indices, f32 values)``."""
    codec = spec.get("codec", "raw")
    if codec == "raw":
        dtype = np.dtype(spec["dtype"])
        n = int(spec["nbytes"])
        return (np.frombuffer(mv, dtype=dtype, count=n // dtype.itemsize,
                              offset=offset).reshape(tuple(spec["shape"])),)
    if codec == "qsgd8":
        blocks = int(spec["blocks"])
        return (np.frombuffer(mv, dtype="<f4", count=blocks, offset=offset),
                np.frombuffer(mv, dtype=np.int8, count=blocks * QSGD8_BLOCK,
                              offset=offset + 4 * blocks))
    if codec == "topk":
        k = int(spec["k"])
        return (np.frombuffer(mv, dtype="<i4", count=k, offset=offset),
                np.frombuffer(mv, dtype="<f4", count=k, offset=offset + 4 * k))
    raise ValueError(f"unknown wire codec {codec!r}")


def _decode_leaf(spec: dict, mv: memoryview, offset: int) -> np.ndarray:
    """One leaf -> dense array: ``raw`` a zero-copy view into the buffer,
    ``qsgd8`` ``values * scale`` then the first ``length``, ``topk`` a
    scatter into zeros (the reference's numpy decode)."""
    segs = leaf_segments(spec, mv, offset)
    codec = spec.get("codec", "raw")
    if codec == "raw":
        return segs[0]
    shape = tuple(spec["shape"])
    dtype = np.dtype(spec["dtype"])
    if codec == "qsgd8":
        scales, values = segs
        deq = values.reshape(-1, QSGD8_BLOCK).astype(np.float32) * scales[:, None]
        return deq.reshape(-1)[:int(spec["length"])].astype(dtype, copy=False).reshape(shape)
    idx, vals = segs
    out = np.zeros(int(spec["size"]), np.float32)
    out[idx] = vals
    return out.astype(dtype, copy=False).reshape(shape)


def iter_leaf_segments(data, header: Optional[dict] = None,
                       offset: Optional[int] = None) -> Iterator:
    """``(index, spec, segments)`` per leaf in wire order, nothing decoded
    (:func:`leaf_segments`)."""
    mv = _as_bytes_view(data)
    if header is None:
        header, offset = decode_header(mv)
    off = int(offset)
    for i, spec in enumerate(header["leaves"]):
        yield i, spec, leaf_segments(spec, mv, off)
        off += int(spec["nbytes"])


def iter_leaf_arrays(data, header: Optional[dict] = None,
                     offset: Optional[int] = None) -> Iterator:
    """``(index, spec, dense array)`` per leaf in wire order; raw leaves are
    read-only views into ``data``, compressed ones decoded."""
    mv = _as_bytes_view(data)
    if header is None:
        header, offset = decode_header(mv)
    off = int(offset)
    for i, spec in enumerate(header["leaves"]):
        yield i, spec, _decode_leaf(spec, mv, off)
        off += int(spec["nbytes"])


def decode_pytree(data, header: Optional[dict] = None, offset: Optional[int] = None) -> Any:
    """Wire bytes (v1 or v2) -> tree of numpy arrays, compressed leaves
    dense (raw leaves are read-only views: copy before mutating)."""
    mv = _as_bytes_view(data)
    if header is None:
        header, offset = decode_header(mv)
    leaves = [arr for _, _, arr in iter_leaf_arrays(mv, header=header, offset=offset)]
    return _restore_skeleton(header["treedef"], leaves)


# -- transport chunk frames ---------------------------------------------------

def is_chunk_frame(data) -> bool:
    """True when ``data`` is a transport chunk frame (not a whole message)."""
    mv = _as_bytes_view(data)
    return len(mv) >= len(CHUNK_MAGIC) and bytes(mv[:len(CHUNK_MAGIC)]) == CHUNK_MAGIC


def encode_chunk_frames(payload, *, stream_id: str, sender: int,
                        chunk_bytes: int) -> Iterator[bytes]:
    """One encoded message as bounded, self-describing frames, each with
    ``{"stream", "sender", "seq", "chunks", "total"}``, so a receiver
    reassembles interleaved streams and tolerates out-of-order frames."""
    mv = _as_bytes_view(payload)
    chunk_bytes = max(1, int(chunk_bytes))
    total = len(mv)
    n_chunks = max(1, -(-total // chunk_bytes))
    for seq in range(n_chunks):
        sub = json.dumps({"stream": str(stream_id), "sender": int(sender), "seq": seq,
                          "chunks": n_chunks, "total": total},
                         separators=(",", ":")).encode("utf-8")
        chunk = mv[seq * chunk_bytes:(seq + 1) * chunk_bytes]
        yield CHUNK_MAGIC + struct.pack("<I", len(sub)) + sub + bytes(chunk)


def parse_chunk_frame(data) -> tuple:
    """One chunk frame -> ``(subheader dict, chunk payload view)``."""
    mv = _as_bytes_view(data)
    if not is_chunk_frame(mv):
        raise ValueError("not a chunk frame (bad magic)")
    off = len(CHUNK_MAGIC)
    if len(mv) < off + 4:
        raise ValueError("chunk frame truncated before subheader length")
    (slen,) = struct.unpack_from("<I", mv, off)
    if len(mv) < off + 4 + slen:
        raise ValueError("chunk frame subheader truncated")
    sub = json.loads(bytes(mv[off + 4:off + 4 + slen]).decode("utf-8"))
    for field in ("stream", "sender", "seq", "chunks", "total"):
        if field not in sub:
            raise ValueError(f"chunk subheader missing {field!r}")
    return sub, mv[off + 4 + slen:]


class PytreeStreamDecoder:
    """Incremental frame decoder: ``feed()`` bounded chunks as they arrive;
    each call returns the leaves that chunk completed as ``(index, spec,
    array)``, and consumed bytes are released (peak buffered ~ the largest
    leaf plus a chunk).  ``retain_leaves=False`` keeps nothing, for a
    consumer that folds each leaf as it completes."""

    def __init__(self, retain_leaves: bool = True):
        self._buf = bytearray()
        self._header: Optional[dict] = None
        self._leaf_idx = 0
        self._retain = retain_leaves
        self._leaves: list = []

    @property
    def header(self) -> Optional[dict]:
        return self._header

    @property
    def complete(self) -> bool:
        return self._header is not None and self._leaf_idx >= len(self._header["leaves"])

    def feed(self, chunk) -> list:
        self._buf += bytes(chunk) if isinstance(chunk, memoryview) else chunk
        out: list = []
        if self._header is None:
            if len(self._buf) < 4:
                return out
            (hlen,) = struct.unpack_from("<I", self._buf, 0)
            if len(self._buf) < 4 + hlen:
                return out
            header = json.loads(bytes(self._buf[4:4 + hlen]).decode("utf-8"))
            if header.get("version") not in (WIRE_VERSION, WIRE_VERSION_V2):
                raise ValueError(f"unsupported wire version {header.get('version')}")
            self._header = header
            del self._buf[:4 + hlen]
        specs = self._header["leaves"]
        while self._leaf_idx < len(specs):
            spec = specs[self._leaf_idx]
            n = int(spec["nbytes"])
            if len(self._buf) < n:
                break
            # copy out of the mutable buffer: the del below would invalidate
            # a view into it
            arr = _decode_leaf(spec, memoryview(bytes(self._buf[:n])), 0)
            del self._buf[:n]
            if self._retain:
                self._leaves.append(arr)
            out.append((self._leaf_idx, spec, arr))
            self._leaf_idx += 1
        if self.complete and self._buf:
            raise ValueError(f"{len(self._buf)} trailing bytes after final leaf")
        return out

    def leaves(self) -> list:
        """The decoded leaves in wire order (``retain_leaves`` only)."""
        if not self._retain:
            raise ValueError("decoder built with retain_leaves=False")
        return self._leaves

    def result(self) -> Any:
        if not self.complete:
            raise ValueError(
                f"frame incomplete: {self._leaf_idx}/"
                f"{len(self._header['leaves']) if self._header else '?'} leaves decoded")
        if not self._retain:
            raise ValueError("decoder built with retain_leaves=False")
        return _restore_skeleton(self._header["treedef"], self._leaves)
