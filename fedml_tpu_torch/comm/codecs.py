"""Model-update payload accounting (the port of ``fedml_tpu/comm/codecs.py``).

Ported: :func:`codec_from_config`, which recognises the reference's codec
names, and the payload counters that secure-aggregation uploads feed
(:func:`note_masked_payload`, :func:`payload_counters`).  The wire codecs
themselves (qsgd8 and top-k leaves over the wire) are a later slice, so
``extra.comm_compression`` set to either raises ``NotImplementedError``.

The counters are process-wide and cumulative, like the reference's registry
counters they stand in for.
"""

from __future__ import annotations

import threading
from typing import Optional

#: codecs a payload leaf may carry (``raw`` is the identity)
CODECS = ("raw", "qsgd8", "topk")

#: secure-aggregation upload forms: ``secagg_dense`` = fixed point over the
#: M31 field on a u32 wire; ``secagg_qsgd8`` = quantize-then-mask
MASKED_CODECS = ("secagg_dense", "secagg_qsgd8")

_lock = threading.Lock()
_wire_bytes: dict = {}
_raw_bytes: dict = {}


def codec_from_config(cfg) -> Optional[str]:
    """``extra.comm_compression`` -> None when compression is off (unset /
    ``no`` / ``off`` / ``none`` / ``raw``); a known codec raises (not ported
    yet), an unknown one raises ``ValueError`` as in the reference."""
    from ..core.flags import cfg_extra

    name = str(cfg_extra(cfg, "comm_compression") or "").strip().lower()
    if name in ("", "no", "off", "none", "raw"):
        return None
    if name not in CODECS:
        raise ValueError(f"unknown comm_compression {name!r}; known: {CODECS[1:]}")
    raise NotImplementedError(f"comm_compression {name!r} (compressed uploads over the wire) "
                              "is not ported yet")


def note_masked_payload(codec: str, wire_bytes: int, raw_bytes: int) -> None:
    """Account one secure-aggregation upload: ``wire_bytes`` = the packed
    masked vector as shipped, ``raw_bytes`` = the dense f32 equivalent."""
    with _lock:
        _wire_bytes[codec] = _wire_bytes.get(codec, 0) + int(wire_bytes)
        _raw_bytes[codec] = _raw_bytes.get(codec, 0) + int(raw_bytes)


def payload_counters() -> dict:
    """Snapshot of the payload accounting, by codec."""
    out = {}
    with _lock:
        for codec in CODECS[1:] + MASKED_CODECS:
            wire_b, raw_b = _wire_bytes.get(codec, 0), _raw_bytes.get(codec, 0)
            if wire_b or raw_b:
                out[codec] = {"wire_bytes": int(wire_b), "raw_bytes": int(raw_b),
                              "ratio": round(raw_b / max(wire_b, 1.0), 3)}
    return out
