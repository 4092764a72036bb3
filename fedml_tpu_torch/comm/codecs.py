"""Per-leaf compression codecs for model-update payloads on wire v2 (the
port of ``fedml_tpu/comm/codecs.py``).

:func:`compress_pytree` maps a tree of (delta) leaves in flax layout to a
tree where the large float leaves become :class:`~fedml_tpu_torch.comm.wire.
CompressedLeaf` segments and the small or non-float ones ride raw (a 64-
element BatchNorm bias padded to a 1024-element qsgd8 block would grow):

- ``qsgd8``: block-scaled stochastic int8 through ``ops/quantize.
  quantize_int8_stochastic`` on the leaf's own device (the CUDA kernel on
  the card, the plain version on the CPU); only the int8 values and the f32
  scales cross to the host.  The uniform draw of leaf ``i`` comes from
  ``fold_in(key, i)`` (the reference draws it inside its kernel call from
  the same fold), or from a ``uniform(i, shape, device)`` hook.
- ``topk``: the ``ef_top_k`` rule in sparse form, in plain torch: the
  carried residual added, the k largest |x| kept as (index, value) pairs,
  the rest the next residual.  Pairs are ordered as ``jax.lax.top_k``
  orders them (descending, a tie to the lower index), so frames are the
  reference's bytes.

Decompression lives in ``comm.wire`` (numpy only) and, on the server's
device, in ``parallel/stream_fold.py``.

Payload accounting (the reference's registry counters, here process-wide
dicts): wire and dense-equivalent bytes and their ratio by codec,
cumulative (:func:`payload_counters`); secure-aggregation uploads feed the
same counters (:func:`note_masked_payload`).
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

import numpy as np
import torch

from ..core import rng
from . import wire

#: codecs a payload leaf may carry (``raw`` is the identity)
CODECS = ("raw", "qsgd8", "topk")

#: secure-aggregation upload forms: ``secagg_dense`` = fixed point over the
#: M31 field on a u32 wire; ``secagg_qsgd8`` = quantize-then-mask
MASKED_CODECS = ("secagg_dense", "secagg_qsgd8")

#: leaves below this element count stay raw: the qsgd8 block padding (1024
#: elements) would expand them, and their bytes are noise at model scale
DEFAULT_MIN_COMPRESS_ELEMS = 1024

#: the floor for trees that are all low-rank factors (LoRA adapters): a leaf
#: of n <= 1024 f32 elements shrinks under qsgd8 iff n > 257 (4n raw bytes
#: against 1024 + 4 compressed), 260 with a margin
LOW_RANK_MIN_COMPRESS_ELEMS = 260

_lock = threading.Lock()
_wire_bytes: dict = {}
_raw_bytes: dict = {}


def codec_from_config(cfg) -> Optional[str]:
    """``extra.comm_compression`` -> the codec name, or None when compression
    is off (unset / ``no`` / ``off`` / ``none`` / ``raw``); an unknown name
    raises ``ValueError``."""
    from ..core.flags import cfg_extra

    name = str(cfg_extra(cfg, "comm_compression") or "").strip().lower()
    if name in ("", "no", "off", "none", "raw"):
        return None
    if name not in CODECS:
        raise ValueError(f"unknown comm_compression {name!r}; known: {CODECS[1:]}")
    return name


def _note(codec: str, wire_bytes: int, raw_bytes: int) -> None:
    with _lock:
        _wire_bytes[codec] = _wire_bytes.get(codec, 0) + int(wire_bytes)
        _raw_bytes[codec] = _raw_bytes.get(codec, 0) + int(raw_bytes)


def note_masked_payload(codec: str, wire_bytes: int, raw_bytes: int) -> None:
    """Account one secure-aggregation upload: ``wire_bytes`` = the packed
    masked vector as shipped, ``raw_bytes`` = the dense f32 equivalent."""
    _note(codec, wire_bytes, raw_bytes)


def payload_counters() -> dict:
    """Snapshot of the payload accounting, by codec (cumulative)."""
    out = {}
    with _lock:
        for codec in CODECS[1:] + MASKED_CODECS:
            wire_b, raw_b = _wire_bytes.get(codec, 0), _raw_bytes.get(codec, 0)
            if wire_b or raw_b:
                out[codec] = {"wire_bytes": int(wire_b), "raw_bytes": int(raw_b),
                              "ratio": round(raw_b / max(wire_b, 1.0), 3)}
    return out


def _topk_order(mag: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest of ``mag``, descending, a tie to the
    lower index (``jax.lax.top_k``'s order; ``torch.topk`` promises none)."""
    return torch.sort(mag, descending=True, stable=True).indices[:k]


def _compress_vec(codec: str, vec: torch.Tensor, draw: Callable, residual, ratio: float):
    """One flat f32 vector on its device -> ``(segments, meta,
    new_residual)``; ``draw(shape)`` gives qsgd8's uniform draw."""
    if codec == "qsgd8":
        from ..ops import quantize as q

        values, scales, n = q.quantize_int8_stochastic(vec, draw(q.noise_shape(vec.numel())))
        segments = (scales.cpu().numpy().astype("<f4", copy=False),
                    values.reshape(-1).cpu().numpy())
        return segments, {"blocks": int(scales.shape[0]), "length": int(n)}, residual
    if codec == "topk":
        corrected = vec if residual is None else vec + residual
        k = max(1, int(ratio * corrected.shape[0]))
        idx = _topk_order(corrected.abs(), k)
        vals = corrected[idx]
        new_residual = corrected.clone()
        new_residual[idx] = 0.0
        segments = (idx.to(torch.int32).cpu().numpy().astype("<i4", copy=False),
                    vals.cpu().numpy().astype("<f4", copy=False))
        return segments, {"size": int(corrected.shape[0]), "k": int(k)}, new_residual
    raise ValueError(f"unknown codec {codec!r}")


def _as_tensor(leaf) -> torch.Tensor:
    return leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(np.array(leaf))


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def compress_pytree(tree, codec: Optional[str], *, key=None, residuals=None,
                    ratio: float = 0.01, min_elems: int = DEFAULT_MIN_COMPRESS_ELEMS,
                    uniform: Optional[Callable] = None):
    """Compress the large float leaves of ``tree`` (flax layout; tensors on
    any device, or numpy arrays) with ``codec``.

    Returns ``(compressed tree, new_residuals, stats)``: the tree's leaves
    are numpy arrays and :class:`~fedml_tpu_torch.comm.wire.CompressedLeaf`
    (ready for the wire); ``residuals`` / ``new_residuals`` are lists in
    wire leaf order carrying top-k's error feedback across rounds (f32
    tensors on the leaves' device; qsgd8 carries none); ``stats`` =
    ``{"raw_bytes", "wire_bytes", "ratio"}``.  ``key`` (a port key) seeds
    qsgd8's draw of leaf ``i`` from ``fold_in(key, i)``; ``uniform(i, shape,
    device)``, when given, supplies it instead.  A codec failure raises."""
    skel, leaves = wire.flatten_with_skeleton(tree)
    tensors = [_as_tensor(leaf) for leaf in leaves]
    if codec is None:
        nbytes = sum(t.numel() * t.element_size() for t in tensors)
        return (wire.restore_skeleton(skel, [_host(t) for t in tensors]), residuals,
                {"raw_bytes": nbytes, "wire_bytes": nbytes, "ratio": 1.0})
    if key is None:
        key = rng.root_key(0)
    new_residuals: list = [None] * len(tensors)
    out_leaves: list = []
    raw_bytes = wire_bytes = 0
    for i, t in enumerate(tensors):
        raw_bytes += t.numel() * t.element_size()
        if not t.is_floating_point() or t.numel() < min_elems:
            a = _host(t)
            out_leaves.append(a)
            wire_bytes += a.nbytes
            continue
        vec = t.detach().reshape(-1).to(torch.float32)

        def draw(shape, i=i, device=vec.device):
            if uniform is not None:
                return uniform(i, shape, device)
            return torch.rand(shape, generator=rng.generator(rng.fold_in(key, i), device),
                              device=device)

        prev = residuals[i] if residuals is not None else None
        segments, meta, new_residuals[i] = _compress_vec(codec, vec, draw, prev, ratio)
        cl = wire.CompressedLeaf(codec, torch.empty(0, dtype=t.dtype).numpy().dtype,
                                 tuple(t.shape), meta, segments)
        out_leaves.append(cl)
        wire_bytes += cl.nbytes
    _note(codec, wire_bytes, raw_bytes)
    return (wire.restore_skeleton(skel, out_leaves), new_residuals,
            {"raw_bytes": int(raw_bytes), "wire_bytes": int(wire_bytes),
             "ratio": float(raw_bytes / max(wire_bytes, 1))})
