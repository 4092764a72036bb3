"""The cross-silo server's streaming accumulator, on the server's device
(the port of ``fedml_tpu/parallel/stream_fold.py``'s
``HostStreamAccumulator``).

The server folds each arriving model reply, leaf by leaf, into a running
weighted sum: one f32 sum per wire leaf, in flax layout (the wire's), held
on the device.  ``fold_leaf(i, w, x)`` computes ``sums[i] += f32(w) * x``
and ``finalize`` ``((sum + f32(w_delta) * base) / f32(total)).to(dtype)``.

Bitwise discipline: every step is its own IEEE f32 elementwise launch (a
multiply, then an add; an add of the base's product; a true division), the
reference's numpy operations one for one, so the device fold is bitwise the
reference's host fold (what its device form ``ShardedStreamAccumulator``
does under jit for the same reason).  ``torch.add(a, b, alpha=w)`` could
contract into an FMA and is not used; the scalars are f32 device tensors,
since PyTorch turns a CUDA division by a host scalar into a multiply by
its reciprocal.

A compressed leaf arrives as its wire segments (``wire.leaf_segments``):
they are copied once into tensors (through pinned memory on the card), and a
``qsgd8`` leaf is dequantized by ``ops/quantize.dequantize_int8`` (the CUDA
kernel on the card) before it is folded; a ``topk`` leaf is scattered into
zeros.  On the CPU the same code runs the plain versions.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..comm import wire


def _torch_dtype(np_dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, np_dtype)).dtype


def host_to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """One copy of a (possibly read-only) host array into a tensor on
    ``device``: through pinned memory and a copy on the current stream when
    ``device`` is a card."""
    a = np.asarray(a)
    if device.type == "cuda":
        pinned = torch.empty(a.shape, dtype=_torch_dtype(a.dtype), pin_memory=True)
        np.copyto(pinned.numpy(), a)
        return pinned.to(device, non_blocking=True)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def decode_leaf(spec: dict, segments: tuple, device: torch.device) -> torch.Tensor:
    """One wire leaf's segments -> its dense value on ``device`` (the
    reference's numpy ``_decode_leaf``, on the device): ``raw`` as sent,
    ``qsgd8`` through the dequantize kernel, ``topk`` scattered."""
    codec = spec.get("codec", "raw")
    if codec == "raw":
        return host_to_device(segments[0], device)
    shape = tuple(spec["shape"])
    dtype = _torch_dtype(np.dtype(spec["dtype"]))
    if codec == "qsgd8":
        from ..ops import quantize

        scales, values = segments
        blocks, length = int(spec["blocks"]), int(spec["length"])
        v = host_to_device(values, device).view(quantize.noise_shape(blocks * wire.QSGD8_BLOCK))
        out = quantize.dequantize_int8(v, host_to_device(scales, device), length)
    elif codec == "topk":
        idx, vals = segments
        out = torch.zeros(int(spec["size"]), dtype=torch.float32, device=device)
        out[host_to_device(idx, device).long()] = host_to_device(vals, device)
    else:
        raise ValueError(f"unknown wire codec {codec!r}")
    return out.to(dtype).reshape(shape)


class DeviceStreamAccumulator:
    """One f32 sum per wire leaf on ``device``; ``sums`` (host arrays, a
    journal's partial sums) starts it where a crashed fold left off."""

    def __init__(self, templates: Sequence[torch.Tensor], device, sums=None):
        self.device = torch.device(device)
        if sums is not None:
            self._sums = [host_to_device(np.asarray(s, np.float32), self.device) for s in sums]
        else:
            self._sums = [torch.zeros(tuple(t.shape), dtype=torch.float32, device=self.device)
                          for t in templates]

    def scalar(self, v: float) -> torch.Tensor:
        """``f32(v)`` as a 0-d tensor on the device (a fold weight made once
        for all the leaves of a reply)."""
        return torch.full((), float(np.float32(v)), dtype=torch.float32, device=self.device)

    def fold_leaf(self, i: int, w, x: torch.Tensor) -> None:
        """``sums[i] += f32(w) * x``: a multiply, then an add (``w`` a
        number or :meth:`scalar`)."""
        w = w if isinstance(w, torch.Tensor) else self.scalar(w)
        self._sums[i].add_(torch.mul(w, x.to(self.device, torch.float32)))

    def sums(self) -> list:
        return list(self._sums)

    def host_sums(self) -> list:
        """The per-leaf f32 sums as host arrays (a journal snapshot's form)."""
        return [s.detach().cpu().numpy() for s in self._sums]

    def finalize(self, templates: Sequence[torch.Tensor], w_delta: float, total: float) -> list:
        """``((sum + f32(w_delta) * base) / f32(total)).to(base dtype)`` per
        leaf, each operation its own launch; ``templates`` are the round's
        base leaves (flax layout, on the device)."""
        tot = self.scalar(total)
        out = []
        for acc, t in zip(self._sums, templates):
            if w_delta:
                # delta senders contributed w * (model - global): their share
                # of the base comes back before the division
                acc = torch.add(acc, torch.mul(self.scalar(w_delta), t.to(torch.float32)))
            out.append(torch.div(acc, tot).to(t.dtype))
        return out
