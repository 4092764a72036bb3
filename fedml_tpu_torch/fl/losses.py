"""Loss functions (the port of ``fedml_tpu/fl/losses.py``, classification
path)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over integer labels."""
    return F.cross_entropy(logits, labels.long())


def cross_entropy_lanes(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """:func:`cross_entropy` of each lane: ``(L, N, K)`` logits and ``(L,
    N)`` labels -> ``(L,)`` means."""
    return F.cross_entropy(logits.transpose(1, 2), labels.long(), reduction="none").mean(1)


def get_lane_loss_fn(name: str):
    """The per-lane form of :func:`get_loss_fn`'s loss."""
    if name == "cross_entropy":
        return cross_entropy_lanes
    raise NotImplementedError(f"loss {name!r} is not ported yet (first port slice: cross_entropy)")


def get_loss_fn(name: str):
    if name == "cross_entropy":
        return cross_entropy
    raise NotImplementedError(f"loss {name!r} is not ported yet (first port slice: cross_entropy)")
