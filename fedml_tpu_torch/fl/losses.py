"""Loss functions (the port of ``fedml_tpu/fl/losses.py``, classification
path)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over integer labels."""
    return F.cross_entropy(logits, labels.long())


def get_loss_fn(name: str):
    if name == "cross_entropy":
        return cross_entropy
    raise NotImplementedError(f"loss {name!r} is not ported yet (first port slice: cross_entropy)")
