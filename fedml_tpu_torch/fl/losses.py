"""Loss and metric functions (the port of ``fedml_tpu/fl/losses.py``).

One dispatch over the task families, as in the reference:

- ``cross_entropy`` with integer labels: ``(B, C)`` logits and ``(B,)``
  labels (classification) or ``(B, T, C)`` and ``(B, T)`` (next-token
  prediction), the mean over every labelled position;
- ``cross_entropy`` with multi-hot targets (logits and labels of one
  shape, tag prediction): optax's ``sigmoid_binary_cross_entropy`` written
  out as optax computes it, ``-y log_sigmoid(x) - (1 - y) log_sigmoid(-x)``,
  the mean over every element;
- ``mse``: the mean squared error.

Each has a lane form (``*_lanes``): a leading lane axis on logits and
labels, one mean a lane, ``(L,)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _integer_labels(logits: torch.Tensor, labels: torch.Tensor) -> bool:
    return logits.ndim == labels.ndim + 1


def sigmoid_binary_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Elementwise optax ``sigmoid_binary_cross_entropy``."""
    labels = labels.to(logits.dtype)
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy (module docstring)."""
    if not _integer_labels(logits, labels):
        return sigmoid_binary_cross_entropy(logits, labels).mean()
    if logits.ndim == 2:
        return F.cross_entropy(logits, labels.long())
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1).long())


def cross_entropy_lanes(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """:func:`cross_entropy` of each lane: ``(L, N, ...)`` logits and
    labels -> ``(L,)`` means."""
    lanes = logits.shape[0]
    if not _integer_labels(logits, labels):
        return sigmoid_binary_cross_entropy(logits, labels).reshape(lanes, -1).mean(1)
    if logits.ndim == 3:
        return F.cross_entropy(logits.transpose(1, 2), labels.long(), reduction="none").mean(1)
    per = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1).long(),
                          reduction="none")
    return per.reshape(lanes, -1).mean(1)


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred - target).square().mean()


def mse_lanes(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred - target).square().reshape(pred.shape[0], -1).mean(1)


def accuracy_count(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Number of correct argmax predictions (summable across batches)."""
    return (logits.argmax(-1) == labels).sum()


_LOSSES = {"cross_entropy": (cross_entropy, cross_entropy_lanes), "mse": (mse, mse_lanes)}


def _lookup(name: str, lanes: bool):
    if name not in _LOSSES:
        raise ValueError(f"unknown loss {name!r}")
    return _LOSSES[name][int(lanes)]


def get_lane_loss_fn(name: str):
    """The per-lane form of :func:`get_loss_fn`'s loss."""
    return _lookup(name, lanes=True)


def get_loss_fn(name: str):
    return _lookup(name, lanes=False)
