"""Federated dataset containers (numpy, host side).

The port's copy of ``fedml_tpu/data/dataset.py``'s main-path pieces:
:class:`FederatedDataset` (global arrays + per-client index lists, and
per-client test index lists where a loader splits its test set by client),
:func:`stack_clients` (cyclic-padded ``(n_clients, capacity, ...)`` arrays +
true sample counts) and :func:`pad_eval_set`; a segmentation dataset also
carries its per-pixel ``masks`` / ``test_masks``.  Bitwise equal to the
reference for the same inputs (``tests/test_torch_config_data.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class FederatedDataset:
    train_x: np.ndarray  # (N_train, ...) float32 features
    train_y: np.ndarray  # (N_train,) int labels
    test_x: np.ndarray
    test_y: np.ndarray
    client_idx: list  # list[np.ndarray] — per-client train sample indices
    class_num: int
    test_client_idx: Optional[list] = None  # per-client test split (LEAF-style)
    name: str = ""
    # segmentation datasets (FeTS2021): per-sample integer masks; train_y
    # then holds each sample's dominant class (the partition's labels)
    masks: Optional[np.ndarray] = None
    test_masks: Optional[np.ndarray] = None

    @property
    def n_clients(self) -> int:
        return len(self.client_idx)

    @property
    def train_num(self) -> int:
        return int(self.train_x.shape[0])

    @property
    def test_num(self) -> int:
        return int(self.test_x.shape[0])

    def local_sample_counts(self) -> np.ndarray:
        return np.array([len(ix) for ix in self.client_idx], dtype=np.int32)


@dataclass
class StackedClientData:
    """Padded per-client arrays.  Padding slots are cyclic repeats of real
    samples, so every slot is valid; ``counts`` holds the true sizes (the
    FedAvg weights)."""

    x: np.ndarray  # (n_clients, capacity, *feat)
    y: np.ndarray  # (n_clients, capacity)
    counts: np.ndarray  # (n_clients,)

    @property
    def n_clients(self) -> int:
        return int(self.x.shape[0])

    @property
    def capacity(self) -> int:
        return int(self.x.shape[1])


def stack_clients(
    ds: FederatedDataset, capacity: Optional[int] = None, multiple_of: int = 1
) -> StackedClientData:
    """Pad client shards to a common capacity by cyclic repetition;
    ``multiple_of`` (the batch size) rounds the capacity up."""
    counts = ds.local_sample_counts()
    cap = int(capacity if capacity is not None else counts.max())
    if multiple_of > 1:
        cap = ((cap + multiple_of - 1) // multiple_of) * multiple_of
    n = ds.n_clients
    x = np.empty((n, cap) + ds.train_x.shape[1:], dtype=ds.train_x.dtype)
    y = np.empty((n, cap) + ds.train_y.shape[1:], dtype=ds.train_y.dtype)
    for i, idxs in enumerate(ds.client_idx):
        if len(idxs) == 0:
            raise ValueError(f"client {i} has no samples")
        reps = np.resize(idxs, cap)  # cyclic repeat to capacity
        x[i] = ds.train_x[reps]
        y[i] = ds.train_y[reps]
    return StackedClientData(x=x, y=y, counts=counts)


def pad_eval_set(x: np.ndarray, y: np.ndarray, batch_size: int):
    """Tile an eval set up to a batch multiple (>= one full batch).
    Returns (x_padded, y_padded, n_valid); eval masks positions >= n_valid."""
    n = x.shape[0]
    target = max(batch_size, ((n + batch_size - 1) // batch_size) * batch_size)
    if target != n:
        reps = np.resize(np.arange(n), target)
        x, y = x[reps], y[reps]
    return x, y, n
