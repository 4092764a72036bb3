"""Client data partitioners.

Semantics-parity with the reference partitioners
(``data/cifar10/data_loader.py:122-162`` ``partition_data`` and
``core/data/noniid_partition.py``):

- ``homo``      — IID: a random permutation split into equal shards.
- ``hetero``    — non-IID: per-class Dirichlet(alpha) proportions with the
                  reference's min-size-10 rebalancing loop (resample until the
                  smallest client shard has >= 10 samples).
- ``hetero-fix``— fixed distribution from a provided table.

Pure functions of ``(labels, n_clients, alpha, seed)`` — no global numpy state
— so partitions are reproducible across backends and hosts.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

MIN_PARTITION_SIZE = 10  # reference: `while min_size < 10` rebalancing loop


def partition_homo(n_samples: int, n_clients: int, seed: int = 0) -> list[np.ndarray]:
    rng = np.random.RandomState(seed)
    idxs = rng.permutation(n_samples)
    return [np.sort(part) for part in np.array_split(idxs, n_clients)]


def partition_hetero_dirichlet(
    labels: np.ndarray, n_clients: int, alpha: float, seed: int = 0
) -> list[np.ndarray]:
    """Per-class Dirichlet(alpha) partition with min-size rebalance.

    Mirrors the reference loop (``data/cifar10/data_loader.py:136-162``):
    for each class, draw Dirichlet proportions over clients, down-weight
    clients already holding >= N/n samples, split that class's indices by the
    cumulative proportions; repeat the whole draw until min client size >= 10.
    """
    rng = np.random.RandomState(seed)
    n = labels.shape[0]
    classes = np.unique(labels)
    min_size = 0
    idx_batch: list[list[int]] = [[] for _ in range(n_clients)]
    guard = 0
    while min_size < MIN_PARTITION_SIZE:
        guard += 1
        if guard > 1000:
            raise RuntimeError("dirichlet partition failed to reach min size; alpha too small for dataset")
        idx_batch = [[] for _ in range(n_clients)]
        for k in classes:
            idx_k = np.where(labels == k)[0]
            rng.shuffle(idx_k)
            proportions = rng.dirichlet(np.repeat(alpha, n_clients))
            # balance clause from the reference: zero out clients already full
            proportions = np.array(
                [p * (len(idx_j) < n / n_clients) for p, idx_j in zip(proportions, idx_batch)]
            )
            proportions = proportions / proportions.sum()
            split_points = (np.cumsum(proportions) * len(idx_k)).astype(int)[:-1]
            for j, part in enumerate(np.split(idx_k, split_points)):
                idx_batch[j].extend(part.tolist())
        min_size = min(len(b) for b in idx_batch)
    return [np.sort(np.array(b, dtype=np.int64)) for b in idx_batch]


def partition_hetero_fix(
    labels: np.ndarray, n_clients: int, distribution: Sequence[Sequence[float]]
) -> list[np.ndarray]:
    """Fixed per-client class distribution table (reference ``hetero-fix``:
    reads a distribution file; here the table is passed in directly)."""
    dist = np.asarray(distribution, dtype=np.float64)  # (n_clients, n_classes)
    classes = np.unique(labels)
    out: list[list[int]] = [[] for _ in range(n_clients)]
    for ci, k in enumerate(classes):
        idx_k = np.where(labels == k)[0]
        props = dist[:, ci] / max(dist[:, ci].sum(), 1e-12)
        split_points = (np.cumsum(props) * len(idx_k)).astype(int)[:-1]
        for j, part in enumerate(np.split(idx_k, split_points)):
            out[j].extend(part.tolist())
    return [np.sort(np.array(b, dtype=np.int64)) for b in out]


def partition(
    method: str,
    labels: np.ndarray,
    n_clients: int,
    alpha: float = 0.5,
    seed: int = 0,
    distribution: Optional[Sequence[Sequence[float]]] = None,
) -> list[np.ndarray]:
    if method == "homo":
        return partition_homo(labels.shape[0], n_clients, seed)
    if method == "hetero":
        return partition_hetero_dirichlet(labels, n_clients, alpha, seed)
    if method == "hetero-fix":
        if distribution is None:
            raise ValueError("hetero-fix requires a distribution table")
        return partition_hetero_fix(labels, n_clients, distribution)
    raise ValueError(f"unknown partition method {method!r}")


def record_data_stats(labels: np.ndarray, idx_map: list[np.ndarray]) -> dict:
    """Per-client class histogram (reference ``record_net_data_stats``)."""
    stats = {}
    for i, idxs in enumerate(idx_map):
        unq, cnt = np.unique(labels[idxs], return_counts=True)
        stats[i] = {int(u): int(c) for u, c in zip(unq, cnt)}
    return stats
