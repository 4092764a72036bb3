"""Decentralized-FL topologies as dense mixing matrices (host numpy).

The port's copy of ``fedml_tpu/parallel/topology.py``, bitwise: a ring with
self-loops, a ring plus random symmetric links (DSGD), a directed ring plus
random out-links (PushSum), the column renormalisation PushSum needs, and
the uniform all-to-all matrix.  Each random topology is deterministic in
its ``seed`` (``np.random.RandomState``).  ``sim/decentralized.py`` mixes
the stacked client models with them as one ``(n, n) x (n, d)`` product;
its ring mode never builds the matrix and keeps :func:`ring_topology` as
the reference the tests hold it to.
"""

from __future__ import annotations

import numpy as np


def ring_topology(n: int, symmetric: bool = True) -> np.ndarray:
    """Ring with self-loops, row-normalized (uniform over {self, prev, next})."""
    W = np.zeros((n, n), dtype=np.float32)
    for i in range(n):
        W[i, i] = 1.0
        W[i, (i - 1) % n] = 1.0
        W[i, (i + 1) % n] = 1.0
    if not symmetric:
        for i in range(n):
            W[i, (i - 1) % n] = 0.0
    return W / W.sum(axis=1, keepdims=True)


def symmetric_topology(n: int, neighbor_num: int, seed: int = 0) -> np.ndarray:
    """Ring + random symmetric extra links, row-normalized.

    Semantics of the reference's ``SymmetricTopologyManager`` (undirected ring
    with ``neighbor_num`` target degree via random rewiring), deterministic in
    ``seed`` instead of global numpy state.
    """
    rng = np.random.RandomState(seed)
    A = np.zeros((n, n), dtype=np.float32)
    for i in range(n):
        A[i, i] = 1.0
        A[i, (i - 1) % n] = 1.0
        A[i, (i + 1) % n] = 1.0
    extra = max(0, neighbor_num - 2)
    for i in range(n):
        candidates = [j for j in range(n) if j != i and A[i, j] == 0]
        if not candidates:
            continue
        picks = rng.choice(candidates, size=min(extra, len(candidates)), replace=False)
        for j in picks:
            A[i, j] = 1.0
            A[j, i] = 1.0  # keep symmetric
    return A / A.sum(axis=1, keepdims=True)


def asymmetric_topology(n: int, neighbor_num: int, seed: int = 0) -> np.ndarray:
    """Directed ring + random out-links, row-normalized (PushSum-style)."""
    rng = np.random.RandomState(seed)
    A = np.zeros((n, n), dtype=np.float32)
    for i in range(n):
        A[i, i] = 1.0
        A[i, (i + 1) % n] = 1.0
        candidates = [j for j in range(n) if j != i and A[i, j] == 0]
        extra = max(0, neighbor_num - 1)
        if candidates and extra:
            picks = rng.choice(candidates, size=min(extra, len(candidates)), replace=False)
            for j in picks:
                A[i, j] = 1.0
    return A / A.sum(axis=1, keepdims=True)


def column_stochastic(W: np.ndarray) -> np.ndarray:
    """Renormalize a nonnegative mixing matrix so each column sums to 1.

    PushSum requires column stochasticity: each source node's pushed mass
    totals 1, so the weight column ``w' = W @ w`` evolves away from all-ones
    and the de-biased ratio ``x / w`` converges to the *uniform* average on a
    directed graph (row-stochastic W instead converges to the stationary-
    distribution-weighted consensus).  Self-loops guarantee every column has a
    nonzero entry.
    """
    col = W.sum(axis=0, keepdims=True)
    return (W / np.where(col == 0, 1.0, col)).astype(np.float32)


def fully_connected(n: int) -> np.ndarray:
    return np.full((n, n), 1.0 / n, dtype=np.float32)
