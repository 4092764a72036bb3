"""RNG discipline, with torch generators in place of ``jax.random`` keys.

The JAX package derives every random stream by pure key folding
(``fedml_tpu/core/rng.py``)::

    root key  --fold(round)--> round key --fold(tag, client)--> client key

Here a key is a tuple of ints and folding appends to it.  A key becomes a
seeded ``torch.Generator`` through ``np.random.SeedSequence``, a fixed, pure
mixing of the whole tuple, so every (seed, round, tag, client) stream is
reproducible and independent of the order clients run in.  The bits differ
from threefry's; tests that compare with the JAX package inject the
reference's sampled ids and permutations instead (``sim.engine``'s sampler
hook).
"""

from __future__ import annotations

import random

import numpy as np
import torch

Key = tuple

# offset tag of the client fold (the JAX package folds 0x636C69, "cli")
_CLIENT_TAG = 0x636C69
# tag of the model-init stream ("init"): no round or client key can equal it
_INIT_TAG = 0x696E6974


def root_key(seed: int) -> Key:
    return (int(seed),)


def init_key(key: Key) -> Key:
    return key + (_INIT_TAG,)


def round_key(key: Key, round_idx: int) -> Key:
    return key + (int(round_idx),)


def client_key(key: Key, client_idx: int) -> Key:
    # disjoint stream per client: the tag keeps client_key(round_key(k, r), c)
    # apart from any round_key(k, r')
    return key + (_CLIENT_TAG, int(client_idx))


def fold_in(key: Key, data: int) -> Key:
    return key + (int(data),)


def generator(key: Key, device="cpu") -> torch.Generator:
    """A ``torch.Generator`` seeded by a pure mixing of ``key``."""
    words = [w & 0xFFFFFFFF for w in key]
    seed = int(np.random.SeedSequence(words).generate_state(1, dtype=np.uint64)[0])
    g = torch.Generator(device=device)
    g.manual_seed(seed & 0x7FFFFFFFFFFFFFFF)
    return g


def permutation(key: Key, n: int) -> torch.Tensor:
    """A permutation of ``range(n)`` drawn on the CPU from ``key``."""
    return torch.randperm(n, generator=generator(key))


def sample_clients(key: Key, round_idx: int, client_num_in_total: int,
                   client_num_per_round: int) -> np.ndarray:
    """Sample a per-round subset of client indices, without replacement.

    The semantics of ``fedml_tpu.core.rng.sample_clients``: everyone when all
    clients fit, else the first ``client_num_per_round`` entries of a
    permutation drawn from the round key."""
    if client_num_in_total <= client_num_per_round:
        return np.arange(client_num_in_total, dtype=np.int64)
    perm = permutation(round_key(key, round_idx), client_num_in_total)
    return perm[:client_num_per_round].numpy().astype(np.int64)


def sample_clients_np(seed_round: int, client_num_in_total: int,
                      client_num_per_round: int) -> np.ndarray:
    """The reference's numpy sampler, bit for bit (``fedml_tpu.core.rng.
    sample_clients_np``): ``RandomState(round).choice(n, m, replace=False)``;
    the cross-silo server selects a round's clients with it."""
    if client_num_in_total == client_num_per_round:
        return np.arange(client_num_in_total, dtype=np.int64)
    rs = np.random.RandomState(seed_round)
    return np.array(rs.choice(range(client_num_in_total), client_num_per_round, replace=False))


def seed_everything(seed: int) -> None:
    """Seed host-side python/numpy RNGs (data partitioning uses its own
    ``RandomState``; device randomness flows through explicit generators)."""
    random.seed(seed)
    np.random.seed(seed)
