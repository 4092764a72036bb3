"""Two-level cohort sampling over a sharded population (host numpy).

The port's copy of ``fedml_tpu/population/sampler.py``, bitwise.  Flat
sampling over a million ids would touch a shard for nearly every id; the
sampler instead draws a round's cohort in two levels:

1. shards: a permutation of the shards a round orders them; the cohort
   comes from the first ``shards_per_cohort`` of them (later shards only
   when those cannot fill their quota), so a cohort touches a bounded
   number of shards and the store's LRU stays small;
2. clients: within a visited shard, ids uniformly without replacement.

The reference's optional eligibility masks (a ``DeviceRegistry``'s
liveness, a ``ClientHealthLedger`` behind ``extra.health_aware_selection``)
wait for the port's device registry and health ledger (``ROADMAP.md``
Queue 1 item 10); the engine refuses that flag in population mode, and
every id is eligible here.

Every draw comes from ``np.random.default_rng([seed, round_idx])``, so a
round's cohort is a pure function of (seed, round).  When the cohort
covers the whole population it is everyone in id order: the in-memory
engine's round, which the population-against-in-memory tests hold.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["HierarchicalCohortSampler"]


class HierarchicalCohortSampler:
    def __init__(self, n_clients: int, cohort_size: int, shard_size: int,
                 seed: int = 0, shards_per_cohort: Optional[int] = None):
        self.n_clients = int(n_clients)
        self.cohort_size = min(int(cohort_size), self.n_clients)
        self.shard_size = int(shard_size)
        self.seed = int(seed)
        self.n_shards = -(-self.n_clients // self.shard_size)
        if shards_per_cohort is None:
            # enough preferred shards that per-shard draws stay under half a
            # shard — keeps within-shard sampling meaningfully random while
            # bounding the store's working set
            shards_per_cohort = max(1, -(-2 * self.cohort_size // self.shard_size))
        self.shards_per_cohort = min(self.n_shards, max(1, int(shards_per_cohort)))

    # -- sampling ------------------------------------------------------------
    def sample(self, round_idx: int) -> np.ndarray:
        """The round's cohort: ``(cohort_size,)`` int32 ids, ascending,
        deterministic in (seed, round_idx)."""
        rng = np.random.default_rng([self.seed, int(round_idx)])
        shard_order = rng.permutation(self.n_shards)
        need = self.cohort_size
        quota = -(-self.cohort_size // self.shards_per_cohort)
        chosen: list[np.ndarray] = []
        leftover: list[np.ndarray] = []  # over quota this pass
        for sidx in shard_order:
            if need <= 0:
                break
            lo = int(sidx) * self.shard_size
            hi = min(lo + self.shard_size, self.n_clients)
            ids = np.arange(lo, hi, dtype=np.int32)
            take = min(quota, need, len(ids))
            picked = rng.choice(ids, size=take, replace=False)
            chosen.append(picked)
            need -= take
            leftover.append(np.setdiff1d(ids, picked))
        if need > 0:
            # every visited shard hit its quota and the cohort is still
            # short (uneven shard sizes): draw the remainder uniformly from
            # the ids the quota pass left behind
            chosen.append(rng.choice(np.concatenate(leftover), size=need, replace=False))
        cohort = np.concatenate(chosen)
        cohort.sort()
        return cohort.astype(np.int32)
