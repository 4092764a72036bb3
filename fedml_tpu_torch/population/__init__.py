"""Population-scale clients: a million-client cross-device simulation.

The port of ``fedml_tpu/population/`` (host numpy), composed by the
``MeshSimulator`` behind ``extra.population_store``:

- :mod:`.store`: sharded on-disk client data and mutable per-client state
  with a bounded resident LRU (host memory grows with the cohort, not the
  population);
- :mod:`.sampler`: deterministic two-level (shard, then within the shard)
  cohort sampling;
- :mod:`.cohorts`: the one-deep prefetch that gathers cohort ``k + 1``'s
  data while cohort ``k`` trains.

:func:`build_population_components` assembles them from a config: the
base dataset's stacked client rows seed a ``population_size``-client store
by cyclic replication, so a 128-client recipe stands in for a million ids.
"""

from __future__ import annotations

from ..core.flags import cfg_extra
from .cohorts import CohortPipeline
from .sampler import HierarchicalCohortSampler
from .store import CohortBatch, ShardedClientStore, StoreSpec, cyclic_builder

__all__ = [
    "CohortBatch", "CohortPipeline", "HierarchicalCohortSampler",
    "ShardedClientStore", "StoreSpec", "cyclic_builder",
    "build_population_components",
]


def build_population_components(cfg, root: str, base_x, base_y, base_counts, capacity: int,
                                state_template=None):
    """``(store, sampler, pipeline)`` for a config and a base client stack
    (reference ``build_population_components``).

    ``base_*`` are the real clients' padded rows (``stack_clients``);
    population ids past the base replicate them cyclically.
    ``state_template`` is one client's state as numpy arrays in the
    reference's layout (or None)."""
    n_base = int(base_x.shape[0])
    n_pop = int(cfg_extra(cfg, "population_size", n_base) or n_base)
    if n_pop < n_base:
        raise ValueError(
            f"population_size ({n_pop}) smaller than the base dataset's "
            f"client count ({n_base}) — shrink the dataset instead")
    shard_size = int(cfg_extra(cfg, "population_shard_size"))
    spec = StoreSpec(
        n_clients=n_pop,
        capacity=int(capacity),
        x_shape=tuple(base_x.shape[2:]),
        x_dtype=str(base_x.dtype),
        y_shape=tuple(base_y.shape[2:]),
        y_dtype=str(base_y.dtype),
        shard_size=shard_size,
    )
    store = ShardedClientStore(
        root, spec,
        builder=cyclic_builder(base_x, base_y, base_counts),
        state_template=state_template,
        max_resident=int(cfg_extra(cfg, "population_max_resident_shards")),
    )
    m = min(int(cfg.client_num_per_round), n_pop)
    spc = cfg_extra(cfg, "population_shards_per_cohort")
    sampler = HierarchicalCohortSampler(
        n_pop, m, shard_size, seed=int(cfg.random_seed),
        shards_per_cohort=int(spc) if spc else None)
    pipeline = CohortPipeline(
        store, sampler, prefetch=bool(cfg_extra(cfg, "population_prefetch")))
    return store, sampler, pipeline
