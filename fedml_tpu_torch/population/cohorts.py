"""Streamed cohort execution: a one-deep prefetch of cohort data.

The port's copy of ``fedml_tpu/population/cohorts.py``.  A population
round ``r``::

    ids      = sampler.sample(r)                    (host, deterministic)
    batch    = store.gather_cohort(ids)             (host, disk / LRU)
    state    = store.gather_state(ids)              (host; mutable rows)
    outputs  = the lane round on the card
    store.scatter_state(ids, outputs' state)        (host)

While round ``r`` runs, a worker thread gathers round ``r + 1``'s data
rows, which never change.  Client state is gathered on the round's own
thread after the previous round's scatter, so a client sampled in two
rounds in a row trains from its newest state.

The reference's registry gauges wait for the port's observability slice
(``ROADMAP.md`` Queue 1 item 10); the pipeline keeps the overlap as plain
attributes: ``last_overlap`` (the share of the last gather hidden behind
the round before: 1 fully hidden, 0 the round waited for all of it, as
round 0 does) and :meth:`CohortPipeline.overlap_mean`.
"""

from __future__ import annotations

import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

import numpy as np

from .sampler import HierarchicalCohortSampler
from .store import ShardedClientStore

__all__ = ["CohortPipeline"]


class CohortPipeline:
    """The sampler and store pair and the one-deep data prefetch.

    ``_pending`` and the overlap fields belong to the round's thread
    (:meth:`prefetch_round`, :meth:`obtain`, :meth:`close`); the worker runs
    :meth:`_gather_job`, which reaches shared state only through the
    store's lock and the sampler (no mutable state after construction)."""

    def __init__(self, store: ShardedClientStore,
                 sampler: HierarchicalCohortSampler, prefetch: bool = True):
        self.store = store
        self.sampler = sampler
        self.prefetch = bool(prefetch)
        self._pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="fedml-pop-prefetch"
        ) if self.prefetch else None
        self._pending: dict[int, Future] = {}
        self._overlap_sum = 0.0
        self._overlap_n = 0
        self.last_overlap: Optional[float] = None

    # -- gather side ----------------------------------------------------------
    def _gather_job(self, round_idx: int):
        t0 = time.perf_counter()
        ids = self.sampler.sample(round_idx)
        batch = self.store.gather_cohort(ids)
        return ids, batch, time.perf_counter() - t0

    def prefetch_round(self, round_idx: int) -> None:
        """Queue round ``round_idx``'s data gather on the worker thread
        (nothing when it is queued already or prefetch is off)."""
        if self._pool is not None and round_idx not in self._pending:
            self._pending[round_idx] = self._pool.submit(self._gather_job, round_idx)

    def obtain(self, round_idx: int):
        """The round's ``(ids, CohortBatch)``; waits only for what the
        prefetch did not hide, and records that share."""
        fut = self._pending.pop(round_idx, None)
        t0 = time.perf_counter()
        if fut is None:
            ids, batch, gather_s = self._gather_job(round_idx)
        else:
            ids, batch, gather_s = fut.result()
        waited = time.perf_counter() - t0
        overlap = 1.0 - min(1.0, waited / gather_s) if gather_s > 0 else 1.0
        self.last_overlap = overlap
        self._overlap_sum += overlap
        self._overlap_n += 1
        return ids, batch

    # -- bookkeeping ----------------------------------------------------------
    def overlap_mean(self) -> Optional[float]:
        return self._overlap_sum / self._overlap_n if self._overlap_n else None

    def close(self) -> None:
        self.store.flush()
        if self._pool is not None:
            # drop gathers that will never be read, then join the worker
            for fut in self._pending.values():
                fut.cancel()
            self._pending.clear()
            self._pool.shutdown(wait=True)

    @staticmethod
    def pad_ids(ids: np.ndarray, m_pad: int) -> np.ndarray:
        """The cohort's ids extended to ``m_pad`` lanes by repeating the
        first id (the reference pads to its mesh's lane multiple; one card
        is a multiple of 1, so the port's rounds never pad)."""
        m = len(ids)
        if m_pad == m:
            return ids
        return np.concatenate([ids, np.full(m_pad - m, ids[0], np.int32)])
