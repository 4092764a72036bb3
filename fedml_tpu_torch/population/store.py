"""Sharded client store: per-client data and state on disk, cohorts in RAM.

The port's copy of ``fedml_tpu/population/store.py`` (host numpy).  The
in-memory simulator holds every client's padded shard on the device, so its
footprint grows with the population; a round only touches its cohort, so
the store keeps the population on disk and the cohort in memory.

Layout: the ``n_clients`` ids are cut into shards of ``shard_size``
contiguous ids (shard ``s`` holds ``[s * shard_size, min((s + 1) *
shard_size, n))``).  A shard is one ``.npz`` file, ``shard_{s:06d}.npz``,
holding the stacked padded rows ``x`` and ``y``, the true sample counts
``counts`` and, when the algorithm keeps per-client state, one stacked
array a state leaf, ``state_{i}``, its leaves in the reference's order
(sorted keys at every level).  The files hold the same arrays under the
same names as the reference's, so either package reads a store the other
wrote.  A bounded LRU keeps at most ``max_resident`` shards in memory.

A shard is written the first time it is touched, from ``builder(lo, hi)
-> (x, y, counts)``, so a million-client population costs disk in
proportion to the ids sampled.  Rewrites are atomic (a temporary file, then
a rename).  State is mutable: :meth:`ShardedClientStore.gather_state` reads
the cohort's rows, :meth:`~ShardedClientStore.scatter_state` writes the new
rows into the resident shards and marks them dirty; a dirty shard is
rewritten when it is evicted and at :meth:`~ShardedClientStore.flush`.
Data rows never change, so a prefetch thread can gather the next cohort's
data while a round writes state.

The reference's registry counters wait for the port's observability slice
(``ROADMAP.md`` Queue 1 item 10); until then the store counts on plain
attributes: ``hits`` and ``misses`` (shard lookups served from the LRU or
loaded / built), ``gather_s`` and ``scatter_s`` (summed wall seconds) and
``resident`` (shards in memory).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

import numpy as np

from ..core import pytree as pt

__all__ = ["StoreSpec", "CohortBatch", "ShardedClientStore", "cyclic_builder"]


@dataclass(frozen=True)
class StoreSpec:
    """Static shape of the population: how many clients, how their padded
    data rows look, and how the id space is cut into shards."""

    n_clients: int
    capacity: int           # padded samples per client (stack_clients semantics)
    x_shape: tuple          # per-sample feature shape
    x_dtype: str
    y_shape: tuple          # per-sample label shape (() for class ids)
    y_dtype: str
    shard_size: int

    @property
    def n_shards(self) -> int:
        return -(-self.n_clients // self.shard_size)

    def shard_range(self, sidx: int) -> tuple[int, int]:
        lo = sidx * self.shard_size
        return lo, min(lo + self.shard_size, self.n_clients)


@dataclass
class CohortBatch:
    """The cohort's stacked arrays in sampled-id order."""

    ids: np.ndarray      # (m,) int32
    x: np.ndarray        # (m, capacity, *x_shape)
    y: np.ndarray        # (m, capacity, *y_shape)
    counts: np.ndarray   # (m,) int32 true sample counts


def cyclic_builder(base_x: np.ndarray, base_y: np.ndarray, base_counts: np.ndarray
                   ) -> Callable[[int, int], tuple]:
    """A builder that replicates a small base client stack cyclically:
    population client ``i`` carries base client ``i % n_base``'s rows."""
    n_base = base_x.shape[0]

    def build(lo: int, hi: int):
        rows = np.arange(lo, hi) % n_base
        return base_x[rows], base_y[rows], base_counts[rows]

    return build


def _host_leaves(tree) -> list:
    """A state tree's leaves in the reference's order, as numpy arrays (a
    tensor comes to the host)."""
    out = []
    for leaf in pt.tree_leaves(tree):
        if hasattr(leaf, "detach"):
            leaf = leaf.detach().cpu().numpy()
        out.append(np.asarray(leaf))
    return out


class _Shard:
    """One resident shard: its arrays and a dirty bit for state writes."""

    __slots__ = ("arrays", "dirty")

    def __init__(self, arrays: dict):
        self.arrays = arrays
        self.dirty = False


class ShardedClientStore:
    """Disk-backed, LRU-cached per-client data and state (module docstring).

    ``state_template`` is one client's state, a tree (nested dicts) of
    numpy arrays, or None for an algorithm without client state.  Every
    change to the resident map happens under one lock: the prefetch thread
    gathers while the round's thread scatters."""

    _STATE_PREFIX = "state_"

    def __init__(self, root, spec: StoreSpec,
                 builder: Optional[Callable[[int, int], tuple]] = None,
                 state_template=None, max_resident: int = 8):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.spec = spec
        self.builder = builder
        self.max_resident = max(1, int(max_resident))
        self._lock = threading.Lock()
        self._resident: OrderedDict[int, _Shard] = OrderedDict()
        if state_template is not None:
            self._state_leaves = _host_leaves(state_template)
            self._state_template = state_template
        else:
            self._state_leaves = None
            self._state_template = None
        self.hits = 0
        self.misses = 0
        self.gather_s = 0.0
        self.scatter_s = 0.0

    @property
    def resident(self) -> int:
        return len(self._resident)

    # -- shard residency ------------------------------------------------------
    def _shard_path(self, sidx: int) -> Path:
        return self.root / f"shard_{sidx:06d}.npz"

    def _materialize(self, sidx: int) -> dict:
        lo, hi = self.spec.shard_range(sidx)
        if self.builder is None:
            raise FileNotFoundError(
                f"shard {sidx} ({self._shard_path(sidx)}) missing and the "
                "store has no builder to materialize it")
        x, y, counts = self.builder(lo, hi)
        arrays = {
            "x": np.ascontiguousarray(x),
            "y": np.ascontiguousarray(y),
            "counts": np.asarray(counts, np.int32),
        }
        if self._state_leaves is not None:
            n = hi - lo
            for i, leaf in enumerate(self._state_leaves):
                arrays[f"{self._STATE_PREFIX}{i}"] = np.broadcast_to(
                    leaf[None], (n,) + leaf.shape).copy()
        return arrays

    def _get_shard_locked(self, sidx: int) -> _Shard:
        """The resident shard ``sidx``, loaded or built first (the caller
        holds the lock)."""
        shard = self._resident.get(sidx)
        if shard is not None:
            self._resident.move_to_end(sidx)
            self.hits += 1
            return shard
        self.misses += 1
        path = self._shard_path(sidx)
        if path.exists():
            with np.load(path) as z:
                arrays = {k: z[k] for k in z.files}
        else:
            arrays = self._materialize(sidx)
            self._write_shard(sidx, arrays)
        shard = _Shard(arrays)
        self._resident[sidx] = shard
        while len(self._resident) > self.max_resident:
            old_idx, old = self._resident.popitem(last=False)
            if old.dirty:
                self._write_shard(old_idx, old.arrays)
        return shard

    def _write_shard(self, sidx: int, arrays: dict) -> None:
        # atomic replace: a crash mid-save leaves no truncated npz behind
        path = self._shard_path(sidx)
        tmp = path.with_suffix(".npz.tmp")
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        tmp.replace(path)

    @staticmethod
    def _group_by_shard(ids: np.ndarray, shard_size: int):
        """``[(shard index, positions into ids, rows within the shard)]``:
        one disk or LRU touch a distinct shard, whatever the cohort's
        order."""
        ids = np.asarray(ids, np.int64)
        if ids.size == 0:
            return []
        sidx = ids // shard_size
        order = np.argsort(sidx, kind="stable")
        cuts = np.flatnonzero(np.diff(sidx[order])) + 1
        out = []
        for pos in np.split(order, cuts):
            s = int(sidx[pos[0]])
            out.append((s, pos, ids[pos] - s * shard_size))
        return out

    # -- cohort API -----------------------------------------------------------
    def gather_cohort(self, ids) -> CohortBatch:
        """The stacked ``(m, capacity, ...)`` data rows of ``ids``, in the
        order given."""
        t0 = time.perf_counter()
        ids = np.asarray(ids, np.int32)
        m = len(ids)
        spec = self.spec
        x = np.empty((m, spec.capacity) + tuple(spec.x_shape), spec.x_dtype)
        y = np.empty((m, spec.capacity) + tuple(spec.y_shape), spec.y_dtype)
        counts = np.empty((m,), np.int32)
        with self._lock:
            for sidx, pos, rows in self._group_by_shard(ids, spec.shard_size):
                arrays = self._get_shard_locked(sidx).arrays
                x[pos] = arrays["x"][rows]
                y[pos] = arrays["y"][rows]
                counts[pos] = arrays["counts"][rows]
            self.gather_s += time.perf_counter() - t0
        return CohortBatch(ids=ids, x=x, y=y, counts=counts)

    def gather_state(self, ids):
        """The stacked per-client state tree of ``ids`` (numpy), or None for
        a store without state.  Apart from :meth:`gather_cohort` so that the
        prefetch thread gathers the immutable data while the round before
        is still scattering state."""
        if self._state_leaves is None:
            return None
        t0 = time.perf_counter()
        ids = np.asarray(ids, np.int32)
        m = len(ids)
        stacked = [np.empty((m,) + leaf.shape, leaf.dtype) for leaf in self._state_leaves]
        with self._lock:
            for sidx, pos, rows in self._group_by_shard(ids, self.spec.shard_size):
                arrays = self._get_shard_locked(sidx).arrays
                for i in range(len(stacked)):
                    stacked[i][pos] = arrays[f"{self._STATE_PREFIX}{i}"][rows]
            self.gather_s += time.perf_counter() - t0
        return pt.tree_unflatten_like(self._state_template, stacked)

    def scatter_state(self, ids, state) -> None:
        """Write the new state rows of ``ids`` (a stacked tree of numpy
        arrays or tensors, the template's structure) into their resident
        shards and mark them dirty."""
        if self._state_leaves is None:
            return
        t0 = time.perf_counter()
        ids = np.asarray(ids, np.int32)
        leaves = _host_leaves(state)
        with self._lock:
            for sidx, pos, rows in self._group_by_shard(ids, self.spec.shard_size):
                shard = self._get_shard_locked(sidx)
                for i, leaf in enumerate(leaves):
                    arr = shard.arrays[f"{self._STATE_PREFIX}{i}"]
                    if not arr.flags.writeable:  # a fresh np.load may be read-only
                        arr = arr.copy()
                        shard.arrays[f"{self._STATE_PREFIX}{i}"] = arr
                    arr[rows] = leaf[pos]
                shard.dirty = True
            self.scatter_s += time.perf_counter() - t0

    def flush(self) -> None:
        """Write every dirty resident shard (a checkpoint boundary, close)."""
        with self._lock:
            for sidx, shard in self._resident.items():
                if shard.dirty:
                    self._write_shard(sidx, shard.arrays)
                    shard.dirty = False

    def disk_bytes(self) -> int:
        """Bytes of the shard files on disk."""
        return sum(p.stat().st_size for p in self.root.glob("shard_*.npz"))
