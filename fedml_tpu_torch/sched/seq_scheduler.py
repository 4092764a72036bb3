"""Runtime fit and min-makespan workload scheduling (host numpy).

The port's copy of ``fedml_tpu/sched/seq_scheduler.py``, bitwise, and of
``round_robin_groups`` from ``fedml_tpu/cross_silo/edge.py``:

- :func:`fit_linear_runtime` and :class:`RuntimeEstimator`: least-squares
  fits ``t = a * n + b`` of observed runtimes, one a device or shared;
- :class:`SeqTrainScheduler`: the assignment of client workloads to
  devices that minimises the makespan, ``cost_fns[d](n)`` a device's
  runtime for ``n`` samples (the identity by default).
  :meth:`~SeqTrainScheduler.schedule_lpt` is longest processing time first
  and a local search of moves off the most loaded device;
  :meth:`~SeqTrainScheduler.schedule_exact` a branch and bound with the
  LPT schedule as its incumbent and symmetry pruning over equal loads;
  :meth:`~SeqTrainScheduler.schedule` the exact search for 12 clients or
  fewer, LPT beyond;
- :func:`balanced_client_order`: an order of clients whose consecutive
  groups carry about equal sample mass;
- :func:`round_robin_groups`: the ``arange(n) % G`` member-to-group map.

``group_assignment: balanced`` in the hierarchical simulator assigns
clients to groups with :meth:`~SeqTrainScheduler.schedule_lpt` over their
sample counts.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np


def fit_linear_runtime(samples: Sequence[float], runtimes: Sequence[float]):
    """Least-squares fit t ~= a*n + b.  Returns (cost_fn, (a, b), rel_error)
    — reference ``linear_fit`` (runtime_estimate.py:4)."""
    x = np.asarray(samples, dtype=np.float64)
    y = np.asarray(runtimes, dtype=np.float64)
    if len(x) < 2 or np.allclose(x, x[0]):
        a, b = 0.0, float(y.mean()) if len(y) else 0.0
    else:
        a, b = np.polyfit(x, y, 1)
    pred = a * x + b
    rel_err = float(np.mean(np.abs(pred - y) / np.maximum(np.abs(y), 1e-12))) if len(y) else 0.0
    return (lambda n: max(float(a) * float(n) + float(b), 0.0)), (float(a), float(b)), rel_err


class RuntimeEstimator:
    """Accumulates observed (device, client, n_samples, runtime) tuples and
    fits per-device linear cost models — reference ``t_sample_fit``."""

    def __init__(self, uniform_devices: bool = True):
        self.uniform_devices = uniform_devices
        self._obs: dict[int, list[tuple[float, float]]] = {}

    def record(self, device_id: int, n_samples: float, runtime_s: float) -> None:
        key = 0 if self.uniform_devices else int(device_id)
        self._obs.setdefault(key, []).append((float(n_samples), float(runtime_s)))

    def cost_fns(self, n_devices: int):
        """One cost fn per device (shared when uniform).  Devices with no
        observations fall back to t = n (sample-count-proportional)."""
        fns, errs = [], []
        for d in range(n_devices):
            key = 0 if self.uniform_devices else d
            obs = self._obs.get(key, [])
            if obs:
                fn, _, err = fit_linear_runtime([o[0] for o in obs], [o[1] for o in obs])
            else:
                fn, err = (lambda n: float(n)), 0.0
            fns.append(fn)
            errs.append(err)
        return fns, errs


@dataclass
class Schedule:
    assignment: list[list[int]]  # per-device client-index lists
    loads: np.ndarray            # per-device total cost
    makespan: float
    iterations: int = 0


class SeqTrainScheduler:
    """Min-makespan assignment of client workloads to devices.

    ``workloads[i]`` is client i's sample count; ``cost_fns[d](n)`` that
    device's estimated runtime for n samples (default: identity).
    """

    def __init__(self, workloads: Sequence[float], n_devices: int,
                 cost_fns: Optional[Sequence[Callable[[float], float]]] = None):
        self.workloads = np.asarray(workloads, dtype=np.float64)
        self.n_devices = int(n_devices)
        if cost_fns is None:
            cost_fns = [lambda n: float(n)] * self.n_devices
        assert len(cost_fns) == self.n_devices
        self.cost_fns = list(cost_fns)
        # per-(device, client) cost matrix
        self.costs = np.array(
            [[fn(w) for w in self.workloads] for fn in self.cost_fns], dtype=np.float64
        )

    # -- solvers -------------------------------------------------------------
    def schedule_lpt(self) -> Schedule:
        """Longest-processing-time-first greedy + pairwise-move/swap local
        search."""
        order = np.argsort(-self.workloads, kind="stable")
        assignment: list[list[int]] = [[] for _ in range(self.n_devices)]
        loads = np.zeros(self.n_devices)
        iters = 0
        for ci in order:
            # place on the device whose load after placement is smallest
            after = loads + self.costs[:, ci]
            d = int(np.argmin(after))
            assignment[d].append(int(ci))
            loads[d] = after[d]
            iters += 1
        # local search: move/swap between the max-loaded device and others
        improved = True
        while improved:
            improved = False
            worst = int(np.argmax(loads))
            for ci in list(assignment[worst]):
                for d in range(self.n_devices):
                    if d == worst:
                        continue
                    new_worst = loads[worst] - self.costs[worst, ci]
                    new_d = loads[d] + self.costs[d, ci]
                    if max(new_worst, new_d) + 1e-12 < loads.max():
                        assignment[worst].remove(ci)
                        assignment[d].append(ci)
                        loads[worst] = new_worst
                        loads[d] = new_d
                        improved = True
                        iters += 1
                        break
                if improved:
                    break
        return Schedule(assignment, loads, float(loads.max()), iters)

    def schedule_exact(self) -> Schedule:
        """Branch-and-bound exact min-makespan (small n only) — the
        reference's search, with the LPT solution as the incumbent bound."""
        n = len(self.workloads)
        assert n <= 14, "exact search is exponential; use schedule_lpt()"
        best = self.schedule_lpt()
        best_makespan = best.makespan
        best_assign = [list(a) for a in best.assignment]
        order = np.argsort(-self.workloads, kind="stable")
        loads = np.zeros(self.n_devices)
        assign: list[list[int]] = [[] for _ in range(self.n_devices)]
        iters = 0

        def rec(k: int):
            nonlocal best_makespan, best_assign, iters
            if k == n:
                if loads.max() < best_makespan - 1e-12:
                    best_makespan = float(loads.max())
                    best_assign = [list(a) for a in assign]
                return
            ci = int(order[k])
            seen_loads = set()
            for d in range(self.n_devices):
                if loads[d] in seen_loads:  # symmetry pruning
                    continue
                seen_loads.add(loads[d])
                c = self.costs[d, ci]
                if loads[d] + c >= best_makespan - 1e-12:
                    continue  # bound
                loads[d] += c
                assign[d].append(ci)
                iters += 1
                rec(k + 1)
                assign[d].pop()
                loads[d] -= c
        rec(0)
        final_loads = np.zeros(self.n_devices)
        for d, members in enumerate(best_assign):
            for ci in members:
                final_loads[d] += self.costs[d, ci]
        return Schedule(best_assign, final_loads, best_makespan, iters)

    def schedule(self) -> Schedule:
        if len(self.workloads) <= 12:
            return self.schedule_exact()
        return self.schedule_lpt()


def balanced_client_order(sample_counts: np.ndarray, n_shards: int) -> np.ndarray:
    """Order sampled clients so that consecutive groups of m/n_shards land on
    mesh shards with balanced total samples (the mesh engine lays stacked
    clients out contiguously per device).

    Returns a permutation of arange(len(sample_counts)).  Groups are padded
    round-robin when len % n_shards != 0.
    """
    counts = np.asarray(sample_counts, dtype=np.float64)
    m = len(counts)
    sched = SeqTrainScheduler(counts, n_shards).schedule_lpt()
    per = -(-m // n_shards)
    order: list[int] = []
    # round-robin drain so every group has exactly `per` members (pad from
    # the least-loaded groups' tails)
    pools = [list(a) for a in sched.assignment]
    for d in range(n_shards):
        while len(pools[d]) < per:
            donor = int(np.argmax([len(p) for p in pools]))
            if donor == d or len(pools[donor]) <= per - 1:
                break
            pools[d].append(pools[donor].pop())
    for p in pools:
        order.extend(p[:per])
    seen = set(order)
    order.extend([i for i in range(m) if i not in seen])
    return np.asarray(order[:m], dtype=np.int64)


def round_robin_groups(n: int, groups: int) -> np.ndarray:
    """``(n,) int32`` member -> group map, round-robin: ``arange(n) % G``."""
    return (np.arange(int(n)) % max(1, int(groups))).astype(np.int32)
