"""Client-to-group assignment (the port's copy of the parts of
``fedml_tpu/sched/seq_scheduler.py`` and ``fedml_tpu/cross_silo/edge.py``
that the hierarchical simulator uses; numpy, bitwise the reference).

- :meth:`SeqTrainScheduler.schedule_lpt` (reference L109): the min-makespan
  assignment of client workloads to devices, longest processing time first
  followed by a pairwise-move local search.  ``group_assignment:
  balanced`` uses it with each client's sample count as its workload, so
  the groups hold about equal sample mass.
- :func:`round_robin_groups` (reference ``cross_silo/edge.py:140``): the
  ``arange(n) % G`` member-to-group map of ``group_assignment:
  round_robin``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np


@dataclass
class Schedule:
    assignment: list[list[int]]  # per-device client-index lists
    loads: np.ndarray            # per-device total cost
    makespan: float
    iterations: int = 0


class SeqTrainScheduler:
    """Min-makespan assignment of client workloads to devices:
    ``workloads[i]`` is client i's sample count, which is also its cost on
    any device (the reference's default cost function)."""

    def __init__(self, workloads: Sequence[float], n_devices: int):
        self.workloads = np.asarray(workloads, dtype=np.float64)
        self.n_devices = int(n_devices)

    def schedule_lpt(self) -> Schedule:
        """Longest processing time first, then moves off the most loaded
        device while one lowers the makespan."""
        w = self.workloads
        order = np.argsort(-w, kind="stable")
        assignment: list[list[int]] = [[] for _ in range(self.n_devices)]
        loads = np.zeros(self.n_devices)
        iters = 0
        for ci in order:
            # the device whose load after placement is smallest
            after = loads + w[ci]
            d = int(np.argmin(after))
            assignment[d].append(int(ci))
            loads[d] = after[d]
            iters += 1
        improved = True
        while improved:
            improved = False
            worst = int(np.argmax(loads))
            for ci in list(assignment[worst]):
                for d in range(self.n_devices):
                    if d == worst:
                        continue
                    new_worst = loads[worst] - w[ci]
                    new_d = loads[d] + w[ci]
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


def round_robin_groups(n: int, groups: int) -> np.ndarray:
    """``(n,) int32`` member -> group map, round-robin: ``arange(n) % G``."""
    return (np.arange(int(n)) % max(1, int(groups))).astype(np.int32)
