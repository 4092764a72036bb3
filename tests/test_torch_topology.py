"""Port parity: the decentralized topologies (``fedml_tpu_torch/parallel/
topology.py``) and the workload scheduler (``sched/seq_scheduler.py``)
against ``fedml_tpu/parallel/topology.py`` and ``fedml_tpu/sched/
seq_scheduler.py``.

Both are host numpy and held bitwise: every topology over sizes and seeds
(values, dtype), the runtime fits, the LPT and exact schedules'
assignments, loads, makespans and iteration counts, the exact search
against brute force (as ``tests/test_seq_scheduler.py`` holds the
reference), and ``balanced_client_order``.
"""

import itertools

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()  # bitwise, NaN too (a 1-node directed ring)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 17, 64])
def test_topologies_bitwise(n):
    from fedml_tpu.parallel import topology as ref
    from fedml_tpu_torch.parallel import topology as topo

    _same(topo.ring_topology(n), ref.ring_topology(n))
    _same(topo.ring_topology(n, symmetric=False), ref.ring_topology(n, symmetric=False))
    _same(topo.fully_connected(n), ref.fully_connected(n))
    for seed, k in itertools.product((0, 1, 7), (1, 2, 3, 5)):
        _same(topo.symmetric_topology(n, k, seed=seed), ref.symmetric_topology(n, k, seed=seed))
        a = topo.asymmetric_topology(n, k, seed=seed)
        _same(a, ref.asymmetric_topology(n, k, seed=seed))
        _same(topo.column_stochastic(a), ref.column_stochastic(a))


def test_runtime_fits_bitwise():
    from fedml_tpu.sched import seq_scheduler as ref
    from fedml_tpu_torch.sched import seq_scheduler as port

    rs = np.random.RandomState(3)
    x = rs.randint(10, 500, size=12).astype(float)
    y = 0.02 * x + 1.5 + rs.rand(12) * 0.1
    for xs, ys in ((x, y), ([5.0, 5.0], [1.0, 2.0]), ([3.0], [0.5]), ([], [])):
        fa, ca, ea = port.fit_linear_runtime(xs, ys)
        fb, cb, eb = ref.fit_linear_runtime(xs, ys)
        assert ca == cb and ea == eb
        assert [fa(n) for n in (0, 7, 300)] == [fb(n) for n in (0, 7, 300)]
    for uniform in (True, False):
        est, rest = port.RuntimeEstimator(uniform), ref.RuntimeEstimator(uniform)
        for i in range(9):
            for e in (est, rest):
                e.record(i % 3, x[i], y[i])
        fns, errs = est.cost_fns(4)
        rfns, rerrs = rest.cost_fns(4)
        assert errs == rerrs
        assert [f(123.0) for f in fns] == [f(123.0) for f in rfns]


def _brute_force(costs):
    """The least makespan over every assignment (``costs[d, i]``)."""
    n_dev, n = costs.shape
    best = np.inf
    for assign in itertools.product(range(n_dev), repeat=n):
        loads = np.zeros(n_dev)
        for i, d in enumerate(assign):
            loads[d] += costs[d, i]
        best = min(best, loads.max())
    return best


@pytest.mark.parametrize("seed", range(6))
def test_schedules_bitwise_and_exact_is_optimal(seed):
    """LPT, exact and ``schedule()`` on ragged workloads with ties and with
    per-device linear costs: both packages bitwise.  With identical devices
    the exact makespan is brute force's, never worse than LPT's; with
    per-device costs only bitwise: the reference's symmetry pruning skips a
    device whose load equals one already tried, which is exact only when
    the devices cost the same (seed 5 misses brute force's 111.08 with
    113.89 in both packages)."""
    from fedml_tpu.sched import seq_scheduler as ref
    from fedml_tpu_torch.sched import seq_scheduler as port

    rs = np.random.RandomState(seed)
    n, d = int(rs.randint(3, 9)), int(rs.randint(2, 4))
    work = rs.randint(1, 60, size=n).astype(np.float64)
    work[rs.rand(n) < 0.3] = work[0]  # ties
    a_s, b_s = rs.rand(d) + 0.5, rs.rand(d)
    cost = [lambda x, a=a, b=b: a * x + b for a, b in zip(a_s, b_s)]
    for fns in (None, cost):
        got_s, want_s = port.SeqTrainScheduler(work, d, fns), ref.SeqTrainScheduler(work, d, fns)
        _same(got_s.costs, want_s.costs)
        for method in ("schedule_lpt", "schedule_exact", "schedule"):
            got, want = getattr(got_s, method)(), getattr(want_s, method)()
            assert got.assignment == want.assignment, method
            assert got.iterations == want.iterations and got.makespan == want.makespan
            _same(got.loads, want.loads)
        exact = got_s.schedule_exact()
        assert exact.makespan <= got_s.schedule_lpt().makespan + 1e-12
        if fns is None:
            assert exact.makespan == pytest.approx(_brute_force(got_s.costs), rel=1e-12)


@pytest.mark.parametrize("m,shards", [(16, 4), (13, 5), (40, 7), (3, 4), (8, 1)])
def test_balanced_client_order_bitwise(m, shards):
    from fedml_tpu.sched.seq_scheduler import balanced_client_order as ref_order
    from fedml_tpu_torch.sched.seq_scheduler import balanced_client_order

    counts = np.random.RandomState(m).randint(1, 3000, size=m)
    got = balanced_client_order(counts, shards)
    _same(got, ref_order(counts, shards))
    assert sorted(got.tolist()) == list(range(m))
