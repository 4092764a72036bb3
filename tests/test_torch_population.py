"""Port parity: the population engine (``fedml_tpu_torch/population/`` and
``sim/engine.py``'s population mode) against ``fedml_tpu/population/`` and
the JAX ``MeshSimulator`` with ``extra.population_store``.

Host numpy, held bitwise: the store's gathers, the arrays and names in
its shard files (either package reads a store the other wrote; the zip
containers carry their own timestamps, so the files are compared array by
array), the LRU's state round trip through eviction, the two-level
sampler's cohorts over rounds and seeds (no liveness or health masks, which
the port refuses), and the prefetch pipeline's cohorts.

The simulator: a full cohort (``population_size`` the base's 8 clients,
all 8 a round) against the port's in-memory round, FedAvg and SCAFFOLD
(client state through a one-shard LRU), bitwise; against the reference's
population run, with its sampled ids and permutations through the sampler
hook and its initial weights, at the reference's own tolerance for
population-against-in-memory (rtol 2e-5 / atol 2e-6,
``tests/test_population.py``), the SCAFFOLD state in the shard files too; a
40-id population of 6-client cohorts against the reference's run, at that
tolerance.  The logistic regression on ``synthetic``, f32.
"""

import jax
import numpy as np
import pytest
import torch

from .test_torch_algorithms import _port_flat
from .test_torch_mesh import JaxSampler, _port_vars

torch.set_num_threads(1)

POP_TOL = dict(rtol=2e-5, atol=2e-6)


def _base(n=16, cap=8, dim=4):
    rs = np.random.RandomState(0)
    return (rs.randn(n, cap, dim).astype(np.float32),
            rs.randint(0, 10, size=(n, cap)).astype(np.int32),
            rs.randint(1, cap + 1, size=n).astype(np.int32))


def _stores(root, n_clients, shard_size=32, max_resident=4, state=True, builder=True):
    """The same store in both packages over the same base rows."""
    from fedml_tpu import population as ref
    from fedml_tpu_torch import population as port

    bx, by, bc = _base()
    out = []
    for pkg, name in ((port, "port"), (ref, "ref")):
        spec = pkg.StoreSpec(n_clients=n_clients, capacity=8, x_shape=(4,), x_dtype="float32",
                             y_shape=(), y_dtype="int32", shard_size=shard_size)
        template = ({"ctrl": np.zeros((4,), np.float32), "a": {"step": np.zeros((), np.int32)}}
                    if state else None)
        out.append(pkg.ShardedClientStore(
            root / name, spec, builder=pkg.cyclic_builder(bx, by, bc) if builder else None,
            state_template=template, max_resident=max_resident))
    return out


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_store_bitwise_and_cross_read(tmp_path):
    """Gathers, scatters and the files bitwise; each package reads the
    other's files with no builder."""
    from fedml_tpu import population as ref
    from fedml_tpu_torch import population as port

    store, ref_store = _stores(tmp_path, 200)
    ids = np.array([5, 130, 7, 64, 199, 6], np.int32)
    a, b = store.gather_cohort(ids), ref_store.gather_cohort(ids)
    for k in ("ids", "x", "y", "counts"):
        got, want = getattr(a, k), getattr(b, k)
        assert got.dtype == want.dtype and np.array_equal(got, want), k
    st, ref_st = store.gather_state(ids), ref_store.gather_state(ids)
    assert sorted(st) == sorted(ref_st)
    new = {"ctrl": st["ctrl"] + np.arange(6, dtype=np.float32)[:, None] + 0.5,
           "a": {"step": st["a"]["step"] + 3}}
    store.scatter_state(ids, new)
    ref_store.scatter_state(ids, new)
    store.flush()
    ref_store.flush()
    files = sorted(p.name for p in (tmp_path / "port").glob("*.npz"))
    assert files == sorted(p.name for p in (tmp_path / "ref").glob("*.npz")) and len(files) == 4
    for name in files:
        got, want = _npz(tmp_path / "port" / name), _npz(tmp_path / "ref" / name)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), (name, k)
    # each package reads the other's files (no builder: disk is the only copy)
    for pkg, root, other in ((port, "ref", store), (ref, "port", ref_store)):
        reader = pkg.ShardedClientStore(tmp_path / root, other.spec, builder=None,
                                        state_template={"ctrl": np.zeros((4,), np.float32),
                                                        "a": {"step": np.zeros((), np.int32)}})
        back = reader.gather_state(ids)
        np.testing.assert_array_equal(back["ctrl"], new["ctrl"])
        np.testing.assert_array_equal(back["a"]["step"], new["a"]["step"])
        np.testing.assert_array_equal(reader.gather_cohort(ids).x, a.x)


def test_store_lru_eviction_round_trips_state(tmp_path):
    """gather -> change -> scatter -> eviction churn through other shards:
    the new rows come back from disk (a second store with no builder reads
    them), and again through the first store's LRU; untouched
    clients keep the template; the LRU never holds more than its bound and
    counts its hits and misses."""
    store, _ = _stores(tmp_path, 256, shard_size=32, max_resident=2)
    ids = np.array([1, 40, 90, 200], np.int32)  # 4 shards > max_resident
    st = store.gather_state(ids)
    st["ctrl"] = st["ctrl"] + np.arange(4, dtype=np.float32)[:, None] + 1.0
    st["a"]["step"] = st["a"]["step"] + 7
    store.scatter_state(ids, st)
    for lo in (224, 128, 160):
        store.gather_cohort(np.arange(lo, lo + 32, dtype=np.int32))
        assert store.resident <= 2
    # shards 4 and 5 are resident now: the four of ``ids`` were evicted,
    # and were written back as they went
    assert store.resident == 2
    reader = type(store)(store.root, store.spec, builder=None,
                         state_template={"ctrl": np.zeros((4,), np.float32),
                                         "a": {"step": np.zeros((), np.int32)}})
    np.testing.assert_array_equal(reader.gather_state(ids)["ctrl"], st["ctrl"])
    back = store.gather_state(ids)
    np.testing.assert_array_equal(back["ctrl"], st["ctrl"])
    np.testing.assert_array_equal(back["a"]["step"], np.full(4, 7, np.int32))
    other = store.gather_state(np.array([2, 41], np.int32))
    np.testing.assert_array_equal(other["ctrl"], np.zeros((2, 4), np.float32))
    hits = store.hits
    store.gather_cohort(np.array([2, 3], np.int32))  # shard 0 is resident now
    assert store.hits == hits + 1 and store.misses > 0
    assert store.gather_s > 0 and store.scatter_s > 0 and store.disk_bytes() > 0


def test_sampler_bitwise():
    """Cohorts over rounds, seeds and shapes: the quota pass, the leftover
    pass, the everyone case (the reference with no liveness registry and no
    health ledger, the port's only case)."""
    from fedml_tpu.population import HierarchicalCohortSampler as Ref
    from fedml_tpu_torch.population import HierarchicalCohortSampler

    shapes = [(10_000, 500, 512, None), (1_000_000, 64, 16, 4), (200, 150, 64, None),
              (64, 64, 16, None), (100, 37, 7, 3), (50, 10, 64, None), (200, 150, 64, 1),
              (20, 19, 8, 3)]  # the last: quotas of 7 leave the cohort 1 short
    for (n, m, shard, spc), seed in zip(shapes * 2, range(16)):
        got_s = HierarchicalCohortSampler(n, m, shard, seed=seed, shards_per_cohort=spc)
        want_s = Ref(n, m, shard, seed=seed, shards_per_cohort=spc)
        assert got_s.shards_per_cohort == want_s.shards_per_cohort
        for r in range(3):
            got, want = got_s.sample(r), want_s.sample(r)
            assert got.dtype == want.dtype and np.array_equal(got, want), (n, m, r)
            assert len(np.unique(got)) == min(m, n)


def test_pipeline_bitwise(tmp_path):
    """The prefetched cohorts of three rounds, round 0 unprefetched, and
    ``pad_ids``."""
    from fedml_tpu import population as ref
    from fedml_tpu_torch import population as port

    store, ref_store = _stores(tmp_path, 300, shard_size=16)
    pipes = [port.CohortPipeline(store, port.HierarchicalCohortSampler(300, 24, 16, seed=5)),
             ref.CohortPipeline(ref_store, ref.HierarchicalCohortSampler(300, 24, 16, seed=5))]
    for r in range(3):
        got = []
        for p in pipes:
            ids, batch = p.obtain(r)
            p.prefetch_round(r + 1)
            got.append((ids, batch))
        (ids, b), (ref_ids, rb) = got
        np.testing.assert_array_equal(ids, ref_ids)
        np.testing.assert_array_equal(b.x, rb.x)
        np.testing.assert_array_equal(b.counts, rb.counts)
    assert pipes[0].overlap_mean() is not None and 0.0 <= pipes[0].last_overlap <= 1.0
    for p in pipes:
        p.close()
    for ids in (np.array([4, 9, 2], np.int32), np.array([7], np.int32)):
        for m_pad in (len(ids), 5):
            np.testing.assert_array_equal(port.CohortPipeline.pad_ids(ids, m_pad),
                                          ref.CohortPipeline.pad_ids(ids, m_pad))


def _cfgs(tmp_path, optimizer, pop=None, **kw):
    import fedml_tpu.arguments as ref_args
    import fedml_tpu_torch.arguments as args

    base = dict(dataset="synthetic", model="lr", client_num_in_total=8, client_num_per_round=8,
                comm_round=2, epochs=1, batch_size=8, learning_rate=0.05,
                synthetic_train_size=120, synthetic_test_size=40, partition_method="hetero",
                partition_alpha=0.5, frequency_of_the_test=0, compute_dtype="float32",
                random_seed=0, backend_sim="MESH", data_cache_dir=str(tmp_path),
                federated_optimizer=optimizer)
    base.update(kw)
    extra = {} if pop is None else {"population_shard_size": 4,
                                    "population_max_resident_shards": 1, **pop}
    return ref_args.Config(**base, extra=extra), args.Config(**base, extra=dict(extra))


def _port_run(cfg, ref_sim=None, init=None):
    import fedml_tpu_torch
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.models import simple
    from fedml_tpu_torch.sim.engine import MeshSimulator

    fedml_tpu_torch.init(cfg)
    ds = loader.load(cfg)
    sampler = None
    if ref_sim is not None:
        n = int(cfg.extra.get("population_size") or ds.n_clients)
        sampler = JaxSampler(ref_sim.root_key, n, min(cfg.client_num_per_round, n))
    sim = MeshSimulator(cfg, ds, simple.LogisticRegression(10, 60), device="cpu",
                        sampler=sampler)
    if init is not None:
        sim.global_vars = pt.tree_map(torch.clone, init)
        sim.server_state = sim.algorithm.init_server_state(sim.global_vars)
    return sim, sim.run()


def _ref_run(ref_cfg):
    import fedml_tpu
    from fedml_tpu.data import loader as ref_loader
    from fedml_tpu.models import simple as flax_simple
    from fedml_tpu.parallel import mesh as meshlib
    from fedml_tpu.sim.engine import MeshSimulator as JaxSim

    fedml_tpu.init(ref_cfg)
    mesh = meshlib.mesh_from_config(ref_cfg, devices=jax.devices()[:1])
    sim = JaxSim(ref_cfg, ref_loader.load(ref_cfg), flax_simple.LogisticRegression(10),
                 mesh=mesh)
    init = _port_vars(sim.global_vars)
    return sim, init, sim.run()


@pytest.mark.parametrize("optimizer", ["FedAvg", "SCAFFOLD"])
def test_full_cohort_population_matches_in_memory_and_the_reference(tmp_path, optimizer):
    """A full cohort: the port's population run bitwise its in-memory run
    (metrics, globals, server state, SCAFFOLD's client state against the
    in-memory stack), and within the reference's tolerance of the
    reference's population run (globals; SCAFFOLD's shard files)."""
    from fedml_tpu_torch.core import pytree as pt

    ref_cfg, _ = _cfgs(tmp_path, optimizer, pop={"population_store": str(tmp_path / "ref")})
    ref_sim, init, ref_hist = _ref_run(ref_cfg)
    assert ref_sim._population is not None
    _, mem_cfg = _cfgs(tmp_path, optimizer)
    mem, mem_hist = _port_run(mem_cfg, ref_sim, init)
    _, cfg = _cfgs(tmp_path, optimizer, pop={"population_store": str(tmp_path / "port")})
    pop, hist = _port_run(cfg, ref_sim, init)
    assert pop._population is not None and pop.client_states is None
    assert [h["train_loss"] for h in hist] == [h["train_loss"] for h in mem_hist]
    for a, b in zip(pt.tree_leaves(pop.global_vars), pt.tree_leaves(mem.global_vars)):
        assert torch.equal(a, b)
    for a, b in zip(pt.tree_leaves(pop.server_state), pt.tree_leaves(mem.server_state)):
        assert torch.equal(a, b) if torch.is_tensor(a) else a == b
    want = _port_flat(_port_vars(ref_sim.global_vars))
    np.testing.assert_allclose(_port_flat(pop.global_vars), want, **POP_TOL)
    assert np.abs(want - _port_flat(init)).max() > 1e-3  # training moved the weights
    for a, b in zip(hist, ref_hist):
        np.testing.assert_allclose(a["train_loss"], b["train_loss"], rtol=1e-5, atol=1e-6)
    if optimizer == "SCAFFOLD":
        from fedml_tpu_torch.sim.engine import _lanes_relayout

        stored = pop._population.store.gather_state(np.arange(8, dtype=np.int32))
        back = _lanes_relayout(pt.tree_map(torch.from_numpy, stored), pt.KERNEL_TO_TORCH)
        for a, b in zip(pt.tree_leaves(back), pt.tree_leaves(mem.client_states)):
            assert torch.equal(a, b)
        for name in sorted(p.name for p in (tmp_path / "ref").glob("*.npz")):
            got, ref_arrays = _npz(tmp_path / "port" / name), _npz(tmp_path / "ref" / name)
            assert list(got) == list(ref_arrays)
            for k in ref_arrays:
                np.testing.assert_allclose(got[k], ref_arrays[k], **POP_TOL, err_msg=k)


def test_sampled_cohorts_of_a_larger_population_match_the_reference(tmp_path):
    """40 ids over the 8 base clients, shards of 8, cohorts of 6: the
    lanes are population ids (each keyed by its own id), the globals within
    the reference's tolerance after 2 rounds, only the touched shards on
    disk."""
    pop = {"population_store": None, "population_size": 40, "population_shard_size": 8,
           "population_max_resident_shards": 2}
    ref_cfg, _ = _cfgs(tmp_path, "FedAvg", pop={**pop, "population_store": str(tmp_path / "r")},
                       client_num_per_round=6)
    ref_sim, init, _ = _ref_run(ref_cfg)
    _, cfg = _cfgs(tmp_path, "FedAvg", pop={**pop, "population_store": str(tmp_path / "p")},
                   client_num_per_round=6)
    sim, hist = _port_run(cfg, ref_sim, init)
    assert [int(h["num_samples"] > 0) for h in hist] == [1, 1]
    np.testing.assert_allclose(_port_flat(sim.global_vars),
                               _port_flat(_port_vars(ref_sim.global_vars)), **POP_TOL)
    assert (sorted(p.name for p in (tmp_path / "p").glob("*.npz"))
            == sorted(p.name for p in (tmp_path / "r").glob("*.npz")))
    assert 0 < len(list((tmp_path / "p").glob("*.npz"))) < 5
    assert sim._population.pipeline.overlap_mean() is not None


def test_population_refusals(tmp_path):
    """``sp`` refuses population mode, as the reference does; so do
    contribution (its replay reads the in-memory stack), the health mask
    (no registry or health ledger in the port yet) and the simulators of
    their own."""
    from fedml_tpu_torch.runner import FedMLRunner

    store = {"population_store": str(tmp_path / "s")}
    for kw, err in ((dict(backend_sim="sp"), ValueError),
                    (dict(enable_contribution=True), NotImplementedError),
                    (dict(extra={"health_aware_selection": True}), NotImplementedError),
                    (dict(federated_optimizer="HierarchicalFL"), NotImplementedError),
                    (dict(federated_optimizer="decentralized_fl"), NotImplementedError),
                    (dict(federated_optimizer="MyAvg"), NotImplementedError)):
        opt = kw.pop("federated_optimizer", "FedAvg")
        _, cfg = _cfgs(tmp_path, opt, pop={**store, **kw.pop("extra", {})}, **kw)
        with pytest.raises(err):
            FedMLRunner(cfg, device="cpu")


def test_cohort_rows_cast_as_ml_dtypes():
    """A cohort's f32 rows reach the compute dtype as the reference's
    ``ml_dtypes`` cast gives them (round to nearest even), bitwise, edge
    values included; labels and state keep their dtype."""
    import types

    import ml_dtypes

    from fedml_tpu_torch.sim.engine import MeshSimulator

    rs = np.random.RandomState(4)
    x = rs.randn(3, 5, 8).astype(np.float32) * np.float32(1e3)
    x.flat[:6] = [0.0, -0.0, np.inf, -np.inf, 1.00390625, 1.01171875]  # ties to even
    stub = types.SimpleNamespace(device=torch.device("cpu"),
                                 hp=types.SimpleNamespace(compute_dtype="bfloat16"))
    got = MeshSimulator._cohort_rows(stub, x)
    want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16), want)
    kept = MeshSimulator._cohort_rows(stub, x, cast=False)
    assert kept.dtype == torch.float32 and np.array_equal(kept.numpy(), x)
