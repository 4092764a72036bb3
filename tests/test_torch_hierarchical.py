"""Port parity: the hierarchical simulator (``fedml_tpu_torch/sim/
hierarchical.py``) and its group maps (``sched/seq_scheduler.py``) against
``fedml_tpu/sim/hierarchical.py``, ``fedml_tpu/sched/seq_scheduler.py`` and
``fedml_tpu/cross_silo/edge.py``.

The group maps are host numpy: bitwise.  Two global rounds of both
simulators on an MLP over the ``synthetic`` features, 8 Dirichlet clients
in 2 groups, 2 sub-rounds, both assignment modes, with everyone and with 3
clients a sub-round; the port starts from the reference's initial weights
and takes the reference's sampled ids and permutations through its sampler
hook.  The globals are held within rtol 2e-4 / atol 2e-5 (the reference's
own MESH-vs-SP tolerance, ``tests/test_m0_fedavg.py``), the losses within
rtol 2e-4.  A group none of whose members is sampled keeps its model
bitwise.
"""

import jax
import numpy as np
import pytest
import torch

from .test_torch_mesh import _port_vars

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-5)


class JaxSubSampler:
    """The reference's sub-round randomness as the port's sampler hook:
    sub-round ``s`` of round ``r`` keyed ``fold_in(round_key(root, r), s)``."""

    def __init__(self, root, n_total, per_round):
        self.root, self.n_total, self.per_round = root, n_total, per_round

    def _skey(self, r, s):
        from fedml_tpu.core import rng

        return jax.random.fold_in(rng.round_key(self.root, r), s)

    def sample(self, r, s):
        from fedml_tpu.core import rng

        return np.asarray(rng.sample_clients(self._skey(r, s), s, self.n_total, self.per_round))

    def perms(self, r, s, client, epochs, cap):
        from fedml_tpu.core import rng

        key = rng.client_key(self._skey(r, s), client)
        return torch.from_numpy(np.stack([np.asarray(jax.random.permutation(
            jax.random.fold_in(jax.random.fold_in(key, e), 1), cap)) for e in range(epochs)]))


def _cfgs(tmp_path, **kw):
    import fedml_tpu.arguments as ref_args
    import fedml_tpu_torch.arguments as args

    base = dict(dataset="synthetic", model="mlp", federated_optimizer="HierarchicalFL",
                client_num_in_total=8, client_num_per_round=8, group_num=2, group_comm_round=2,
                comm_round=2, epochs=1, batch_size=8, learning_rate=0.05,
                synthetic_train_size=160, synthetic_test_size=40, partition_method="hetero",
                partition_alpha=0.5, frequency_of_the_test=0, compute_dtype="float32",
                random_seed=0, data_cache_dir=str(tmp_path))
    base.update(kw)
    extra = {"mlp_hidden": 16, **base.pop("extra", {})}
    return ref_args.Config(**base, extra=extra), args.Config(**base, extra=dict(extra))


def _pair(ref_cfg, cfg):
    """(the JAX simulator on one device, the port's from its weights)."""
    import fedml_tpu
    import fedml_tpu_torch
    from fedml_tpu.data import loader as ref_loader
    from fedml_tpu.models import simple as flax_simple
    from fedml_tpu.parallel import mesh as meshlib
    from fedml_tpu.sim.hierarchical import HierarchicalSimulator as JaxHier
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.models import simple
    from fedml_tpu_torch.sim.hierarchical import HierarchicalSimulator

    fedml_tpu.init(ref_cfg)
    ref_ds = ref_loader.load(ref_cfg)
    ref = JaxHier(ref_cfg, ref_ds, flax_simple.MLP(hidden=16, num_classes=10),
                  mesh=meshlib.mesh_from_config(ref_cfg, devices=jax.devices()[:1]))
    fedml_tpu_torch.init(cfg)
    ds = loader.load(cfg)
    sim = HierarchicalSimulator(cfg, ds, simple.MLP(16, 10, 60), device="cpu",
                                sampler=JaxSubSampler(ref.root_key, ds.n_clients,
                                                      min(cfg.client_num_per_round,
                                                          ds.n_clients)))
    sim.global_vars = pt.tree_map(torch.clone, _port_vars(ref.global_vars))
    return ref, sim


def _flat(tree):
    from fedml_tpu_torch.core import pytree as pt

    return np.concatenate([t.numpy().ravel() for t in pt.tree_leaves(tree)])


def test_group_maps_bitwise():
    """``schedule_lpt`` over ragged workloads and ``round_robin_groups``."""
    from fedml_tpu.cross_silo.edge import round_robin_groups as ref_rr
    from fedml_tpu.sched.seq_scheduler import SeqTrainScheduler as RefSched
    from fedml_tpu_torch.sched.seq_scheduler import SeqTrainScheduler, round_robin_groups

    rs = np.random.RandomState(0)
    for n, g in ((16, 4), (8, 2), (13, 5), (3, 4), (40, 7)):
        work = rs.randint(1, 3000, size=n).astype(np.float64)
        work[rs.rand(n) < 0.2] = work[0]  # ties
        a, b = SeqTrainScheduler(work, g).schedule_lpt(), RefSched(work, g).schedule_lpt()
        assert a.assignment == b.assignment and a.iterations == b.iterations
        np.testing.assert_array_equal(a.loads, b.loads)
        assert a.makespan == b.makespan
        got, want = round_robin_groups(n, g), ref_rr(n, g)
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("assignment", ["balanced", "round_robin"])
@pytest.mark.parametrize("per_round", [8, 3])
def test_two_rounds_match_the_reference(tmp_path, assignment, per_round):
    """Two global rounds: the same group map, per-round losses and globals
    within the tolerance, and training moved the weights."""
    ref_cfg, cfg = _cfgs(tmp_path, client_num_per_round=per_round,
                         extra={"group_assignment": assignment})
    ref, sim = _pair(ref_cfg, cfg)
    assert np.array_equal(sim.group_of, np.asarray(ref.group_of))
    start = _flat(sim.global_vars)
    for _ in range(2):
        want_m, got_m = ref.run_round(), sim.run_round()
        for k in ("train_loss", "num_steps", "num_samples"):
            np.testing.assert_allclose(got_m[k], want_m[k], rtol=2e-4, err_msg=k)
        want = _flat(_port_vars(ref.global_vars))
        np.testing.assert_allclose(_flat(sim.global_vars), want, **TOL)
    assert np.abs(want - start).max() > 1e-3
    np.testing.assert_allclose(sim.evaluate()["test_acc"], ref.evaluate()["test_acc"], atol=1e-6)


def test_a_group_with_no_sampled_member_keeps_its_model_bitwise(tmp_path):
    """A sub-round whose sampled clients are all in group 0: group 1's model
    comes back bitwise, group 0's moves."""
    from fedml_tpu_torch.core import pytree as pt

    ref_cfg, cfg = _cfgs(tmp_path, client_num_per_round=3,
                         extra={"group_assignment": "round_robin"})
    _, sim = _pair(ref_cfg, cfg)

    class GroupZero(JaxSubSampler):
        def sample(self, r, s):
            return np.array([0, 2, 4])  # round-robin: all in group 0

    sim.sampler = GroupZero(sim.sampler.root, 8, 3)
    groups = pt.tree_map(lambda t: torch.stack([t, t + 0.25]), sim.global_vars)
    new, metrics = sim._sub_round(groups, 0, 0)
    for a, b in zip(pt.tree_leaves(new), pt.tree_leaves(groups)):
        assert torch.equal(a[1], b[1])
        assert not torch.equal(a[0], b[0])
    assert metrics["train_loss"].shape == (3,)


def test_recipe_runs_through_the_runner(tmp_path):
    """``sim_hierarchical_cifar10`` through ``fedml_tpu_torch.init`` and
    ``FedMLRunner(cfg, device="cpu")``, shrunk (256 images, 2 rounds): the
    FedAvg CNN with dropout on the default bf16 input, 4 balanced groups of
    its 16 clients; and ``fedllm_shakespeare_lora``, the one recipe still
    refused."""
    import fedml_tpu_torch
    from fedml_tpu_torch.models import simple
    from fedml_tpu_torch.runner import FedMLRunner
    from fedml_tpu_torch.sim.hierarchical import HierarchicalSimulator

    cfg = fedml_tpu_torch.init(argv=["--cf", "examples/sim_hierarchical_cifar10/fedml_config.yaml"])
    cfg.comm_round, cfg.synthetic_train_size, cfg.synthetic_test_size = 2, 256, 64
    cfg.frequency_of_the_test, cfg.data_cache_dir = 1, str(tmp_path)
    runner = FedMLRunner(cfg, device="cpu")
    sim = runner.runner
    assert isinstance(sim, HierarchicalSimulator) and sim.hp.compute_dtype == "bfloat16"
    assert sim.model == simple.FedAvgCNN(10, False, (32, 32, 3))
    assert set(sim.group_of.tolist()) == {0, 1, 2, 3}
    hist = runner.run()
    assert [h["round"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["train_loss"]) and np.isfinite(h["test_loss"]) for h in hist)

    from fedml_tpu_torch.llm.fedllm import FedLLMSimulator

    cfg = fedml_tpu_torch.init(argv=["--cf", "examples/fedllm_shakespeare_lora/fedml_config.yaml"])
    cfg.data_cache_dir = str(tmp_path)
    assert isinstance(FedMLRunner(cfg, device="cpu").runner, FedLLMSimulator)
