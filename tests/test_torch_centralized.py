"""Port parity: centralized training (``fedml_tpu_torch/sim/centralized.py``,
``training_type: centralized``) against ``fedml_tpu/sim/centralized.py``,
and the runner's dispatch of this slice's simulators.

Two rounds of the whole training set as one client (cyclic-tiled to a
batch multiple) on the logistic regression over ``synthetic`` (f32, 100
samples: 13 steps of 8 a round, the last batch wrapping) and one round of
a ResNet with one block a stage (64 images, f32), each followed by the
test evaluation; the port takes the reference's permutations (drawn from
``round_key(root, r)``) through the sampler hook and starts from its
initial weights.  Each round's loss within rtol 1e-4 (the regression) /
1e-2 (the ResNet), the variables within 1e-5 / 1e-2 relative L2 of the
reference's movement (``tests/test_torch_algorithms.py``'s ``LR_TOL`` /
``RESNET_TOL``), the test loss within rtol 1e-4 / 1e-2.

Through ``FedMLRunner(cfg, device="cpu")``: ``decentralized_fl`` in its
three modes, ``Async_FedAvg``, ``TA``, ``training_type: centralized`` and
the engine with ``extra.population_store`` run, each to finite metrics;
trust flags and a custom trainer are refused on the simulators of their
own, and every other platform still raises.
"""

import jax
import numpy as np
import pytest
import torch

from .test_torch_algorithms import _rel
from .test_torch_mesh import _port_vars

torch.set_num_threads(1)


class JaxCentralSampler:
    """The reference's permutations: ``round_key(root, r)`` folded ``(e,
    1)``."""

    def __init__(self, root):
        self.root = root

    def perms(self, r, epochs, cap):
        from fedml_tpu.core import rng

        key = rng.round_key(self.root, r)
        return torch.from_numpy(np.stack([np.asarray(jax.random.permutation(
            jax.random.fold_in(jax.random.fold_in(key, e), 1), cap)) for e in range(epochs)]))


def _cfgs(tmp_path, model, **kw):
    import fedml_tpu.arguments as ref_args
    import fedml_tpu_torch.arguments as args

    base = dict(training_type="centralized", comm_round=2, epochs=1, batch_size=8,
                learning_rate=0.05, synthetic_test_size=40, compute_dtype="float32",
                random_seed=0, data_cache_dir=str(tmp_path), client_num_in_total=4,
                client_num_per_round=4)
    if model == "lr":
        base.update(dataset="synthetic", model="lr", synthetic_train_size=100)
    else:
        base.update(dataset="cifar10", model="resnet20", synthetic_train_size=64, comm_round=1)
    base.update(kw)
    return ref_args.Config(**base), args.Config(**base)


def _flat(tree) -> np.ndarray:
    from fedml_tpu_torch import weights

    return weights.flatten_reference(tree)[0].double().numpy()


@pytest.mark.parametrize("model", ["lr", "resnet"])
def test_rounds_match_the_reference(tmp_path, model):
    import fedml_tpu
    import fedml_tpu_torch
    from fedml_tpu.data import loader as ref_loader
    from fedml_tpu.models import resnet as flax_resnet, simple as flax_simple
    from fedml_tpu.sim.centralized import CentralizedTrainer as JaxCentral
    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.models import resnet, simple
    from fedml_tpu_torch.sim.centralized import CentralizedTrainer

    ref_cfg, cfg = _cfgs(tmp_path, model)
    fedml_tpu.init(ref_cfg)
    ref_model, port_model = ((flax_simple.LogisticRegression(10), simple.LogisticRegression(10, 60))
                             if model == "lr" else
                             (flax_resnet.CifarResNet(num_blocks=1), resnet.CifarResNet(1)))
    ref = JaxCentral(ref_cfg, ref_loader.load(ref_cfg), ref_model)
    fedml_tpu_torch.init(cfg)
    sim = CentralizedTrainer(cfg, loader.load(cfg), port_model, device="cpu",
                             sampler=JaxCentralSampler(ref.key))
    sim.variables = _port_vars(ref.variables)
    assert sim.capacity == ref.hp.steps_per_epoch * cfg.batch_size
    start = _flat(sim.variables)
    want_hist, hist = ref.run(), sim.run()
    assert [h["round"] for h in hist] == list(range(cfg.comm_round))
    tol = 1e-4 if model == "lr" else 1e-2
    for got, want in zip(hist, want_hist):
        assert got["num_steps"] == want["num_steps"] and got["num_samples"] == want["num_samples"]
        np.testing.assert_allclose(got["train_loss"], want["train_loss"], rtol=tol)
        np.testing.assert_allclose(got["test_loss"], want["test_loss"], rtol=tol)
    target = np.concatenate([np.asarray(a, np.float64).ravel()
                             for a in jax.tree_util.tree_leaves(ref.variables)])
    assert np.abs(target - start).max() > 1e-3
    assert _rel(_flat(sim.variables), target, start) <= (1e-5 if model == "lr" else 1e-2)


def _port_cfg(tmp_path, **kw):
    import fedml_tpu_torch.arguments as args

    base = dict(dataset="synthetic", model="lr", client_num_in_total=6, client_num_per_round=4,
                comm_round=2, epochs=1, batch_size=8, learning_rate=0.05,
                synthetic_train_size=120, synthetic_test_size=40, partition_method="hetero",
                partition_alpha=0.5, frequency_of_the_test=1, compute_dtype="float32",
                random_seed=0, data_cache_dir=str(tmp_path))
    base.update(kw)
    return args.Config(**base)


@pytest.mark.parametrize("form", ["dsgd", "pushsum", "ring", "Async_FedAvg", "TA",
                                  "centralized", "population"])
def test_entry_points_run(tmp_path, form):
    """Each of this slice's paths through ``fedml_tpu_torch.init`` and
    ``FedMLRunner(cfg, device="cpu").run()``."""
    import fedml_tpu_torch
    from fedml_tpu_torch.runner import FedMLRunner
    from fedml_tpu_torch.sim import (async_fl, centralized, decentralized, engine,
                                     turboaggregate)

    kw, cls = {
        "dsgd": (dict(federated_optimizer="decentralized_fl"),
                 decentralized.DecentralizedSimulator),
        "pushsum": (dict(federated_optimizer="decentralized_fl",
                         extra={"decentralized_mode": "pushsum", "topology_neighbor_num": 3}),
                    decentralized.DecentralizedSimulator),
        "ring": (dict(federated_optimizer="decentralized_fl",
                      extra={"decentralized_mode": "ring"}), decentralized.DecentralizedSimulator),
        "Async_FedAvg": (dict(federated_optimizer="Async_FedAvg", comm_round=5),
                         async_fl.AsyncSimulator),
        "TA": (dict(federated_optimizer="TA", extra={"ta_group_num": 2, "ta_dropout_prob": 0.3}),
               turboaggregate.TurboAggregateSimulator),
        "centralized": (dict(training_type="centralized"), centralized.CentralizedTrainer),
        "population": (dict(federated_optimizer="SCAFFOLD",
                            extra={"population_store": str(tmp_path / "pop"),
                                   "population_size": 100, "population_shard_size": 8}),
                       engine.MeshSimulator),
    }[form]
    cfg = fedml_tpu_torch.init(_port_cfg(tmp_path, **kw))
    runner = FedMLRunner(cfg, device="cpu")
    assert type(runner.runner) is cls
    hist = runner.run()
    assert len(hist) == cfg.comm_round
    assert all(np.isfinite(h["train_loss"]) for h in hist)
    assert np.isfinite(hist[-1]["test_loss"]) and 0.0 <= hist[-1]["test_acc"] <= 1.0
    if form in ("dsgd", "pushsum", "ring"):
        assert np.isfinite(hist[-1]["consensus_dist"])
    if form == "population":
        assert runner.runner._population.store.disk_bytes() > 0


def test_refusals(tmp_path):
    """Trust flags, the engine's unported flags, population mode and a
    custom trainer on the simulators of their own and on centralized
    training (none is a silent no-op); platforms still to port."""
    import fedml_tpu_torch
    from fedml_tpu_torch.runner import FedMLRunner

    for opt in ("decentralized_fl", "Async_FedAvg", "TA", None):
        kw = {"training_type": "centralized"} if opt is None else {"federated_optimizer": opt}
        for flags, err in ((dict(enable_dp=True, dp_solution_type="ldp"), NotImplementedError),
                           (dict(enable_attack=True), NotImplementedError),
                           (dict(extra={"aot_programs": True}), NotImplementedError),
                           (dict(extra={"otlp_endpoint": "localhost:4317"}),
                            NotImplementedError),
                           (dict(extra={"population_store": str(tmp_path / "pop")}),
                            NotImplementedError)):
            cfg = fedml_tpu_torch.init(_port_cfg(tmp_path, **kw, **flags))
            with pytest.raises(err):
                FedMLRunner(cfg, device="cpu")
        cfg = fedml_tpu_torch.init(_port_cfg(tmp_path, **kw))
        with pytest.raises(ValueError, match="client_trainer"):
            FedMLRunner(cfg, device="cpu", client_trainer=object())
    for platform in ("cross_device", "serving"):
        cfg = _port_cfg(tmp_path, training_type=platform)
        with pytest.raises(NotImplementedError, match="not ported"):
            FedMLRunner(cfg, device="cpu")
    # cross_cloud is ported (cross_cloud/): the cross-silo platform with the
    # WAN defaults (tests/test_torch_unitedllm.py holds it to the reference)
    from fedml_tpu_torch.cross_cloud import _CrossCloudRunner

    cfg = _port_cfg(tmp_path, training_type="cross_cloud")
    assert isinstance(FedMLRunner(cfg, device="cpu").runner, _CrossCloudRunner)
    assert cfg.extra["straggler_timeout_s"] == 60.0
