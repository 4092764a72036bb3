"""Port parity, the slice as a whole: FedAvg rounds of the fused recipe.

The JAX ``MeshSimulator`` runs with ``backend_sim="sp"`` (its sequential
twin); the port's simulator gets the JAX run's initial weights and a sampler
hook that hands it the reference's sampled ids and per-epoch permutations
(``fedml_tpu.core.rng`` + ``jax.random``).  f32, fused ResNet (one block per
stage), 2 rounds of 2 of 4 clients.

Tolerances: round metrics rtol 1e-4, test metrics rtol 1e-3; the global
variables are compared as updates from the shared initial weights: the flat
update within 1e-2 (relative L2) and every leaf within 5e-2 of its own
update's scale.  Why not tighter: once training moves the weights, some BN
channels have |mean| >> std, where the fast variance E[x^2] - E[x]^2
amplifies f32 rounding.  Measured on this recipe, one local step at the
round-1 weights: the port's f32 gradients are within 4e-6 (relative, per
leaf) of the same step in f64, the JAX package's within 2.6e-2, and its
jitted and eager runs differ from each other at the 1e-2 level; after round
1 alone the two packages agree to 1.5e-5.
"""

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)


class JaxSampler:
    """The reference's randomness as a port sampler hook."""

    def __init__(self, root_key, n_total, per_round):
        self.root, self.n_total, self.per_round = root_key, n_total, per_round

    def sample(self, r):
        from fedml_tpu.core import rng

        return np.asarray(rng.sample_clients(self.root, r, self.n_total, self.per_round))

    def perms(self, r, client, epochs, cap):
        from fedml_tpu.core import rng

        key = rng.client_key(rng.round_key(self.root, r), client)
        return torch.from_numpy(np.stack([np.asarray(jax.random.permutation(
            jax.random.fold_in(jax.random.fold_in(key, e), 1), cap)) for e in range(epochs)]))


def _cfgs(tmp_path, **kw):
    import fedml_tpu.arguments as ref_args
    import fedml_tpu_torch.arguments as args

    base = dict(dataset="cifar10", model="resnet20", client_num_in_total=4,
                client_num_per_round=2, comm_round=2, epochs=1, batch_size=8,
                learning_rate=0.05, synthetic_train_size=64, synthetic_test_size=40,
                partition_method="hetero", partition_alpha=0.5, frequency_of_the_test=2,
                compute_dtype="float32", random_seed=0, backend_sim="sp",
                data_cache_dir=str(tmp_path), extra={"fused_blocks": True})
    base.update(kw)
    return ref_args.Config(**base), args.Config(**base)


def test_two_fedavg_rounds_match_jax_sp(tmp_path):
    """(f) two FedAvg rounds on a tiny fused recipe, ids and permutations
    injected from the reference: the global state matches the JAX SP run."""
    import fedml_tpu
    import fedml_tpu_torch
    from fedml_tpu.data import loader as ref_loader
    from fedml_tpu.models import resnet as flax_resnet
    from fedml_tpu.sim.engine import MeshSimulator as JaxSim
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.models import resnet
    from fedml_tpu_torch.sim.engine import MeshSimulator

    ref_cfg, cfg = _cfgs(tmp_path)
    fedml_tpu.init(ref_cfg)
    fedml_tpu_torch.init(cfg)
    ref_ds = ref_loader.load(ref_cfg)
    ds = loader.load(cfg)
    ref_sim = JaxSim(ref_cfg, ref_ds, flax_resnet.CifarResNet(num_blocks=1, fused=True))
    init = weights.flax_to_torch(jax.tree_util.tree_map(np.asarray, ref_sim.global_vars))
    n, m = ds.n_clients, cfg.client_num_per_round
    sim = MeshSimulator(cfg, ds, resnet.CifarResNet(1, fused=True), device="cpu",
                        sampler=JaxSampler(ref_sim.root_key, n, m))
    sim.global_vars = weights.to_torch(init)
    assert sim.capacity == ref_sim.capacity and sim.hp.steps_per_epoch == ref_sim.hp.steps_per_epoch

    ref_hist = ref_sim.run()
    hist = sim.run()
    assert len(hist) == len(ref_hist) == 2
    for a, b in zip(hist, ref_hist):
        for k in ("train_loss", "num_steps", "num_samples"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)
    for k in ("test_loss", "test_acc"):
        np.testing.assert_allclose(hist[-1][k], ref_hist[-1][k], rtol=1e-3, atol=1e-6, err_msg=k)
    ref_final = weights.flax_to_torch(jax.tree_util.tree_map(np.asarray, ref_sim.global_vars))
    got_leaves = [a.numpy() for a in pt.tree_leaves(sim.global_vars)]
    ref_leaves, init_leaves = jax.tree_util.tree_leaves(ref_final), jax.tree_util.tree_leaves(init)
    for a, b, i in zip(got_leaves, ref_leaves, init_leaves):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.abs(a - b).max() <= 5e-2 * np.abs(b - i).max() + 1e-6
    upd = np.concatenate([(b - i).ravel() for b, i in zip(ref_leaves, init_leaves)])
    diff = np.concatenate([(a - b).ravel() for a, b in zip(got_leaves, ref_leaves)])
    assert np.linalg.norm(diff) <= 1e-2 * np.linalg.norm(upd)
    assert np.abs(upd).max() > 1e-3  # training moved the weights: not vacuous


def test_runner_flagship_shape_learns_on_cpu(tmp_path):
    """The slice through its public entry points (init + FedMLRunner) on the
    CPU with the port's own randomness, on the MESH backend (the sampled
    clients as the lanes of one batched round): bf16 fused ResNet-20,
    finite metrics every round, a JSONL record per round, evaluation at the
    end."""
    import json

    import fedml_tpu_torch
    from fedml_tpu_torch.ops import fused_block as fb
    from fedml_tpu_torch.runner import FedMLRunner

    _, cfg = _cfgs(tmp_path, comm_round=3, frequency_of_the_test=3, compute_dtype="bfloat16",
                   backend_sim="MESH", metrics_jsonl_path=str(tmp_path / "m.jsonl"))
    cfg = fedml_tpu_torch.init(cfg)
    runner = FedMLRunner(cfg, device="cpu")
    fb.reset_launch_counts()
    hist = runner.run()
    assert runner.runner.backend == "MESH"
    assert [h["round"] for h in hist] == [0, 1, 2]
    assert all(np.isfinite(h["train_loss"]) for h in hist)
    assert "test_acc" in hist[-1] and np.isfinite(hist[-1]["test_loss"])
    assert 0.0 <= hist[-1]["test_acc"] <= 1.0
    lines = (tmp_path / "m.jsonl").read_text().splitlines()
    assert [json.loads(line)["round"] for line in lines] == [0, 1, 2]
    assert all(v == 0 for v in fb.launch_counts().values())  # CPU: plain versions


def test_unported_features_raise(tmp_path):
    from fedml_tpu_torch.runner import FedMLRunner

    for kw in (dict(federated_optimizer="FedGAN"),
               dict(federated_optimizer="HierarchicalFL", enable_dp=True),
               dict(training_type="cross_device"),
               dict(training_type="cross_silo", role="client"),
               dict(enable_secagg=True), dict(enable_fhe=True),
               dict(extra={"otlp_endpoint": "http://localhost:4318"}),
               dict(extra={"aot_programs": True})):
        _, cfg = _cfgs(tmp_path, **kw)
        with pytest.raises(NotImplementedError):
            FedMLRunner(cfg, device="cpu")


def test_entry_points_without_device_raise_without_cuda(tmp_path):
    """(h) no CUDA and no device='cpu': every entry point raises instead of
    running on the CPU."""
    import fedml_tpu_torch
    from fedml_tpu_torch.core.device import resolve_device
    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.models import resnet
    from fedml_tpu_torch.runner import FedMLRunner
    from fedml_tpu_torch.sim.engine import MeshSimulator

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the refusal applies where it is missing")
    _, cfg = _cfgs(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FedMLRunner(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fedml_tpu_torch.run_simulation(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MeshSimulator(cfg, loader.load(cfg), resnet.CifarResNet(1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
