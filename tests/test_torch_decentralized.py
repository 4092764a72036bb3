"""Port parity: decentralized FL (``fedml_tpu_torch/sim/decentralized.py``)
against ``fedml_tpu/sim/decentralized.py`` on a one-device mesh.

Two rounds of DSGD, PushSum and the ring on the logistic regression over
``synthetic`` (6 Dirichlet clients, f32), and DSGD on a ResNet with one
block a stage (4 clients, 64 images, f32, BatchNorm statistics mixed too).
The port starts from the reference's initial weights and takes its
permutations through the sampler hook.  Every client's variables are held
to the reference's, as the reference's flat rows, by the relative L2 of
the difference over the clients' movement from the start: 1e-5 for the
regression (``tests/test_torch_algorithms.py``'s ``LR_TOL``), 1e-2 for the
ResNet (its ``RESNET_TOL``: the reference's f32 gradients on trained
weights); the push weights within rtol 1e-6, the consensus distance and
the consensus model's test loss within rtol 1e-4 (the regression) / 1e-2.

The mixes alone: DSGD's and PushSum's ``W @ P`` and the ring's halo mix
against the dense ``ring_topology(n) @ P`` in f64, within 1e-6 relative
L2 (measured 3.9e-8 to 5.1e-8 in f32); the ring's refusal of fewer than three clients, as the
reference's.
"""

import jax
import numpy as np
import pytest
import torch

from .test_torch_algorithms import _rel
from .test_torch_mesh import JaxSampler, _port_vars

torch.set_num_threads(1)

LR_TOL = 1e-5
RESNET_TOL = 1e-2


def _cfgs(tmp_path, model, **kw):
    import fedml_tpu.arguments as ref_args
    import fedml_tpu_torch.arguments as args

    base = dict(federated_optimizer="decentralized_fl", client_num_in_total=6,
                client_num_per_round=6, comm_round=2, epochs=1, batch_size=8,
                learning_rate=0.05, synthetic_test_size=40, partition_method="hetero",
                partition_alpha=0.5, frequency_of_the_test=0, compute_dtype="float32",
                random_seed=0, data_cache_dir=str(tmp_path))
    if model == "lr":
        base.update(dataset="synthetic", model="lr", synthetic_train_size=120)
    else:
        base.update(dataset="cifar10", model="resnet20", synthetic_train_size=64,
                    client_num_in_total=4, client_num_per_round=4)
    base.update(kw)
    extra = base.pop("extra", {})
    return ref_args.Config(**base, extra=extra), args.Config(**base, extra=dict(extra))


def _models(model):
    from fedml_tpu.models import resnet as flax_resnet, simple as flax_simple
    from fedml_tpu_torch.models import resnet, simple

    if model == "lr":
        return flax_simple.LogisticRegression(10), simple.LogisticRegression(10, 60)
    return flax_resnet.CifarResNet(num_blocks=1), resnet.CifarResNet(1)


def _ref_rows(stacked) -> np.ndarray:
    """The reference's client-stacked tree as ``(n, d)`` f64 rows."""
    leaves = jax.tree_util.tree_leaves(stacked)
    n = leaves[0].shape[0]
    return np.concatenate([np.asarray(a, np.float64).reshape(n, -1) for a in leaves], 1)


def _port_rows(stacked) -> np.ndarray:
    from fedml_tpu_torch.core import pytree as pt

    return pt.stacked_tree_to_matrix(stacked).double().numpy()


def _pair(tmp_path, model, mode):
    import fedml_tpu
    import fedml_tpu_torch
    from fedml_tpu.data import loader as ref_loader
    from fedml_tpu.parallel import mesh as meshlib
    from fedml_tpu.sim.decentralized import DecentralizedSimulator as JaxDec
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.sim.decentralized import DecentralizedSimulator

    ref_cfg, cfg = _cfgs(tmp_path, model, extra={"decentralized_mode": mode})
    ref_model, port_model = _models(model)
    fedml_tpu.init(ref_cfg)
    ref = JaxDec(ref_cfg, ref_loader.load(ref_cfg), ref_model,
                 mesh=meshlib.mesh_from_config(ref_cfg, devices=jax.devices()[:1]))
    fedml_tpu_torch.init(cfg)
    ds = loader.load(cfg)
    n = ds.n_clients
    sim = DecentralizedSimulator(cfg, ds, port_model, device="cpu",
                                 sampler=JaxSampler(ref.root_key, n, n))
    one = _port_vars(jax.tree_util.tree_map(lambda a: a[0], ref.client_vars))
    sim.client_vars = pt.tree_map(lambda t: t.unsqueeze(0).repeat((n,) + (1,) * t.ndim), one)
    return ref, sim


@pytest.mark.parametrize("model,mode", [("lr", "dsgd"), ("lr", "pushsum"), ("lr", "ring"),
                                        ("resnet", "dsgd")])
def test_two_rounds_match_the_reference(tmp_path, model, mode):
    ref, sim = _pair(tmp_path, model, mode)
    np.testing.assert_array_equal(sim.W_host, np.asarray(ref.W))
    start = _port_rows(sim.client_vars)
    np.testing.assert_array_equal(start, _ref_rows(ref.client_vars))
    tol = LR_TOL if model == "lr" else RESNET_TOL
    for _ in range(2):
        want_m, got_m = ref.run_round(), sim.run_round()
        for k in ("num_steps", "num_samples"):
            assert got_m[k] == pytest.approx(want_m[k], rel=1e-6)
        np.testing.assert_allclose(got_m["train_loss"], want_m["train_loss"],
                                   rtol=1e-4 if model == "lr" else 1e-2)
    want = _ref_rows(ref.client_vars)
    assert np.abs(want - start).max() > 1e-3  # training moved the weights
    assert _rel(_port_rows(sim.client_vars), want, start) <= tol
    np.testing.assert_allclose(sim.push_weights.numpy(), np.asarray(ref.push_weights),
                               rtol=1e-6)
    rtol = 1e-4 if model == "lr" else 1e-2
    np.testing.assert_allclose(sim.consensus_distance(), ref.consensus_distance(), rtol=rtol)
    np.testing.assert_allclose(sim.evaluate()["test_loss"], ref.evaluate()["test_loss"],
                               rtol=rtol)
    if mode == "pushsum":
        assert float(sim.push_weights.sum()) == pytest.approx(len(sim.push_weights), rel=1e-5)


@pytest.mark.parametrize("mode", ["dsgd", "pushsum", "ring"])
def test_mixes_against_dense_f64(mode):
    """Each mix of a random stacked tree (a conv kernel, a vector) against
    the same product in f64, the ring against ``ring_topology(n) @ P``."""
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.parallel import topology as topo
    from fedml_tpu_torch.sim.decentralized import matrix_mix, mixing_matrix, ring_mix

    n = 7
    g = torch.Generator().manual_seed(3)
    tree = {"kernel": torch.randn(n, 8, 3, 3, 3, generator=g),
            "bias": torch.randn(n, 8, generator=g).to(torch.bfloat16)}
    W = mixing_matrix(mode, n, 3, seed=1)
    if mode == "ring":
        got = pt.tree_map(ring_mix, tree)
        W = topo.ring_topology(n)
    else:
        got = pt.tree_map(lambda t: matrix_mix(torch.from_numpy(W), t), tree)
    for k, leaf in tree.items():
        assert got[k].dtype == leaf.dtype and got[k].shape == leaf.shape
        want = W.astype(np.float64) @ leaf.double().reshape(n, -1).numpy()
        err = np.linalg.norm(got[k].double().reshape(n, -1).numpy() - want)
        rel = 1e-6 if leaf.dtype == torch.float32 else 2 ** -8  # bf16: the cast back
        assert err <= rel * np.linalg.norm(want), (k, err)


def test_ring_needs_three_clients(tmp_path):
    """Fewer than three clients: the ring refuses (both packages)."""
    import fedml_tpu_torch
    from fedml_tpu.sim.decentralized import DecentralizedSimulator as JaxDec
    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.models import simple
    from fedml_tpu_torch.sim.decentralized import DecentralizedSimulator

    ref_cfg, cfg = _cfgs(tmp_path, "lr", client_num_in_total=2, client_num_per_round=2,
                         extra={"decentralized_mode": "ring"})
    fedml_tpu_torch.init(cfg)
    ds = loader.load(cfg)
    with pytest.raises(ValueError, match="n >= 3"):
        DecentralizedSimulator(cfg, ds, simple.LogisticRegression(10, 60), device="cpu")
    from fedml_tpu.data import loader as ref_loader
    from fedml_tpu.models import simple as flax_simple

    with pytest.raises(ValueError, match="n >= 3"):
        JaxDec(ref_cfg, ref_loader.load(ref_cfg), flax_simple.LogisticRegression(10))
