"""Port parity: FedGAN and FedNAS (``fedml_tpu_torch/sim/fedgan.py``,
``sim/fednas.py``, ``models/gan.py``, ``models/darts.py``, the hub's
``MnistGan*`` in ``models/simple.py``) against the JAX package.

- FedGAN, 2 rounds on ``mnist`` (4 clients, 2 a round as lanes, batch 8,
  2 steps a client, ``gan_z_dim`` 16, Adam at 1e-3, f32), the reference's
  sampled ids, batch rows and latent tables injected and its initial
  weights copied: the global generator and discriminator within 1e-4
  relative L2 over their movement from the start (Adam's first steps
  divide by the gradient's own size; measured 3.8e-5 and 1.6e-5), the D
  and G losses within 1e-5 relative; ``sample(16)`` against the
  reference's within 1e-5 relative L2 (measured 2.4e-6), shaped ``(16,
  28, 28, 1)`` within [-1, 1].
- FedNAS, 2 rounds on ``cifar10`` (4 clients, 2 a round as lanes, batch 4,
  2 steps, 2 cells of 4 features, f32): weights and alphas as above
  (measured 1.2e-6), both losses and the test accuracy within 1e-5
  relative; the genotype equal.
- The two optimizers over the two parts against the reference's form (both
  over the whole tree, the other part's gradient zeroed), 3 steps of 2
  lanes: bitwise.
- ``derive_genotype`` on random alphas with ties, equal; the zero op never
  picked.
- ``MnistGanGenerator`` / ``MnistGanDiscriminator`` forward within 1e-5
  of flax's from its weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from .test_torch_split_learning import JaxOwnSampler, _cfgs, _datasets, flat, port_vars, ref_flat

torch.set_num_threads(1)

TOL = 1e-5
MOVE_TOL = 1e-4


def _moved_rel(got, want, start) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want - start), 1e-30))


@pytest.fixture(scope="module")
def gan_pair(tmp_path_factory):
    from fedml_tpu.sim.fedgan import FedGANSimulator as Ref
    from fedml_tpu_torch.sim.fedgan import FedGANSimulator

    ref_cfg, cfg = _cfgs(tmp_path_factory.mktemp("gan"), "FedGan", dataset="mnist",
                         client_num_per_round=2, learning_rate=1e-3, extra={"gan_z_dim": 16})
    ref_ds, ds = _datasets(ref_cfg, cfg)
    ref = Ref(ref_cfg, ref_ds)
    sim = FedGANSimulator(cfg, ds, device="cpu", sampler=JaxOwnSampler(ref.root_key, 4, 2))
    sim.g_vars, sim.d_vars = port_vars(ref.g_vars), port_vars(ref.d_vars)
    start = (ref_flat(ref.g_vars), ref_flat(ref.d_vars))
    rounds = [(ref.run_round(), sim.run_round()) for _ in range(2)]
    return ref, sim, start, rounds


def test_fedgan_two_rounds_match_the_reference(gan_pair):
    ref, sim, start, rounds = gan_pair
    assert sim.steps == 2 and sim.capacity == 16
    for want_m, got_m in rounds:
        for k in ("d_loss", "g_loss"):
            np.testing.assert_allclose(got_m[k], want_m[k], rtol=TOL)
    for got, want, s0 in ((flat(sim.g_vars), ref_flat(ref.g_vars), start[0]),
                          (flat(sim.d_vars), ref_flat(ref.d_vars), start[1])):
        assert np.abs(want - s0).max() > 1e-4
        assert _moved_rel(got, want, s0) <= MOVE_TOL


def test_fedgan_sample_matches_the_reference(gan_pair):
    ref, sim, _, _ = gan_pair
    got = sim.sample(16, seed=3)
    assert tuple(got.shape) == (16, 28, 28, 1)
    assert float(got.min()) >= -1.0 and float(got.max()) <= 1.0
    want = np.asarray(ref.sample(16, seed=3))
    assert np.linalg.norm(got.numpy() - want) <= TOL * np.linalg.norm(want)


@pytest.fixture(scope="module")
def nas_pair(tmp_path_factory):
    from fedml_tpu.sim.fednas import FedNASSimulator as Ref
    from fedml_tpu_torch.sim.fednas import FedNASSimulator

    ref_cfg, cfg = _cfgs(tmp_path_factory.mktemp("nas"), "FedNAS", dataset="cifar10",
                         client_num_per_round=2, batch_size=4, synthetic_train_size=64,
                         extra={"nas_cells": 2, "nas_features": 4, "nas_arch_lr": 3e-2})
    ref_ds, ds = _datasets(ref_cfg, cfg)
    ref = Ref(ref_cfg, ref_ds)
    sim = FedNASSimulator(cfg, ds, device="cpu", sampler=JaxOwnSampler(ref.root_key, 4, 2))
    sim.variables = port_vars(ref.variables)
    start = ref_flat(ref.variables)
    rounds = [(ref.run_round(), sim.run_round(), float(ref._eval(ref.variables)),
               sim.evaluate()["test_acc"]) for _ in range(2)]
    return ref, sim, start, rounds


def test_fednas_two_rounds_match_the_reference(nas_pair):
    ref, sim, start, rounds = nas_pair
    assert sim.steps == 2 and sim.half == 8
    for want_m, got_m, want_acc, got_acc in rounds:
        for k in ("train_loss", "arch_loss"):
            np.testing.assert_allclose(got_m[k], want_m[k], rtol=TOL)
        np.testing.assert_allclose(got_acc, want_acc, rtol=TOL)
    want = ref_flat(ref.variables)
    assert np.abs(want - start).max() > 1e-4
    assert _moved_rel(flat(sim.variables), want, start) <= MOVE_TOL
    alphas = np.asarray(ref.variables["params"]["alphas"])
    assert np.abs(alphas).max() > 0
    np.testing.assert_allclose(sim.variables["params"]["alphas"].numpy(), alphas, rtol=MOVE_TOL,
                               atol=MOVE_TOL * np.abs(alphas).max())
    assert sim.genotype() == ref.genotype()


def test_two_optimizers_equal_the_masked_whole_tree(nas_pair):
    """The port's weight SGD and alpha Adam over their own parts against
    both optimizers over the whole tree with the other part's gradient
    zeroed (the reference's ``mask_tree``), 3 steps of 2 lanes: bitwise."""
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.fl.losses import cross_entropy_lanes
    from fedml_tpu_torch.fl.optim import SGD, Adam
    from fedml_tpu_torch.sim.own_nets import gather_lanes, lane_copies

    _, sim, _, _ = nas_pair
    sampled = np.array([0, 2])
    g = torch.Generator().manual_seed(5)
    iw = torch.randint(0, sim.half, (2, 3, 4), generator=g)
    ia = torch.randint(sim.half, sim.capacity, (2, 3, 4), generator=g)
    weights, alphas, _, _ = sim.local_search(sampled, iw, ia)

    rows = torch.as_tensor(sampled)
    params = lane_copies(sim.variables["params"], 2)
    w_opt, a_opt = SGD(sim.cfg.learning_rate, 0.9), Adam(sim.arch_lr)
    w_state, a_state = w_opt.init(params), a_opt.init(params, 2)

    def masked_grads(idx, alphas_on):
        leaves = [t.detach().requires_grad_(True) for t in pt.tree_leaves(params)]
        p = pt.tree_unflatten_like(params, leaves)
        logits, _ = sim.model.apply({"params": p}, gather_lanes(sim._x, rows, idx), train=True)
        loss = cross_entropy_lanes(logits, gather_lanes(sim._y, rows, idx)).sum()
        grads = pt.tree_unflatten_like(params, torch.autograd.grad(loss, leaves))
        return {k: (v if (k == "alphas") == alphas_on else pt.tree_map(torch.zeros_like, v))
                for k, v in grads.items()}

    for s in range(3):
        params, w_state = w_opt.update(masked_grads(iw[:, s], False), w_state, params)
        params, a_state = a_opt.update(masked_grads(ia[:, s], True), a_state, params)
    assert torch.equal(params["alphas"], alphas)
    for got, want in zip(pt.tree_leaves(weights),
                         pt.tree_leaves({k: v for k, v in params.items() if k != "alphas"})):
        assert torch.equal(got, want)


def test_derive_genotype_matches_the_reference():
    from fedml_tpu.models.darts import derive_genotype as ref_genotype
    from fedml_tpu_torch.models.darts import OPS, derive_genotype

    rs = np.random.RandomState(0)
    alphas = np.round(rs.randn(3, 2, 4), 1).astype(np.float32)
    alphas[0, 0] = [0.5, 0.5, 0.1, 9.0]  # a tie, and the zero op largest
    alphas[1, 1] = 0.0
    got = derive_genotype(torch.from_numpy(alphas))
    assert got == ref_genotype(jnp.asarray(alphas))
    assert got[0][0] == "conv3" and all(op != OPS[-1] for cell in got for op in cell)


@pytest.mark.parametrize("which", ["generator", "discriminator"])
def test_mnist_gan_forward_matches_flax(which):
    from fedml_tpu.models import simple as fs
    from fedml_tpu_torch.models import simple

    rs = np.random.RandomState(2)
    if which == "generator":
        ref, model, x = fs.MnistGanGenerator(), simple.MnistGanGenerator(), rs.randn(3, 100)
    else:
        ref, model, x = fs.MnistGanDiscriminator(), simple.MnistGanDiscriminator(), rs.rand(3, 28, 28, 1)
    x = x.astype(np.float32)
    v = ref.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(ref.apply(v, jnp.asarray(x)))
    got, _ = model.apply(port_vars(v), torch.from_numpy(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
