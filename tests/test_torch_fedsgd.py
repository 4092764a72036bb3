"""Port parity: FedSGD (``algorithms/fedsgd.py``), its full-shard gradient
(``fl/local_sgd.make_full_grad_fn``), the server optimizer and per-client
state in the simulator (``sim/engine.py``).

f32, ResNet with one block per stage (unfused, as the FedSGD recipe), the
flax initial weights copied into the port.  The JAX ``MeshSimulator`` runs
its sequential twin (``backend_sim="sp"``); the port's simulator gets a
sampler hook that hands it the reference's sampled ids and compression draws
(``jax.random.uniform(fold_in(client_key, 7), shape)``).

Tolerances, in layers (stochastic rounding turns an ulp into a whole level):

- compression ops bitwise on identical inputs (``test_torch_quantize.py``);
- ``full_grad``: rtol 1e-4 / atol 1e-6 per element at the initial weights
  (eager torch vs XLA sum the batch losses and reductions in different
  orders; measured max 1.5e-6 relative to each leaf's largest entry);
- one client's quantized gradient at the same weights, the same draw on
  both sides: int8 levels within +-1, differing at <= 5e-4 of elements
  (measured over five draws: 1 to 3 of 75,776 levels, <= 4e-5; scales
  within 1.5e-6 relative);
- ``qsgd_int8`` rounds: each weight within ``server_lr * sum over rounds of
  the largest block scale`` (one level of the coarsest block per round, the
  most a flipped level can move a sample-weighted mean) plus 1e-5; measured
  0.13 of that bound after 2 rounds.  The flat update within 1e-2 relative
  L2 (measured 4.1e-3);
- ``eftopk`` rounds: a flip at the top-k threshold moves an element between
  the sent vector and the residual, so the weights and the residuals alone
  can differ by a whole element (measured 4.5e-3 against an update of at
  most 0.23).  Error feedback conserves ``sent + residual``: with every
  client in every round, ``w_R - server_lr * sum_c p_c * residual_c = w_0 -
  server_lr * sum_r sum_c p_c * grad_{c,r}`` whatever was sent.  That
  virtual iterate is held to 2e-3 relative L2 (measured 4.5e-4: the round-2
  gradients are taken at weights that differ by the flipped element) and
  each part loosely, to 5e-2 relative L2: the weights' update (measured
  1.0e-2) and the residuals (measured 1.8e-2).
- test loss and accuracy after the rounds: rtol 2e-2 (measured 3.5e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)


class JaxSampler:
    """The reference's randomness as a port sampler hook (FedSGD takes no
    permutations)."""

    def __init__(self, root_key, n_total, per_round):
        self.root, self.n_total, self.per_round = root_key, n_total, per_round

    def sample(self, r):
        from fedml_tpu.core import rng

        return np.asarray(rng.sample_clients(self.root, r, self.n_total, self.per_round))

    def perms(self, r, client, epochs, cap):
        return None

    def uniform(self, r, client, shape, device):
        from fedml_tpu.core import rng

        key = jax.random.fold_in(rng.client_key(rng.round_key(self.root, r), client), 7)
        return torch.from_numpy(np.array(jax.random.uniform(key, shape, jnp.float32))).to(device)


def _cfgs(tmp_path, **kw):
    import fedml_tpu.arguments as ref_args
    import fedml_tpu_torch.arguments as args

    base = dict(dataset="cifar10", model="resnet20", client_num_in_total=4,
                client_num_per_round=3, comm_round=2, batch_size=8, synthetic_train_size=64,
                synthetic_test_size=40, partition_method="hetero", partition_alpha=0.5,
                frequency_of_the_test=2, compute_dtype="float32", random_seed=0,
                backend_sim="sp", data_cache_dir=str(tmp_path), federated_optimizer="FedSGD",
                compression="qsgd_int8", compression_ratio=0.05)
    base.update(kw)
    return ref_args.Config(**base), args.Config(**base)


def _flat(tree):
    from fedml_tpu_torch import weights

    return weights.flatten_reference(tree)[0]


def _client_setup(seed=11, cap=24, bsz=8):
    from fedml_tpu.fl.types import HParams as JHParams
    from fedml_tpu.models import resnet as flax_resnet
    from fedml_tpu_torch.fl.types import HParams

    rs = np.random.RandomState(seed)
    x = rs.randn(cap, 8, 8, 3).astype(np.float32)
    y = rs.randint(0, 10, size=cap).astype(np.int32)
    m = flax_resnet.CifarResNet(num_blocks=1)
    k = jax.random.PRNGKey(0)
    v = jax.tree_util.tree_map(np.asarray, m.init({"params": k, "dropout": k}, x[:bsz], train=True))
    kw = dict(batch_size=bsz, steps_per_epoch=cap // bsz, compute_dtype="float32")
    return JHParams(**kw), HParams(**kw), m, v, x, y


@pytest.mark.parametrize("cap", [24, 20])
def test_full_grad_matches_reference(cap):
    """Mean over cap // bsz consecutive batches (the last partial batch of a
    non-multiple capacity is left out, as in the reference)."""
    from fedml_tpu.fl.local_sgd import make_full_grad_fn as jax_make
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.fl.local_sgd import make_full_grad_fn
    from fedml_tpu_torch.models import resnet

    jhp, hp, m, v, x, y = _client_setup(cap=cap)
    ref = jax.jit(jax_make(m, jhp))(v, x, y, jnp.int32(19), jax.random.PRNGKey(1))
    ref = weights.flax_to_torch(jax.tree_util.tree_map(np.asarray, ref))
    got = make_full_grad_fn(resnet.CifarResNet(1), hp)(
        weights.to_torch(weights.flax_to_torch(v)), torch.from_numpy(x), torch.from_numpy(y).long())
    assert sorted(got) == sorted(ref)
    for a, b in zip(pt.tree_leaves(got), jax.tree_util.tree_leaves(ref)):
        assert a.shape == b.shape and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-6)
    assert max(float(a.abs().max()) for a in pt.tree_leaves(got)) > 1e-2  # not vacuous


def test_quantized_client_gradient_level_flips():
    """One client's FedSGD contribution at the same weights, quantized with
    the same draw on both sides: levels differ by at most one, rarely."""
    from fedml_tpu.fl.local_sgd import make_full_grad_fn as jax_make
    from fedml_tpu.core import pytree as ref_pt
    from fedml_tpu.ops.pallas import quantize as jq
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.fl.local_sgd import make_full_grad_fn
    from fedml_tpu_torch.models import resnet
    from fedml_tpu_torch.ops import quantize as q

    jhp, hp, m, v, x, y = _client_setup(seed=5, cap=32)
    ref = jax.jit(jax_make(m, jhp))(v, x, y, jnp.int32(32), jax.random.PRNGKey(1))
    ref_flat, _ = ref_pt.tree_flatten_to_vector(ref)
    got_flat = _flat(make_full_grad_fn(resnet.CifarResNet(1), hp)(
        weights.to_torch(weights.flax_to_torch(v)), torch.from_numpy(x),
        torch.from_numpy(y).long()))
    key = jax.random.PRNGKey(3)
    rv, rsc, _ = jq.quantize_int8_reference(ref_flat, key)
    u = torch.from_numpy(np.array(jax.random.uniform(key, rv.shape, jnp.float32)))
    pv, psc, _ = q.quantize_int8_stochastic(got_flat, u)
    levels = np.abs(pv.numpy().astype(np.int32) - np.asarray(rv).astype(np.int32))
    assert levels.max() <= 1
    assert (levels != 0).mean() <= 5e-4
    np.testing.assert_allclose(psc.numpy(), np.asarray(rsc), rtol=1e-4)


def _run_pair(tmp_path, **kw):
    import fedml_tpu
    import fedml_tpu_torch
    from fedml_tpu import algorithms as ref_algorithms
    from fedml_tpu.data import loader as ref_loader
    from fedml_tpu.models import resnet as flax_resnet
    from fedml_tpu.sim.engine import MeshSimulator as JaxSim
    from fedml_tpu_torch import algorithms, weights
    from fedml_tpu_torch.algorithms.fedsgd import FedSGD
    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.models import resnet
    from fedml_tpu_torch.sim.engine import MeshSimulator

    ref_cfg, cfg = _cfgs(tmp_path, **kw)
    fedml_tpu.init(ref_cfg)
    fedml_tpu_torch.init(cfg)
    ref_sim = JaxSim(ref_cfg, ref_loader.load(ref_cfg), flax_resnet.CifarResNet(num_blocks=1))
    init = weights.to_torch(weights.flax_to_torch(
        jax.tree_util.tree_map(np.asarray, ref_sim.global_vars)))
    ds = loader.load(cfg)

    scales = {}  # round -> the largest block scale over the round's clients

    class RecordingFedSGD(FedSGD):
        def client_update(self, gv, cs, ss, x, y, count, key, perms=None, draw=None):
            out = super().client_update(gv, cs, ss, x, y, count, key, perms, draw)
            r = sim.round_idx
            scales[r] = max(scales.get(r, 0.0), float(_flat(out.contribution).abs().max()) / 126)
            return out

    hp = algorithms.hparams_from_config(cfg, steps_per_epoch=1)
    sim = MeshSimulator(cfg, ds, resnet.CifarResNet(1), algorithm=RecordingFedSGD(hp, cfg),
                        device="cpu", sampler=JaxSampler(ref_sim.root_key, ds.n_clients,
                                                         cfg.client_num_per_round))
    sim.global_vars = init
    assert sim.capacity == ref_sim.capacity
    assert ref_algorithms.create(ref_cfg).name == sim.algorithm.name == "FedSGD"
    ref_hist, hist = ref_sim.run(), sim.run()
    ref_final = weights.to_torch(weights.flax_to_torch(
        jax.tree_util.tree_map(np.asarray, ref_sim.global_vars)))
    return cfg, ref_sim, sim, init, ref_final, ref_hist, hist, scales


def _check_history(ref_hist, hist, cfg):
    assert len(hist) == len(ref_hist) == cfg.comm_round
    for a, b in zip(hist, ref_hist):
        assert a["train_loss"] == b["train_loss"] == 0.0 and a["num_steps"] == b["num_steps"] == 1.0
        np.testing.assert_allclose(a["num_samples"], b["num_samples"], rtol=1e-6)
    for k in ("test_loss", "test_acc"):
        np.testing.assert_allclose(hist[-1][k], ref_hist[-1][k], rtol=2e-2, atol=1e-6, err_msg=k)


def test_two_fedsgd_qsgd_int8_rounds_match_jax_sp(tmp_path):
    from fedml_tpu_torch.core import pytree as pt

    cfg, ref_sim, sim, init, ref_final, ref_hist, hist, scales = _run_pair(tmp_path)
    _check_history(ref_hist, hist, cfg)
    got, want, w0 = _flat(sim.global_vars["params"]), _flat(ref_final["params"]), _flat(init["params"])
    bound = cfg.server_lr * sum(scales.values()) + 1e-5
    assert sorted(scales) == [0, 1]
    assert float((got - want).abs().max()) <= bound
    assert float((got - want).norm()) <= 1e-2 * float((want - w0).norm())
    assert float((want - w0).abs().max()) > 10 * bound  # the rounds moved the weights
    # batch stats are never updated; no client state without eftopk
    for a, b in zip(pt.tree_leaves(sim.global_vars["batch_stats"]),
                    pt.tree_leaves(init["batch_stats"])):
        assert torch.equal(a, b)
    assert sim.client_states is None and ref_sim.client_states is None


def test_two_fedsgd_eftopk_rounds_match_jax_sp(tmp_path):
    cfg, ref_sim, sim, init, ref_final, ref_hist, hist, _ = _run_pair(
        tmp_path, compression="eftopk", client_num_per_round=4)
    _check_history(ref_hist, hist, cfg)
    got, want, w0 = _flat(sim.global_vars["params"]), _flat(ref_final["params"]), _flat(init["params"])
    res_got = sim.client_states
    res_ref = torch.from_numpy(np.array(ref_sim.client_states))
    assert res_got.shape == res_ref.shape == (4, w0.numel())
    assert bool((res_got.abs().sum(1) > 0).all())
    counts = torch.as_tensor(sim.counts, dtype=torch.float32)
    p = (counts / counts.sum())[:, None]
    virt_got = got - cfg.server_lr * (p * res_got).sum(0)
    virt_ref = want - cfg.server_lr * (p * res_ref).sum(0)
    upd = float((want - w0).norm())
    assert float((virt_got - virt_ref).norm()) <= 2e-3 * float((virt_ref - w0).norm())
    assert float((got - want).norm()) <= 5e-2 * upd
    assert float((res_got - res_ref).norm()) <= 5e-2 * float(res_ref.norm())


def test_server_optimizer_matches_optax():
    """sgd with and without momentum: optax's update order, bitwise."""
    import optax

    from fedml_tpu_torch.fl.algorithm import make_server_optimizer
    from fedml_tpu_torch.fl.types import HParams

    rs = np.random.RandomState(2)
    p0 = {"a": rs.randn(5, 3).astype(np.float32), "b": rs.randn(4).astype(np.float32)}
    grads = [{k: rs.randn(*v.shape).astype(np.float32) for k, v in p0.items()} for _ in range(3)]
    for lr, mom in ((1.0, 0.0), (0.3, 0.9)):
        tx = optax.sgd(lr, momentum=mom or None)
        ref_p, ref_s = jax.tree_util.tree_map(jnp.asarray, p0), None
        ref_s = tx.init(ref_p)
        opt = make_server_optimizer(HParams(server_lr=lr, server_momentum=mom))
        got_p = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
        got_s = opt.init(got_p)
        for g in grads:
            upd, ref_s = tx.update(jax.tree_util.tree_map(jnp.asarray, g), ref_s, ref_p)
            ref_p = optax.apply_updates(ref_p, upd)
            got_p, got_s = opt.update({k: torch.from_numpy(v) for k, v in g.items()}, got_s, got_p)
        for k in p0:
            np.testing.assert_array_equal(got_p[k].numpy(), np.asarray(ref_p[k]))


def test_server_optimizer_refusals():
    """The FedOpt optimizers are built (their numerics:
    ``tests/test_torch_algorithms.py``); an unknown name is refused."""
    from fedml_tpu_torch.fl import optim
    from fedml_tpu_torch.fl.algorithm import make_server_optimizer
    from fedml_tpu_torch.fl.types import HParams

    for name, cls in (("adam", optim.Adam), ("adagrad", optim.Adagrad), ("yogi", optim.Yogi)):
        opt = make_server_optimizer(HParams(server_optimizer=name, server_lr=0.25))
        assert type(opt) is cls and opt.lr == 0.25
    adam = make_server_optimizer(HParams(server_optimizer="adam"))
    assert (adam.b1, adam.b2, adam.eps, adam.weight_decay) == (0.9, 0.99, 1e-3, None)
    with pytest.raises(ValueError, match="unknown server optimizer"):
        make_server_optimizer(HParams(server_optimizer="lamb"))


def test_fedsgd_recipe_shape_through_runner_on_cpu(tmp_path):
    """The slice through its public entry points on the CPU with the port's
    own randomness, on the MESH backend (the round's clients as the lanes
    of one batched gradient): eftopk keeps a non-zero residual per client,
    metrics are finite, train_loss is 0, learning_rate plays no part, and
    the batch statistics never move."""
    import fedml_tpu_torch
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.ops import quantize as q
    from fedml_tpu_torch.runner import FedMLRunner

    finals = {}
    for lr in (0.1, 0.5):
        _, cfg = _cfgs(tmp_path, compression="eftopk", client_num_per_round=4, comm_round=2,
                       learning_rate=lr, compute_dtype="bfloat16", partition_method="homo",
                       backend_sim="MESH")
        runner = FedMLRunner(fedml_tpu_torch.init(cfg), device="cpu")
        sim = runner.runner
        assert sim.backend == "MESH"
        init_stats = pt.tree_map(torch.clone, sim.global_vars["batch_stats"])
        hist = runner.run()
        assert [h["round"] for h in hist] == [0, 1]
        assert all(h["train_loss"] == 0.0 and h["num_steps"] == 1.0 for h in hist)
        assert np.isfinite(hist[-1]["test_loss"]) and 0.0 <= hist[-1]["test_acc"] <= 1.0
        assert bool((sim.client_states.abs().sum(1) > 0).all())
        for a, b in zip(pt.tree_leaves(sim.global_vars["batch_stats"]), pt.tree_leaves(init_stats)):
            assert torch.equal(a, b)
        finals[lr] = _flat(sim.global_vars["params"])
    assert torch.equal(finals[0.1], finals[0.5])
    # qsgd_int8 through the runner on the CPU: plain versions, no launches
    _, cfg = _cfgs(tmp_path, comm_round=1, compute_dtype="bfloat16", backend_sim="MESH")
    q.reset_launch_counts()
    hist = FedMLRunner(fedml_tpu_torch.init(cfg), device="cpu").run()
    assert np.isfinite(hist[-1]["test_loss"])
    assert all(v == 0 for v in q.launch_counts().values())


def test_default_sampler_compression_draw():
    """ClientSampler.uniform: U[0, 1), reproducible per (round, client),
    distinct across clients and rounds."""
    from fedml_tpu_torch.sim.engine import ClientSampler

    s = ClientSampler(0, 8, 4)
    a = s.uniform(1, 2, (3, 8, 128), "cpu")
    assert a.shape == (3, 8, 128) and a.dtype == torch.float32
    assert float(a.min()) >= 0.0 and float(a.max()) < 1.0
    assert torch.equal(a, s.uniform(1, 2, (3, 8, 128), "cpu"))
    assert not torch.equal(a, s.uniform(1, 3, (3, 8, 128), "cpu"))
    assert not torch.equal(a, s.uniform(2, 2, (3, 8, 128), "cpu"))
