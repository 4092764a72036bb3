"""Port parity: the FedAvg family beyond FedAvg (``algorithms/``: FedOpt with
each server optimizer, FedProx, FedNova, SCAFFOLD, FedDyn, Mime), the hooks
of local training (``fl/local_sgd.py``), the optimizers (``fl/optim.py``)
and the cross-silo gates of these algorithms.

Against the JAX package: both simulators on MESH, the reference on a
one-device mesh (as the port runs on one card), with the reference's
initial weights, sampled ids and permutations handed to the port
(``tests/test_torch_mesh.py``'s sampler hook).  2 rounds of 3 of 6
clients, f32, on a logistic regression over the ``synthetic`` features
(every algorithm) and on the port's fused ``CifarResNet(1)`` (FedOpt with
a server Adam, FedProx, FedNova, SCAFFOLD, FedDyn, Mime; the other server
optimizers change nothing model-specific and are held on the regression
and against optax).  The reference side of the ResNet runs its unfused
``CifarResNet(1)``: the same function (its own tests hold its fused kernel
to it) at half the compile time, so the port's kernels and hooks are held
against the plain math.

Tolerances.  The global variables are compared as updates from the shared
initial weights (relative L2 of the difference over the reference's
update): the logistic regression within ``LR_TOL``; the ResNet within
``tests/test_torch_sim.py``'s 1e-2 (its f32 gradients lose accuracy on
trained weights, that file says why).  Client and server state carry the
parameters' error scaled:

- SCAFFOLD's ``c_i+ = c_i - c + (x - y) / (K lr)`` multiplies the error of
  the update ``x - y`` by ``1 / (K lr)`` (K = 2-4 steps, lr 0.05: 5-10),
  and its size by the same factor, so ``c_i`` and ``c`` are held at the
  parameters' relative tolerance: in absolute terms the parameter
  tolerance times ``1 / (K lr)``;
- FedDyn's ``lambda_i`` and ``h`` are ``alpha`` (0.01) times sums of
  updates, and the parameters see ``h / alpha``: held at the parameters'
  relative tolerance (absolute: times ``alpha``);
- server optimizer moments, Mime's momentum and FedNova's normalized
  update are linear in the updates (adam's ``mu / sqrt(nu)`` is a ratio):
  the parameters' relative tolerance.

The optimizers alone against optax over 5 steps on random trees: eagerly
(optax's ``update`` op by op) bitwise, except adagrad, whose ``rsqrt``
differs between XLA:CPU and PyTorch by up to one ulp of the result (each
within one ulp of the exact value): held within 2 ulp of each leaf's
largest magnitude.  Under ``jax.jit`` XLA:CPU contracts ``a * b + c`` (the
moments, ``p + u * (-lr)``) into one FMA, which PyTorch's separate ops do
not: there all are held within 2 ulp of each leaf's largest magnitude
(measured: at most 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from .test_torch_mesh import JaxSampler, _jax_sim, _port_vars

torch.set_num_threads(1)

MESH_SP = dict(rtol=2e-4, atol=2e-5)
LR_TOL = 1e-5
RESNET_TOL = 1e-2
# one client's state (SCAFFOLD's c_i, FedDyn's lambda_i) carries that client's
# own update, not an average over clients: with the ResNet, the reference's
# per-leaf gradient error of up to 2.6e-2 (tests/test_torch_sim.py) shows
# unaveraged; held at tests/test_torch_sim.py's per-leaf bound
RESNET_CLIENT_TOL = 5e-2

ALGOS = {
    "fedopt_sgdm": dict(federated_optimizer="FedOpt", server_optimizer="sgd", server_lr=1.0,
                        server_momentum=0.9),
    "fedopt_adam": dict(federated_optimizer="FedOpt", server_optimizer="adam", server_lr=0.01),
    "fedopt_adagrad": dict(federated_optimizer="FedOpt", server_optimizer="adagrad",
                           server_lr=0.01),
    "fedopt_yogi": dict(federated_optimizer="FedOpt", server_optimizer="yogi", server_lr=0.01),
    "fedprox": dict(federated_optimizer="FedProx", fedprox_mu=0.1),
    "fednova": dict(federated_optimizer="FedNova", momentum=0.9),
    "scaffold": dict(federated_optimizer="SCAFFOLD"),
    "feddyn": dict(federated_optimizer="FedDyn"),
    "mime": dict(federated_optimizer="Mime"),
    "fedavg_adam": dict(federated_optimizer="FedAvg", client_optimizer="adam",
                        weight_decay=1e-3),
}
CASES = [("lr", a) for a in sorted(ALGOS)] + [("resnet", a) for a in (
    "fedopt_adam", "fedprox", "fednova", "scaffold", "feddyn", "mime")]


def _cfgs(tmp_path, model, **kw):
    """6 Dirichlet clients (the ResNet's 96 images, the regression's 120
    samples) of 13-27 samples, 3 a round: over 2 rounds at least one client
    is never sampled, and in round 1 the lanes' budgets differ (the
    regression's 3, 4, 3 steps of 8; the ResNet's 2, 2, 3), so the lanes run
    in another order than the clients'."""
    import fedml_tpu.arguments as ref_args
    import fedml_tpu_torch.arguments as args

    base = dict(client_num_in_total=6, client_num_per_round=3, comm_round=2, epochs=1,
                batch_size=8, learning_rate=0.05, synthetic_train_size=96,
                synthetic_test_size=40, partition_method="hetero", partition_alpha=0.5,
                frequency_of_the_test=0, compute_dtype="float32", random_seed=0,
                backend_sim="MESH", data_cache_dir=str(tmp_path))
    if model == "lr":
        base.update(dataset="synthetic", model="lr", synthetic_train_size=120)
    else:
        base.update(dataset="cifar10", model="resnet20", extra={"fused_blocks": True})
    base.update(kw)
    return ref_args.Config(**base), args.Config(**base)


def _models(model):
    from fedml_tpu.models import resnet as flax_resnet, simple as flax_simple
    from fedml_tpu_torch.models import resnet, simple

    if model == "lr":
        return flax_simple.LogisticRegression(10), simple.LogisticRegression(10, 60)
    return flax_resnet.CifarResNet(num_blocks=1), resnet.CifarResNet(1, fused=True)


def _ref_flat(tree) -> np.ndarray:
    """A reference tree (flax layout) as one f64 vector in JAX leaf order."""
    leaves = jax.tree_util.tree_leaves(tree)
    return (np.concatenate([np.asarray(a, np.float64).ravel() for a in leaves]) if leaves
            else np.zeros(0))


def _port_flat(tree) -> np.ndarray:
    """A port tree as the reference's flat vector (flax kernels, JAX order)."""
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.core import pytree as pt

    if not isinstance(tree, dict) or not pt.tree_leaves(tree):
        return np.zeros(0)
    return weights.flatten_reference(tree)[0].double().numpy()


def _rel(got, want, start=None) -> float:
    """Relative L2 of ``got - want`` over ``want - start`` (or ``want``)."""
    scale = np.linalg.norm(want - (0 if start is None else start))
    return float(np.linalg.norm(got - want) / max(scale, 1e-30))


def _port_sim(cfg, model, sampler=None):
    import fedml_tpu_torch
    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.sim.engine import MeshSimulator

    fedml_tpu_torch.init(cfg)
    return MeshSimulator(cfg, loader.load(cfg), model, device="cpu", sampler=sampler)


def _row(states, ci):
    from fedml_tpu_torch.core import pytree as pt

    return pt.tree_map(lambda t: t[ci], states)


@pytest.mark.parametrize("model,algo", CASES)
def test_two_rounds_match_jax_mesh(tmp_path, model, algo):
    """2 rounds on MESH against the JAX package's MESH: round metrics, the
    globals, every client's state (the rows of clients never sampled
    bitwise their initial zeros) and the server state (module docstring
    for the tolerances)."""
    from fedml_tpu_torch.core import pytree as pt

    ref_cfg, cfg = _cfgs(tmp_path, model, **ALGOS[algo])
    ref_model, port_model = _models(model)
    ref_sim = _jax_sim(ref_cfg, ref_model)
    init = _port_vars(ref_sim.global_vars)
    sim = _port_sim(cfg, port_model, JaxSampler(ref_sim.root_key, 6, 3))
    sim.global_vars = pt.tree_map(torch.clone, init)
    sim.server_state = sim.algorithm.init_server_state(sim.global_vars)
    tol = LR_TOL if model == "lr" else RESNET_TOL
    ref_hist, hist = ref_sim.run(), sim.run()
    assert sim.backend == ref_sim.backend == "MESH" and len(hist) == len(ref_hist) == 2
    for a, b in zip(hist, ref_hist):
        for k in ("num_steps", "num_samples"):
            assert a[k] == pytest.approx(b[k], rel=1e-6), k
        assert a["train_loss"] == pytest.approx(b["train_loss"], rel=tol), "train_loss"
    got, want, start = (_port_flat(sim.global_vars), _ref_flat(ref_sim.global_vars),
                        _port_flat(init))
    assert _rel(got, want, start) <= tol
    assert np.abs(want - start).max() > 1e-3  # training moved the weights: not vacuous
    ref_server, got_server = _ref_flat(ref_sim.server_state), _port_flat(sim.server_state)
    assert got_server.shape == ref_server.shape
    if ref_server.size:
        assert _rel(got_server, ref_server) <= tol
    if ref_sim.client_states is None:
        assert sim.client_states is None
        return
    sampled = {int(c) for r in range(2) for c in sim.sampler.sample(r)}
    assert len(sampled) < 6
    for ci in range(6):
        ref_row = _ref_flat(jax.tree_util.tree_map(lambda a, ci=ci: np.asarray(a)[ci],
                                                   ref_sim.client_states))
        got_row = _port_flat(_row(sim.client_states, ci))
        if ci in sampled:
            assert np.abs(ref_row).max() > 0
            assert _rel(got_row, ref_row) <= (LR_TOL if model == "lr" else RESNET_CLIENT_TOL)
        else:  # never sampled: still the initial state, bitwise
            assert not got_row.any() and not ref_row.any()


@pytest.mark.parametrize("algo", sorted(ALGOS))
def test_mesh_equals_sp(tmp_path, algo):
    """The port's MESH round against its own sequential twin, 2 rounds of
    the logistic regression: globals, client and server state within the
    reference's MESH-vs-SP tolerance (``tests/test_m0_fedavg.py``)."""
    from fedml_tpu_torch.models import simple

    sims = {}
    for backend in ("MESH", "sp"):
        _, cfg = _cfgs(tmp_path, "lr", backend_sim=backend, **ALGOS[algo])
        sims[backend] = _port_sim(cfg, simple.LogisticRegression(10, 60))
        assert sims[backend].backend == backend and len(sims[backend].run()) == 2
    mesh, sp = sims["MESH"], sims["sp"]
    for a, b in ((mesh.global_vars, sp.global_vars), (mesh.server_state, sp.server_state),
                 (mesh.client_states, sp.client_states)):
        assert type(a) is type(b) and len(_leaves(a)) == len(_leaves(b))
        for x, y in zip(_leaves(a), _leaves(b)):
            np.testing.assert_allclose(x.numpy(), y.numpy(), **MESH_SP)


def _optax_pairs():
    from fedml_tpu_torch.fl import algorithm, local_sgd
    from fedml_tpu_torch.fl.types import HParams

    server = {name: (tx, algorithm.make_server_optimizer(HParams(server_optimizer=name,
                                                                 server_lr=lr,
                                                                 server_momentum=mom)))
              for name, tx, lr, mom in (
                  ("sgd", optax.sgd(0.5, momentum=0.9), 0.5, 0.9),
                  ("adam", optax.adam(0.01, b1=0.9, b2=0.99, eps=1e-3), 0.01, 0.0),
                  ("adagrad", optax.adagrad(0.1), 0.1, 0.0),
                  ("yogi", optax.yogi(0.1), 0.1, 0.0))}
    client = {"client_adam": (optax.adamw(0.01, weight_decay=0.1), local_sgd.make_optimizer(
        HParams(client_optimizer="adam", learning_rate=0.01, weight_decay=0.1)))}
    return {**server, **client}


@pytest.mark.parametrize("name", ["sgd", "adam", "adagrad", "yogi", "client_adam"])
def test_optimizers_match_optax(name):
    """5 steps on a random tree of two leaves against optax 0.2.6: bitwise
    against optax called eagerly (adagrad within 2 ulp: ``rsqrt``), within
    2 ulp under ``jax.jit`` (FMA contraction); module docstring."""
    tx, opt = _optax_pairs()[name]
    rs = np.random.RandomState(0)
    p0 = {"a": rs.randn(7, 5).astype(np.float32), "b": {"c": rs.randn(33).astype(np.float32)}}
    grads = [jax.tree_util.tree_map(lambda a: rs.randn(*a.shape).astype(np.float32), p0)
             for _ in range(5)]

    def step(g, s, p):
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u), s

    for mode, fn in (("eager", step), ("jit", jax.jit(step))):
        ref_p = jax.tree_util.tree_map(jnp.asarray, p0)
        ref_s = tx.init(ref_p)
        got_p = jax.tree_util.tree_map(lambda a: torch.from_numpy(a.copy()), p0)
        got_s = opt.init(got_p)
        for g in grads:
            ref_p, ref_s = fn(jax.tree_util.tree_map(jnp.asarray, g), ref_s, ref_p)
            got_p, got_s = opt.update(jax.tree_util.tree_map(torch.from_numpy, g), got_s, got_p)
        for want, got in zip(jax.tree_util.tree_leaves(ref_p) + jax.tree_util.tree_leaves(ref_s),
                             _leaves(got_p) + _leaves(got_s)):
            want, got = np.asarray(want), got.numpy()
            assert got.shape == want.shape and got.dtype == want.dtype
            if mode == "eager" and name != "adagrad":
                np.testing.assert_array_equal(got, want)
            else:
                ulps = np.abs(got - want) / np.spacing(np.abs(want).max())
                assert ulps.max() <= 2, (mode, ulps.max())


def _leaves(tree):
    from fedml_tpu_torch.core import pytree as pt

    return [] if tree is None or isinstance(tree, tuple) else pt.tree_leaves(tree)


def test_adam_lanes_keep_a_spent_lanes_state_bitwise():
    """Adam over 3 lane-stacked trees, the active lanes a prefix that
    shrinks (3, 3, 2, 1 of 3), as the batched step drives it: each lane's
    count, moments and parameters bitwise those of the lane run alone for
    its own number of steps, and a spent lane's untouched from then on."""
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.fl.optim import Adam

    opt = Adam(0.01, weight_decay=0.1)
    rs = np.random.RandomState(1)
    params = {"w": torch.from_numpy(rs.randn(3, 4, 5).astype(np.float32))}
    grads = [torch.from_numpy(rs.randn(3, 4, 5).astype(np.float32)) for _ in range(4)]
    state = opt.init(params, lanes=3)
    assert state["count"].shape == (3,) and state["count"].dtype == torch.int32
    for g, n in zip(grads, (3, 3, 2, 1)):
        new_p, new_s = opt.update({"w": g[:n]}, pt.tree_head(state, n), pt.tree_head(params, n))
        pt.tree_set_head_(params, n, new_p)
        pt.tree_set_head_(state, n, new_s)
    assert state["count"].tolist() == [4, 3, 2]
    for lane, steps in enumerate((4, 3, 2)):
        p, s = {"w": params["w"][lane].clone()}, None
        p = {"w": torch.from_numpy(np.random.RandomState(1).randn(3, 4, 5).astype(
            np.float32))[lane]}
        s = opt.init(p)
        for g in grads[:steps]:
            p, s = opt.update({"w": g[lane]}, s, p)
        assert int(s["count"]) == steps
        assert torch.equal(params["w"][lane], p["w"])
        assert torch.equal(state["mu"]["w"][lane], s["mu"]["w"])
        assert torch.equal(state["nu"]["w"][lane], s["nu"]["w"])


def test_scaffold_batched_step_matches_lanes_alone():
    """SCAFFOLD's corrected local SGD for 3 lanes of a fused ResNet in f32,
    the lanes' budgets 2, 6 and 4 steps (counts 5, 20, 13; not in budget
    order) and each lane its own ``c_i``: each lane's variables within 1e-5
    of the lane trained alone with its own ``c_i`` (relative to the leaf, as
    ``tests/test_torch_mesh.py`` holds FedAvg's batched step), its new
    ``c_i`` and ``delta_c`` within that bound times ``1 / (K lr)`` (the
    parameters' error, amplified; K its budget, lr 0.05).  A ``c_i`` left
    in client order would give a lane another client's control variate once
    the lanes are sorted by budget."""
    from fedml_tpu_torch.algorithms.scaffold import Scaffold
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.fl.types import HParams
    from fedml_tpu_torch.models import resnet

    from .test_torch_mesh import _lane_problem

    variables, x, y, perms, _, _ = _lane_problem(momentum=0.0, epochs=2)
    hp = HParams(batch_size=8, steps_per_epoch=3, epochs=2, learning_rate=0.05)
    algo = Scaffold(hp).build(resnet.CifarResNet(1, fused=True))
    rs = np.random.RandomState(5)
    c = pt.tree_map(lambda t: torch.from_numpy(rs.randn(*t.shape).astype(np.float32)),
                    variables["params"])
    c_lanes = pt.tree_map(lambda t: torch.from_numpy(rs.randn(3, *t.shape).astype(np.float32)),
                          variables["params"])
    clients, counts = torch.tensor([2, 0, 1]), np.array([5, 20, 13])
    out = algo.client_update_lanes(variables, c_lanes, c, x, y, clients, counts,
                                   perms=perms[[2, 0, 1]])
    assert out.metrics["num_steps"].tolist() == [2, 6, 4]
    for lane, (ci, k) in enumerate(zip([2, 0, 1], [2, 6, 4])):
        alone = algo.client_update(variables, _row(c_lanes, lane), c, x[ci], y[ci],
                                   int(counts[lane]), None, perms=perms[ci])
        got, want = out.contribution["variables"], alone.contribution["variables"]
        for a, b in zip(_leaves(want), _leaves(got)):
            assert float((a - b[lane]).abs().max()) <= 1e-5 * float(a.abs().max())
        for a, b, p in zip(_leaves(alone.client_state) + _leaves(alone.contribution["delta_c"]),
                           _leaves(out.client_state) + _leaves(out.contribution["delta_c"]),
                           2 * _leaves(want["params"])):
            bound = 1e-5 * float(p.abs().max()) / (k * hp.learning_rate)
            assert float((a - b[lane]).abs().max()) <= bound


@pytest.mark.parametrize("algo", sorted(ALGOS))
def test_associative_fold_gate_matches_reference(algo):
    """``config_supports_associative_fold`` (the secure-aggregation gate)
    answers as the reference's for every algorithm."""
    import fedml_tpu.arguments as ref_args
    import fedml_tpu_torch.arguments as args
    from fedml_tpu.fl.algorithm import config_supports_associative_fold as ref_gate
    from fedml_tpu_torch.fl.algorithm import config_supports_associative_fold

    kw = {k: v for k, v in ALGOS[algo].items()}
    assert config_supports_associative_fold(args.Config(**kw)) == ref_gate(ref_args.Config(**kw))


def _cross_silo_cfg(tmp_path, **kw):
    from fedml_tpu_torch.arguments import Config

    base = dict(training_type="cross_silo", role="server", backend="INPROC", dataset="synthetic",
                model="lr", client_num_in_total=3, client_num_per_round=3, comm_round=2,
                epochs=1, batch_size=8, learning_rate=0.1, synthetic_train_size=120,
                synthetic_test_size=40, partition_method="hetero", partition_alpha=0.5,
                frequency_of_the_test=1, random_seed=0, data_cache_dir=str(tmp_path),
                run_id=f"algos-{kw.get('federated_optimizer', 'FedAvg')}")
    base.update(kw)
    return Config(**base)


def test_cross_silo_fedprox_client_trains_without_the_prox_term(tmp_path):
    """The reference's cross-silo client trains with a plain local SGD
    (``fedml_tpu/cross_silo/client.py:109``: no hooks), so FedProx over the
    wire is FedAvg: the port mirrors it, the final global bitwise the
    FedAvg run's (ROADMAP Queue 3)."""
    import fedml_tpu_torch
    from fedml_tpu_torch.runner import FedMLRunner

    finals = {}
    for name in ("FedProx", "FedAvg"):
        cfg = _cross_silo_cfg(tmp_path, federated_optimizer=name, fedprox_mu=1.0)
        fedml_tpu_torch.init(cfg)
        runner = FedMLRunner(cfg, device="cpu")
        hist = runner.run()
        assert len(hist) == 2 and np.isfinite(hist[-1]["test_loss"])
        assert type(runner.runner.server.aggregator.algorithm).__name__ == name
        finals[name] = runner.runner.server.aggregator.global_vars
    for a, b in zip(_leaves(finals["FedProx"]), _leaves(finals["FedAvg"])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("algo", ["SCAFFOLD", "FedNova", "FedDyn", "Mime"])
def test_cross_silo_refuses_algorithms_without_full_variables(tmp_path, algo):
    """Their client contributions are not the full variables a silo
    uploads: refused with a message, before any data loads."""
    from fedml_tpu_torch.runner import FedMLRunner

    with pytest.raises(NotImplementedError, match="full variables"):
        FedMLRunner(_cross_silo_cfg(tmp_path, federated_optimizer=algo), device="cpu")


def test_shamir_secagg_takes_fedavg_alone(tmp_path):
    """Shamir SecAgg refuses FedOpt (its reconstruction is the uniform mean
    of the survivors' updates), as the reference does; the algorithms it
    takes satisfy ``config_supports_associative_fold``, the reference's
    second gate, which the name check makes unreachable in the port."""
    from fedml_tpu_torch.cross_silo.secagg_shamir import shamir_secagg_params
    from fedml_tpu_torch.fl.algorithm import config_supports_associative_fold
    from fedml_tpu_torch.runner import FedMLRunner

    cfg = _cross_silo_cfg(tmp_path, federated_optimizer="FedOpt", enable_secagg=True,
                          extra={"secagg_method": "shamir"})
    with pytest.raises(NotImplementedError, match="per-client updates"):
        FedMLRunner(cfg, device="cpu")
    for name in ("FedAvg", "FedAvg_seq"):
        cfg = _cross_silo_cfg(tmp_path, federated_optimizer=name, enable_secagg=True,
                              extra={"secagg_method": "shamir"})
        shamir_secagg_params(cfg)
        assert config_supports_associative_fold(cfg)


RECIPES = {
    "sp_fedprox_synthetic_lr": dict(comm_round=3, synthetic_train_size=2000,
                                    synthetic_test_size=400),
    "cross_silo_horizontal_lr": dict(comm_round=3, synthetic_train_size=800,
                                     synthetic_test_size=200, frequency_of_the_test=1),
    "sp_fedopt_cifar10_resnet20": dict(comm_round=2, synthetic_train_size=256,
                                       synthetic_test_size=64, client_num_in_total=8,
                                       client_num_per_round=4, batch_size=8,
                                       frequency_of_the_test=2),
}


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_recipe_runs_shrunk_through_the_runner(tmp_path, recipe):
    """The shipped recipe through ``fedml_tpu_torch.init`` and
    ``FedMLRunner(cfg, device="cpu")``, cut in data, clients and rounds: its
    algorithm, model and dataset as shipped, finite metrics, and the
    logistic regressions learn the synthetic task."""
    from pathlib import Path

    import fedml_tpu_torch
    from fedml_tpu_torch.runner import FedMLRunner

    path = Path(__file__).resolve().parent.parent / "examples" / recipe / "fedml_config.yaml"
    cfg = fedml_tpu_torch.init(argv=["--cf", str(path)])
    for k, v in RECIPES[recipe].items():
        setattr(cfg, k, v)
    cfg.data_cache_dir = str(tmp_path)
    runner = FedMLRunner(cfg, device="cpu")
    hist = runner.run()
    assert len(hist) == cfg.comm_round
    last = hist[-1]
    assert np.isfinite(last["test_loss"]) and 0.0 <= last["test_acc"] <= 1.0
    if cfg.training_type == "simulation":
        sim = runner.runner
        assert sim.backend == "MESH" and type(sim.algorithm).__name__ == cfg.federated_optimizer
    if cfg.model == "lr":
        assert last["test_acc"] > 0.5  # chance is 0.1
