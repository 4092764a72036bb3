"""Port parity: the simulator's MESH backend (``sim/engine.py``
``_run_round_mesh``), every sampled client a lane of one batched round, and
its parts: the batched local train and full gradient (``fl/local_sgd.py``),
the model's lane form (``models/resnet.py``), the lane-batched compression
(``ops/compression.py``), the lane flatten (``algorithms/fedsgd.py``) and the
lane helpers of ``core/pytree.py``.

Against the JAX package: its ``MeshSimulator`` on MESH too (``jax.vmap`` of
the client over the sampled lanes), on a one-device mesh as the port runs on
one card (a lane multiple of 1: no pad lanes), with the reference's sampled
ids, permutations and compression draws handed to the port through the
sampler hook.  f32, ResNet with one block a stage.  Tolerances are
``tests/test_torch_sim.py``'s for FedAvg (round metrics rtol 1e-4, test
metrics rtol 1e-3, the update within 1e-2 relative L2 and each leaf within
5e-2 of its own update's scale: the reference's f32 gradients lose accuracy
on trained weights, see that file) and ``tests/test_torch_fedsgd.py``'s for
FedSGD (stochastic rounding turns an ulp into a level).

Against the port's own sp backend: the reference's MESH-vs-SP tolerance,
rtol 2e-4 / atol 2e-5 (``tests/test_m0_fedavg.py``).  The lane form is the
single-lane math per lane (bitwise on the CPU for most of it; the stem
conv's grouped weight gradient differs in the last bits), and the rounds
that test it are ones whose f32 trajectory that tolerance can hold: the
reference tests a logistic regression, while a ReLU network's trajectory
can jump where a tiny change flips a ReLU.  Measured on the CPU: the
flagship's shape cut to batch 8 (ResNet-20, 4 clients, one round) moves by
up to 1e-3 when its initial weights move by one f32 ulp, on sp alone.  The
rounds below differ between MESH and sp by at most 2.4e-7 (2 rounds, 4
clients) and 1.2e-7 (1 round, 13 clients), and are held to the reference's
tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

MESH_SP = dict(rtol=2e-4, atol=2e-5)


class JaxSampler:
    """The reference's randomness as a port sampler hook: sampled ids,
    per-epoch permutations (``None`` for FedSGD, which takes none) and
    compression draws."""

    def __init__(self, root_key, n_total, per_round, perms=True):
        self.root, self.n_total, self.per_round, self.with_perms = (root_key, n_total, per_round,
                                                                     perms)

    def sample(self, r):
        from fedml_tpu.core import rng

        return np.asarray(rng.sample_clients(self.root, r, self.n_total, self.per_round))

    def perms(self, r, client, epochs, cap):
        from fedml_tpu.core import rng

        if not self.with_perms:
            return None
        key = rng.client_key(rng.round_key(self.root, r), client)
        return torch.from_numpy(np.stack([np.asarray(jax.random.permutation(
            jax.random.fold_in(jax.random.fold_in(key, e), 1), cap)) for e in range(epochs)]))

    def uniform(self, r, client, shape, device):
        from fedml_tpu.core import rng

        key = jax.random.fold_in(rng.client_key(rng.round_key(self.root, r), client), 7)
        return torch.from_numpy(np.array(jax.random.uniform(key, shape, jnp.float32))).to(device)


def _cfgs(tmp_path, **kw):
    import fedml_tpu.arguments as ref_args
    import fedml_tpu_torch.arguments as args

    base = dict(dataset="cifar10", model="resnet20", client_num_in_total=4,
                client_num_per_round=3, comm_round=2, epochs=1, batch_size=8,
                learning_rate=0.05, synthetic_train_size=64, synthetic_test_size=40,
                partition_method="hetero", partition_alpha=0.5, frequency_of_the_test=2,
                compute_dtype="float32", random_seed=0, backend_sim="MESH",
                data_cache_dir=str(tmp_path))
    base.update(kw)
    return ref_args.Config(**base), args.Config(**base)


def _jax_sim(ref_cfg, model):
    """The JAX simulator on MESH over one device."""
    import fedml_tpu
    from fedml_tpu.data import loader as ref_loader
    from fedml_tpu.parallel import mesh as meshlib
    from fedml_tpu.sim.engine import MeshSimulator as JaxSim

    fedml_tpu.init(ref_cfg)
    mesh = meshlib.mesh_from_config(ref_cfg, devices=jax.devices()[:1])
    return JaxSim(ref_cfg, ref_loader.load(ref_cfg), model, mesh=mesh)


def _port_vars(jax_vars):
    from fedml_tpu_torch import weights

    return weights.to_torch(weights.flax_to_torch(jax.tree_util.tree_map(np.asarray, jax_vars)))


def _flat(tree):
    from fedml_tpu_torch import weights

    return weights.flatten_reference(tree)[0]


@pytest.mark.parametrize("fused", [True, False])
def test_two_fedavg_rounds_match_jax_mesh(tmp_path, fused):
    """Two FedAvg rounds of 3 of 4 clients, both packages on MESH: metrics
    and the global state as ``tests/test_torch_sim.py`` holds the sp pair."""
    import fedml_tpu_torch
    from fedml_tpu.models import resnet as flax_resnet
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.models import resnet
    from fedml_tpu_torch.sim.engine import MeshSimulator

    ref_cfg, cfg = _cfgs(tmp_path, extra={"fused_blocks": fused})
    ref_sim = _jax_sim(ref_cfg, flax_resnet.CifarResNet(num_blocks=1, fused=fused))
    init = _port_vars(ref_sim.global_vars)
    fedml_tpu_torch.init(cfg)
    ds = loader.load(cfg)
    sim = MeshSimulator(cfg, ds, resnet.CifarResNet(1, fused=fused), device="cpu",
                        sampler=JaxSampler(ref_sim.root_key, ds.n_clients,
                                           cfg.client_num_per_round))
    sim.global_vars = pt.tree_map(torch.clone, init)
    assert sim.backend == ref_sim.backend == "MESH"
    ref_hist, hist = ref_sim.run(), sim.run()
    assert len(hist) == len(ref_hist) == 2
    for a, b in zip(hist, ref_hist):
        for k in ("train_loss", "num_steps", "num_samples"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)
    for k in ("test_loss", "test_acc"):
        np.testing.assert_allclose(hist[-1][k], ref_hist[-1][k], rtol=1e-3, atol=1e-6, err_msg=k)
    got = [a.numpy() for a in pt.tree_leaves(sim.global_vars)]
    want = [a.numpy() for a in pt.tree_leaves(_port_vars(ref_sim.global_vars))]
    start = [a.numpy() for a in pt.tree_leaves(init)]
    for a, b, i in zip(got, want, start):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.abs(a - b).max() <= 5e-2 * np.abs(b - i).max() + 1e-6
    upd = np.concatenate([(b - i).ravel() for b, i in zip(want, start)])
    diff = np.concatenate([(a - b).ravel() for a, b in zip(got, want)])
    assert np.linalg.norm(diff) <= 1e-2 * np.linalg.norm(upd)
    assert np.abs(upd).max() > 1e-3  # training moved the weights: not vacuous


def _fedsgd_pair(tmp_path, **kw):
    """Both packages' FedSGD on MESH from the reference's initial weights;
    the port records each round's largest block scale over its lanes."""
    import fedml_tpu_torch
    from fedml_tpu.models import resnet as flax_resnet
    from fedml_tpu_torch import algorithms
    from fedml_tpu_torch.algorithms.fedsgd import FedSGD, flatten_reference_lanes
    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.models import resnet
    from fedml_tpu_torch.sim.engine import MeshSimulator

    kw = {"federated_optimizer": "FedSGD", "compression": "qsgd_int8",
          "compression_ratio": 0.05, **kw}
    ref_cfg, cfg = _cfgs(tmp_path, **kw)
    ref_sim = _jax_sim(ref_cfg, flax_resnet.CifarResNet(num_blocks=1))
    init = _port_vars(ref_sim.global_vars)
    fedml_tpu_torch.init(cfg)
    ds = loader.load(cfg)
    scales = {}

    class RecordingFedSGD(FedSGD):
        def client_update_lanes(self, *args, **kwargs):
            out = super().client_update_lanes(*args, **kwargs)
            top = float(flatten_reference_lanes(out.contribution)[0].abs().max()) / 126
            scales[sim.round_idx] = max(scales.get(sim.round_idx, 0.0), top)
            return out

    hp = algorithms.hparams_from_config(cfg, steps_per_epoch=1)
    sim = MeshSimulator(cfg, ds, resnet.CifarResNet(1), algorithm=RecordingFedSGD(hp, cfg),
                        device="cpu", sampler=JaxSampler(ref_sim.root_key, ds.n_clients,
                                                         cfg.client_num_per_round, perms=False))
    sim.global_vars = init
    assert sim.capacity == ref_sim.capacity and sim.backend == ref_sim.backend == "MESH"
    ref_hist, hist = ref_sim.run(), sim.run()
    assert len(hist) == len(ref_hist) == cfg.comm_round
    for a, b in zip(hist, ref_hist):
        assert a["train_loss"] == b["train_loss"] == 0.0 and a["num_steps"] == b["num_steps"] == 1.0
        np.testing.assert_allclose(a["num_samples"], b["num_samples"], rtol=1e-6)
    for k in ("test_loss", "test_acc"):
        np.testing.assert_allclose(hist[-1][k], ref_hist[-1][k], rtol=2e-2, atol=1e-6, err_msg=k)
    return cfg, ref_sim, sim, init, _port_vars(ref_sim.global_vars), scales


def test_fedsgd_qsgd_int8_mesh_matches_jax_mesh(tmp_path):
    """Two FedSGD ``qsgd_int8`` rounds of 3 of 4 clients on MESH, each
    lane's draw the reference's: each weight within ``server_lr`` times the
    rounds' largest block scales (a flipped level of the coarsest block a
    round) plus 1e-5, the update within 1e-2 relative L2."""
    cfg, ref_sim, sim, init, ref_final, scales = _fedsgd_pair(tmp_path)
    got, want, w0 = _flat(sim.global_vars["params"]), _flat(ref_final["params"]), _flat(
        init["params"])
    bound = cfg.server_lr * sum(scales.values()) + 1e-5
    assert sorted(scales) == [0, 1]
    assert float((got - want).abs().max()) <= bound
    assert float((got - want).norm()) <= 1e-2 * float((want - w0).norm())
    assert float((want - w0).abs().max()) > 10 * bound  # the rounds moved the weights
    assert sim.client_states is None and ref_sim.client_states is None


def test_fedsgd_eftopk_mesh_matches_jax_mesh(tmp_path):
    """Two FedSGD ``eftopk`` rounds of all 4 clients on MESH: the residuals
    gathered and scattered per lane; error feedback conserves ``sent +
    residual``, so the virtual iterate within 2e-3 relative L2, the weights'
    update and the residuals each within 5e-2 (``tests/test_torch_fedsgd.py``
    says why)."""
    cfg, ref_sim, sim, init, ref_final, _ = _fedsgd_pair(tmp_path, compression="eftopk",
                                                         client_num_per_round=4)
    got, want, w0 = _flat(sim.global_vars["params"]), _flat(ref_final["params"]), _flat(
        init["params"])
    res_got = sim.client_states
    res_ref = torch.from_numpy(np.array(ref_sim.client_states))
    assert res_got.shape == res_ref.shape == (4, w0.numel())
    assert bool((res_got.abs().sum(1) > 0).all())
    counts = torch.as_tensor(sim.counts, dtype=torch.float32)
    p = (counts / counts.sum())[:, None]
    virt_got = got - cfg.server_lr * (p * res_got).sum(0)
    virt_ref = want - cfg.server_lr * (p * res_ref).sum(0)
    assert float((virt_got - virt_ref).norm()) <= 2e-3 * float((virt_ref - w0).norm())
    assert float((got - want).norm()) <= 5e-2 * float((want - w0).norm())
    assert float((res_got - res_ref).norm()) <= 5e-2 * float(res_ref.norm())


def _port_sim(tmp_path, backend, fused=True, **kw):
    import fedml_tpu_torch
    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.models import resnet
    from fedml_tpu_torch.sim.engine import MeshSimulator

    _, cfg = _cfgs(tmp_path, backend_sim=backend, frequency_of_the_test=0, **kw)
    fedml_tpu_torch.init(cfg)
    return MeshSimulator(cfg, loader.load(cfg), resnet.CifarResNet(1, fused=fused), device="cpu")


def _assert_mesh_equals_sp(mesh, sp):
    from fedml_tpu_torch.core import pytree as pt

    a, b = pt.tree_leaves(mesh.global_vars), pt.tree_leaves(sp.global_vars)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), **MESH_SP)


@pytest.mark.parametrize("fused", [True, False])
def test_mesh_equals_sp_backend(tmp_path, fused):
    """Two rounds of 3 of 4 clients: the batched round and the sequential
    twin give the same global state (``test_mesh_equals_sp_backend`` of the
    reference, its tolerance)."""
    sims = {}
    for backend in ("MESH", "sp"):
        sims[backend] = _port_sim(tmp_path, backend, fused)
        hist = sims[backend].run()
        assert len(hist) == 2
    _assert_mesh_equals_sp(sims["MESH"], sims["sp"])


def test_mesh_equals_sp_on_undivisible_shapes(tmp_path):
    """13 clients, 5 a round, Dirichlet shards of 10-23 samples (budgets of
    2 and 3 steps): one round, the lanes' budgets ragged."""
    sims = {}
    for backend in ("MESH", "sp"):
        sims[backend] = _port_sim(tmp_path, backend, client_num_in_total=13,
                                  client_num_per_round=5, synthetic_train_size=208, comm_round=1)
        sims[backend].run()
    sim = sims["MESH"]
    own = -(-sim.counts[sim.sampler.sample(0)] // sim.cfg.batch_size)
    assert len(set(own.tolist())) > 1  # ragged budgets: lanes drop out mid-round
    _assert_mesh_equals_sp(sims["MESH"], sims["sp"])


def _lane_problem(momentum=0.9, epochs=2, step_mode="match", fused=True):
    """A lane-batched local train of 3 lanes on 3 clients' shards of 24
    (batch 8: 3 steps an epoch) with its single-lane twin."""
    from fedml_tpu_torch.fl.local_sgd import make_batched_local_train_fn, make_local_train_fn
    from fedml_tpu_torch.fl.types import HParams
    from fedml_tpu_torch.models import resnet

    model = resnet.CifarResNet(1, fused=fused)
    variables = model.init(torch.Generator().manual_seed(0))
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(3, 24, 8, 8, 3).astype(np.float32))
    y = torch.from_numpy(rs.randint(0, 10, (3, 24))).long()
    perms = torch.from_numpy(np.stack([np.stack([rs.permutation(24) for _ in range(epochs)])
                                       for _ in range(3)]))
    hp = HParams(batch_size=8, steps_per_epoch=3, momentum=momentum, epochs=epochs,
                 learning_rate=0.05, step_mode=step_mode)
    return (variables, x, y, perms, make_batched_local_train_fn(model, hp),
            make_local_train_fn(model, hp))


def _lanes_of(variables, lanes):
    from fedml_tpu_torch.core import pytree as pt

    return pt.tree_map(lambda t: t.unsqueeze(0).expand((lanes,) + t.shape), variables)


@pytest.mark.parametrize("step_mode", ["match", "fixed"])
@pytest.mark.parametrize("fused", [True, False])
def test_batched_local_train_matches_single_lane(step_mode, fused):
    """Momentum 0.9, 2 epochs, budgets of 2, 6 and 4 steps (counts 5, 20,
    13; lanes not in budget order): each lane's variables within 1e-5 of
    the single-lane train's (relative to the leaf; measured 1.4e-6), its
    metrics within 1e-6; ``fixed`` runs every lane every step."""
    from fedml_tpu_torch.core import pytree as pt

    variables, x, y, perms, batched, single = _lane_problem(step_mode=step_mode, fused=fused)
    clients, counts = torch.tensor([2, 0, 1]), np.array([5, 20, 13])
    new, metrics = batched(_lanes_of(variables, 3), x, y, clients, counts, perms[[2, 0, 1]])
    want_steps = [2, 6, 4] if step_mode == "match" else [6, 6, 6]
    assert metrics["num_steps"].tolist() == want_steps
    assert metrics["num_samples"].tolist() == counts.tolist()
    for lane, c in enumerate([2, 0, 1]):
        one, m = single(variables, x[c], y[c], int(counts[lane]), None, perms=perms[c])
        assert float(m["num_steps"]) == want_steps[lane]
        np.testing.assert_allclose(float(metrics["train_loss"][lane]), float(m["train_loss"]),
                                   rtol=1e-6)
        for a, b in zip(pt.tree_leaves(one), pt.tree_leaves(new)):
            assert float((a - b[lane]).abs().max()) <= 1e-5 * float(a.abs().max())


def test_match_mode_freezes_spent_lanes_bitwise():
    """``step_mode="match"``: lane A (8 samples, 1 step an epoch) runs out
    after step 2 of 6 while lane B goes on.  A's params, BN statistics and
    train loss are bitwise those of a run in which both lanes stop after
    step 2: frozen from that step on, as the reference's ``where(active,
    ...)`` keeps them (the same lanes in the same order until then)."""
    from fedml_tpu_torch.core import pytree as pt

    variables, x, y, perms, batched, _ = _lane_problem()
    clients = torch.tensor([0, 1])  # lane 0: B, lane 1: A
    long_new, long_m = batched(_lanes_of(variables, 2), x, y, clients, np.array([24, 8]), perms)
    short_new, short_m = batched(_lanes_of(variables, 2), x, y, clients, np.array([8, 8]), perms)
    assert long_m["num_steps"].tolist() == [6, 2] and short_m["num_steps"].tolist() == [2, 2]
    for a, b in zip(pt.tree_leaves(long_new), pt.tree_leaves(short_new)):
        assert torch.equal(a[1], b[1])
    assert torch.equal(long_m["train_loss"][1], short_m["train_loss"][1])
    moved = [not torch.equal(a[0], b[0]) for a, b in zip(pt.tree_leaves(long_new),
                                                          pt.tree_leaves(short_new))]
    assert any(moved)  # B went on training: not vacuous


def test_batched_full_grad_matches_single_lane():
    """The FedSGD gradient of 3 lanes at the same weights, each lane its own
    BN statistics: every lane within rtol 1e-5 / atol 1e-7 of the
    single-lane full gradient of its shard."""
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.fl.local_sgd import make_batched_full_grad_fn, make_full_grad_fn
    from fedml_tpu_torch.fl.types import HParams
    from fedml_tpu_torch.models import resnet

    model = resnet.CifarResNet(1)
    variables = model.init(torch.Generator().manual_seed(1))
    rs = np.random.RandomState(1)
    x = torch.from_numpy(rs.randn(4, 20, 8, 8, 3).astype(np.float32))
    y = torch.from_numpy(rs.randint(0, 10, (4, 20))).long()
    hp = HParams(batch_size=8)
    clients = torch.tensor([3, 0, 2])
    grads = make_batched_full_grad_fn(model, hp)(variables, x, y, clients)
    single = make_full_grad_fn(model, hp)
    for lane, c in enumerate(clients.tolist()):
        want = single(variables, x[c], y[c])
        for a, b in zip(pt.tree_leaves(want), pt.tree_leaves(grads)):
            assert b.shape == (3,) + a.shape
            torch.testing.assert_close(b[lane], a, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("fused", [True, False])
def test_lane_apply_matches_per_lane_apply(fused):
    """The model's lane form (grouped convs, per-lane BN, batched Dense) on 3
    lanes of different weights: logits, new batch stats and the gradient of
    the summed per-lane losses within 1e-5 of each lane alone (relative to
    the leaf)."""
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.models import resnet

    model = resnet.CifarResNet(1, fused=fused)
    lanes = [model.init(torch.Generator().manual_seed(k)) for k in range(3)]
    stacked = pt.tree_stack(lanes)
    x = torch.from_numpy(np.random.RandomState(2).randn(3, 4, 8, 8, 3).astype(np.float32))
    leaves = [t.detach().requires_grad_(True) for t in pt.tree_leaves(stacked["params"])]
    params = pt.tree_unflatten_like(stacked["params"], leaves)
    logits, stats = model.apply({"params": params, "batch_stats": stacked["batch_stats"]}, x)
    assert logits.shape == (3, 4, 10)
    grads = torch.autograd.grad(logits.square().mean((1, 2)).sum(), leaves)
    for lane, v in enumerate(lanes):
        one = [t.detach().requires_grad_(True) for t in pt.tree_leaves(v["params"])]
        lo, st = model.apply({"params": pt.tree_unflatten_like(v["params"], one),
                              "batch_stats": v["batch_stats"]}, x[lane])
        g1 = torch.autograd.grad(lo.square().mean(), one)
        torch.testing.assert_close(logits[lane].detach(), lo.detach(), rtol=1e-5, atol=1e-6)
        for a, b in zip(list(g1) + pt.tree_leaves(st), list(grads) + pt.tree_leaves(stats)):
            assert float((a - b[lane]).abs().max()) <= 1e-5 * float(a.abs().max()) + 1e-9


@pytest.mark.parametrize("name", ["topk", "eftopk", "quantize", "qsgd", "qsgd_int8"])
def test_lane_compression_equals_per_lane_calls(name):
    """Each compression operator on the rows of an (L, n) tensor, with
    (L, ...) draws and residuals, is bitwise the operator on each row."""
    from fedml_tpu_torch.ops import compression as comp

    lanes, n = 3, 3000
    rs = np.random.RandomState(4)
    vecs = torch.from_numpy((rs.randn(lanes, n) * np.exp(rs.randn(lanes, n))).astype(np.float32))
    vecs[1] *= 1e3
    shape = comp.draw_shape(name, n)
    noise = (torch.from_numpy(rs.rand(lanes, *shape).astype(np.float32))
             if shape is not None else None)
    residual = torch.from_numpy(rs.randn(lanes, n).astype(np.float32)) * 1e-2
    kw = dict(ratio=0.05, quantize_level=8)
    got, got_res = comp.compress(name, vecs, noise=noise, residual=residual, **kw)
    assert got.shape == (lanes, n)
    for lane in range(lanes):
        want, want_res = comp.compress(name, vecs[lane], residual=residual[lane], **kw,
                                       noise=None if noise is None else noise[lane])
        assert torch.equal(got[lane], want)
        assert torch.equal(got_res[lane], want_res)


def test_flatten_reference_lanes_is_each_lanes_flatten():
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.algorithms.fedsgd import flatten_reference_lanes
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.models import resnet

    model = resnet.CifarResNet(1)
    lanes = [model.init(torch.Generator().manual_seed(k))["params"] for k in range(3)]
    stacked = pt.tree_stack(lanes)
    rows, unravel = flatten_reference_lanes(stacked)
    for lane, tree in enumerate(lanes):
        assert torch.equal(rows[lane], weights.flatten_reference(tree)[0])
    back = unravel(rows)
    for a, b in zip(pt.tree_leaves(back), pt.tree_leaves(stacked)):
        assert torch.equal(a, b) and a.is_contiguous()


def test_pytree_lane_helpers():
    """``tree_take`` (``jnp.take`` on the leading axis), ``tree_scatter_``
    (``.at[lanes].set`` in place), ``tree_head`` / ``tree_set_head_``."""
    from fedml_tpu_torch.core import pytree as pt

    tree = {"a": torch.arange(12.0).reshape(6, 2), "b": {"c": torch.arange(6)}}
    lanes = torch.tensor([4, 1])
    taken = pt.tree_take(tree, lanes)
    assert taken["a"].tolist() == [[8.0, 9.0], [2.0, 3.0]] and taken["b"]["c"].tolist() == [4, 1]
    pt.tree_scatter_(tree, lanes, pt.tree_map(lambda t: -t - 1, taken))
    assert tree["a"][4].tolist() == [-9.0, -10.0] and tree["b"]["c"].tolist() == [0, -2, 2, 3,
                                                                                  -5, 5]
    head = pt.tree_head(tree, 2)
    assert head["a"].shape == (2, 2) and head["a"].data_ptr() == tree["a"].data_ptr()
    pt.tree_set_head_(tree, 2, pt.tree_map(torch.zeros_like, head))
    assert tree["a"][:2].abs().sum() == 0 and tree["a"][2:].abs().sum() > 0


def test_run_rounds_returns_host_rows(tmp_path):
    """``run_rounds(n)`` on MESH: n rows of host floats (one sync for the
    chunk), the same metrics as n calls of ``run_round``."""
    chunked = _port_sim(tmp_path, "MESH", comm_round=3)
    stepped = _port_sim(tmp_path, "MESH", comm_round=3)
    rows = chunked.run_rounds(3)
    assert len(rows) == 3 and chunked.round_idx == 3
    for row in rows:
        assert set(row) == {"train_loss", "num_steps", "num_samples", "round_time_s"}
        assert all(type(v) is float for v in row.values())
    for row in rows:
        one = stepped.run_round()
        assert all(one[k] == row[k] for k in one)


def test_backends_take_their_own_paths(tmp_path, monkeypatch):
    """sp runs each sampled client alone through ``client_update``; MESH
    (and an unset backend) all of them through ``client_update_lanes``: each
    runs with the other path made to raise, so neither falls back."""
    import fedml_tpu_torch.fl.algorithm as algo

    def refuse(*args, **kwargs):
        raise AssertionError("the other backend's path ran")

    calls = []
    for backend, other in (("sp", "client_update_lanes"), ("MESH", "client_update"),
                           ("", "client_update")):
        sim = _port_sim(tmp_path, backend, comm_round=1)
        assert sim.backend == (backend or "MESH")
        with monkeypatch.context() as m:
            m.setattr(algo.FedAlgorithm, other, refuse)
            own = "client_update" if other == "client_update_lanes" else "client_update_lanes"
            real = getattr(algo.FedAlgorithm, own)
            m.setattr(algo.FedAlgorithm, own,
                      lambda self, *a, real=real, **k: calls.append(own) or real(self, *a, **k))
            sim.run_round()
        assert calls == ([own] * (3 if own == "client_update" else 1))
        calls.clear()


def test_multi_process_backends_raise(tmp_path):
    import fedml_tpu_torch
    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.models import resnet
    from fedml_tpu_torch.sim.engine import MeshSimulator

    for backend in ("MPI", "MULTIPROCESS"):
        _, cfg = _cfgs(tmp_path, backend_sim=backend)
        with pytest.raises(NotImplementedError, match="multi-process"):
            fedml_tpu_torch.init(cfg)
        with pytest.raises(NotImplementedError, match="multi-process"):
            MeshSimulator(cfg, loader.load(cfg), resnet.CifarResNet(1), device="cpu")
