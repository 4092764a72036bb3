"""Port parity: split learning (``fedml_tpu_torch/sim/split_learning.py``,
the split ResNet-56 halves of ``models/resnet.py``) against
``fedml_tpu/sim/split_learning.py``.

- The ResNet-56 halves, GroupNorm and BatchNorm, batch 2 at 8x8 from the
  reference's weights: the forward within 1e-4 relative to the output's
  scale (measured up to 3e-6), BatchNorm's new statistics within 1e-5,
  and the gradient of a random projection of the output with respect to
  every parameter within 1e-4 relative L2 over the tree (f32 sums in
  another order through 27 blocks); the lane form, two lanes, against
  each lane alone within 1e-5.
- SplitNN and FedGKT, 2 rounds on ``synthetic`` through the MLP split (4
  clients, batch 8, 2 steps a client a round, f32), the reference's draws
  injected (:class:`JaxOwnSampler`) and its initial weights copied: every
  client's bottom (and FedGKT's heads), the top / server model and
  FedGKT's server logits within 1e-5 relative L2 (measured 3.7e-8 and
  2.2e-7), the losses and test accuracies within 1e-5.  FedGKT's second
  round runs
  the distillation term, and the server phase is compared through its
  model and logits every round; ``kd_loss`` alone against ``_kd``.
- ``norm: batch`` on CIFAR: the reference fails at its first step
  (flax's ``ModifyScopeVariableError``), the port refuses it at
  construction.
- The port's own draws (``sim/own_nets.OwnNetSampler``, the card's path):
  shapes, ranges, permutations, seeded.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

SIM_TOL = 1e-5


class JaxOwnSampler:
    """The reference's draws for the simulators that build their own
    networks, as a port sampler (``sim/own_nets.OwnNetSampler``'s
    methods), each keyed as the reference keys it."""

    def __init__(self, root_key, n_total=1, per_round=1):
        self.root, self.n_total, self.per_round = root_key, n_total, per_round

    def _rkey(self, r):
        from fedml_tpu.core import rng

        return rng.round_key(self.root, r)

    def _ckey(self, r, c):
        from fedml_tpu.core import rng

        return rng.client_key(self._rkey(r), c)

    def sample(self, r):
        from fedml_tpu.core import rng

        return np.asarray(rng.sample_clients(self.root, r, self.n_total, self.per_round))

    @staticmethod
    def _perms(key, steps, cap):
        return torch.from_numpy(np.stack([np.asarray(jax.random.permutation(
            jax.random.fold_in(key, s), cap)) for s in range(steps)]).astype(np.int64))

    def relay_perms(self, r, client, steps, cap):
        key = self._rkey(r)
        for _ in range(client):
            key = jax.random.fold_in(key, 7)
        return self._perms(key, steps, cap)

    def client_perms(self, r, client, steps, cap):
        return self._perms(self._ckey(r, client), steps, cap)

    def server_perm(self, r, n):
        return torch.from_numpy(np.asarray(jax.random.permutation(
            jax.random.fold_in(self._rkey(r), 0x5E), n)).astype(np.int64))

    def epoch_perm(self, r, epoch, n):
        return torch.from_numpy(np.asarray(jax.random.permutation(
            jax.random.fold_in(self._rkey(r), epoch), n)).astype(np.int64))

    def gan_draws(self, r, client, steps, cap, batch, z_dim):
        key, idx, z1, z2 = self._ckey(r, client), [], [], []
        for _ in range(steps):
            key, kz1, kz2, kb = jax.random.split(key, 4)
            idx.append(np.asarray(jax.random.permutation(kb, cap))[:batch])
            z1.append(np.asarray(jax.random.normal(kz1, (batch, z_dim))))
            z2.append(np.asarray(jax.random.normal(kz2, (batch, z_dim))))
        return (torch.from_numpy(np.stack(idx).astype(np.int64)), torch.from_numpy(np.stack(z1)),
                torch.from_numpy(np.stack(z2)))

    def latent(self, n, seed, z_dim):
        return torch.from_numpy(np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                                             (n, z_dim))))

    def nas_indices(self, r, client, steps, half, cap, batch):
        key, iw, ia = self._ckey(r, client), [], []
        for _ in range(steps):
            key, kw, ka = jax.random.split(key, 3)
            iw.append(np.asarray(jax.random.randint(kw, (batch,), 0, half)))
            ia.append(np.asarray(jax.random.randint(ka, (batch,), half, cap)))
        return (torch.from_numpy(np.stack(iw).astype(np.int64)),
                torch.from_numpy(np.stack(ia).astype(np.int64)))

    def seg_indices(self, r, client, steps, cap, batch):
        key, out = self._ckey(r, client), []
        for _ in range(steps):
            key, kb = jax.random.split(key)
            out.append(np.asarray(jax.random.randint(kb, (batch,), 0, cap)))
        return torch.from_numpy(np.stack(out).astype(np.int64))


def port_vars(jax_vars, lanes=False):
    from fedml_tpu_torch import weights

    return weights.to_torch(weights.flax_to_torch(jax.tree_util.tree_map(np.asarray, jax_vars),
                                                  lanes=lanes))


def flat(tree) -> np.ndarray:
    """A port tree (tensors) as one f64 vector, leaves in JAX order and in
    the port's layouts."""
    from fedml_tpu_torch import weights

    return np.concatenate([np.asarray(a, np.float64).reshape(-1)
                           for a in jax.tree_util.tree_leaves(weights.to_numpy(tree))])


def ref_flat(tree, lanes=False) -> np.ndarray:
    """A reference tree in the port's layouts, flattened as :func:`flat`."""
    from fedml_tpu_torch import weights

    return flat(weights.to_torch(weights.flax_to_torch(
        jax.tree_util.tree_map(np.asarray, tree), lanes=lanes)))


def rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _cfgs(tmp_path, opt, **kw):
    import fedml_tpu.arguments as ref_args
    import fedml_tpu_torch.arguments as args

    base = dict(federated_optimizer=opt, dataset="synthetic", client_num_in_total=4,
                client_num_per_round=4, comm_round=2, epochs=1, batch_size=8,
                learning_rate=0.05, momentum=0.9, synthetic_train_size=64,
                synthetic_test_size=40, partition_method="homo", frequency_of_the_test=1,
                random_seed=0, data_cache_dir=str(tmp_path))
    base.update(kw)
    extra = base.pop("extra", {})
    return ref_args.Config(**base, extra=extra), args.Config(**base, extra=dict(extra))


def _datasets(ref_cfg, cfg):
    import fedml_tpu
    import fedml_tpu_torch
    from fedml_tpu.data import loader as ref_loader
    from fedml_tpu_torch.data import loader

    fedml_tpu.init(ref_cfg)
    fedml_tpu_torch.init(cfg)
    return ref_loader.load(ref_cfg), loader.load(cfg)


# --- the ResNet-56 halves ---------------------------------------------------

def _random_variables(shapes, rs):
    """Variables of the given shapes: kernels scaled by ``1 / sqrt(fan
    in)``, norm scales near 1 and biases near 0, running means 0 and
    variances 1."""
    def leaf(path, s):
        name = jax.tree_util.keystr(path[-1:])
        if "kernel" in name:
            return rs.randn(*s.shape).astype(np.float32) / np.sqrt(np.prod(s.shape[:-1]))
        base = {"scale": 1.0, "var": 1.0}.get(name.strip("[]'"), 0.0)
        noise = 0.0 if name.strip("[]'") in ("mean", "var") else 0.1
        return (base + noise * rs.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(lambda p, s: jnp.asarray(leaf(p, s)), shapes)


@pytest.fixture(scope="module", params=["group", "batch"])
def halves(request):
    """The reference's halves at batch 2, 8x8: weights, inputs, outputs,
    new statistics and gradients of a random projection of each output."""
    from fedml_tpu.models import resnet as fr

    norm = request.param
    rs = np.random.RandomState(1)
    x = rs.randn(2, 8, 8, 3).astype(np.float32)
    out = {}
    for half, model, inp in (("client", fr.SplitResNet56Client(norm=norm), x),
                             ("server", fr.SplitResNet56Server(num_classes=10, norm=norm), None)):
        if inp is None:
            inp = np.asarray(out["client"]["y"])
        v = _random_variables(jax.eval_shape(model.init, jax.random.PRNGKey(3), jnp.asarray(inp)),
                              rs)
        mutable = ["batch_stats"] if norm == "batch" else False

        def fwd(params, v=v, model=model, inp=inp, mutable=mutable):
            o = model.apply({**v, "params": params}, jnp.asarray(inp), train=True, mutable=mutable)
            return o if mutable else (o, {})

        (y, st), pull = jax.vjp(fwd, v["params"])
        cot = rs.randn(*y.shape).astype(np.float32)
        (g,) = pull((jnp.asarray(cot), jax.tree_util.tree_map(jnp.zeros_like, st)))
        out[half] = dict(v=v, x=inp, y=np.asarray(y), stats=st, cot=cot, grad=g)
    return norm, out


@pytest.mark.parametrize("half", ["client", "server"])
def test_resnet56_halves_forward_and_gradient(halves, half):
    from fedml_tpu_torch.models import resnet

    norm, out = halves
    ref = out[half]
    model = (resnet.SplitResNet56Client(norm=norm) if half == "client"
             else resnet.SplitResNet56Server(num_classes=10, norm=norm))
    variables = port_vars(ref["v"])
    params = variables["params"]
    leaves = [t.requires_grad_(True) for t in jax.tree_util.tree_leaves(params)]
    y, stats = model.apply(variables, torch.from_numpy(ref["x"]), train=True)
    scale = np.abs(ref["y"]).max()
    assert np.abs(y.detach().numpy() - ref["y"]).max() <= 1e-4 * scale
    if norm == "batch":
        np.testing.assert_allclose(flat(stats), ref_flat(ref["stats"]["batch_stats"]),
                                   rtol=1e-5, atol=1e-6)
    else:
        assert stats == {} and "batch_stats" not in variables
    (y * torch.from_numpy(ref["cot"])).sum().backward()
    got = np.concatenate([np.asarray(t.grad.numpy(), np.float64).reshape(-1) for t in leaves])
    want = ref_flat({"params": ref["grad"]})
    assert rel(got, want) <= 1e-4


def test_resnet56_halves_lanes_equal_each_lane_alone():
    """The GroupNorm halves' lane form, 2 lanes of different weights and
    inputs, against each lane alone (FedGKT's client phase)."""
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.models import resnet

    client, server = resnet.SplitResNet56Client("group"), resnet.SplitResNet56Server(10, "group")
    vc = [client.init(torch.Generator().manual_seed(s)) for s in (0, 1)]
    vs = [server.init(torch.Generator().manual_seed(s)) for s in (2, 3)]
    x = torch.randn(2, 3, 8, 8, 3, generator=torch.Generator().manual_seed(4))
    feats, _ = client.apply(pt.tree_stack(vc), x)
    logits, _ = server.apply(pt.tree_stack(vs), feats)
    for lane in range(2):
        f1, _ = client.apply(vc[lane], x[lane])
        l1, _ = server.apply(vs[lane], f1)
        torch.testing.assert_close(feats[lane], f1, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(logits[lane], l1, rtol=1e-5, atol=1e-5)


# --- SplitNN and FedGKT on the MLP split --------------------------------------

def _pair(tmp_path, opt):
    from fedml_tpu.sim import split_learning as ref_sl
    from fedml_tpu_torch.sim import split_learning as sl

    ref_cfg, cfg = _cfgs(tmp_path, opt)
    ref_ds, ds = _datasets(ref_cfg, cfg)
    n = ds.n_clients
    if opt == "split_nn":
        ref = ref_sl.SplitNNSimulator(ref_cfg, ref_ds)
        sim = sl.SplitNNSimulator(cfg, ds, device="cpu", sampler=JaxOwnSampler(ref.root_key, n, n))
        sim.client_bottoms = port_vars(ref.client_bottoms, lanes=True)
        sim.top_vars = port_vars(ref.top_vars)
    else:
        ref = ref_sl.FedGKTSimulator(ref_cfg, ref_ds)
        sim = sl.FedGKTSimulator(cfg, ds, device="cpu", sampler=JaxOwnSampler(ref.root_key, n, n))
        sim.client_bottoms = port_vars(ref.client_bottoms, lanes=True)
        sim.client_heads = port_vars(ref.client_heads, lanes=True)
        sim.server_vars = port_vars(ref.server_vars)
    return ref, sim


def _states(sim, ref):
    """(port, reference) flat states compared after a round."""
    if hasattr(sim, "top_vars"):
        return [(flat(sim.client_bottoms), ref_flat(ref.client_bottoms, lanes=True)),
                (flat(sim.top_vars), ref_flat(ref.top_vars))]
    return [(flat(sim.client_bottoms), ref_flat(ref.client_bottoms, lanes=True)),
            (flat(sim.client_heads), ref_flat(ref.client_heads, lanes=True)),
            (flat(sim.server_vars), ref_flat(ref.server_vars)),
            (sim.server_logits.numpy().astype(np.float64).ravel(),
             np.asarray(ref.server_logits, np.float64).ravel())]


@pytest.mark.parametrize("opt", ["split_nn", "FedGKT"])
def test_two_rounds_match_the_reference(tmp_path, opt):
    ref, sim = _pair(tmp_path, opt)
    start = _states(sim, ref)
    for got, want in start:
        np.testing.assert_array_equal(got, want)
    for _ in range(2):
        want_m, got_m = ref.run_round(), sim.run_round()
        np.testing.assert_allclose(got_m["train_loss"], want_m["train_loss"], rtol=SIM_TOL)
        for (got, want), (s0, _) in zip(_states(sim, ref), start):
            assert rel(got, want) <= SIM_TOL
        np.testing.assert_allclose(sim.evaluate()["test_acc"], ref.evaluate()["test_acc"],
                                   rtol=SIM_TOL)
    moved = _states(sim, ref)
    assert all(np.abs(w - s[1]).max() > 1e-4 for (_, w), s in zip(moved[:3], start[:3]))


def test_kd_loss_matches_the_reference():
    from fedml_tpu.sim.split_learning import FedGKTSimulator as Ref
    from fedml_tpu_torch.sim.split_learning import kd_loss

    rs = np.random.RandomState(0)
    s, t = rs.randn(2, 5, 7).astype(np.float32) * 3, rs.randn(2, 5, 7).astype(np.float32) * 3
    got = kd_loss(torch.from_numpy(s), torch.from_numpy(t)).numpy()
    want = [float(Ref._kd(jnp.asarray(s[i]), jnp.asarray(t[i]))) for i in range(2)]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(float(kd_loss(torch.from_numpy(s[0]), torch.from_numpy(t[0]))),
                               want[0], rtol=1e-6)


@pytest.mark.parametrize("opt", ["split_nn", "FedGKT"])
def test_batch_norm_halves_fail_in_both_packages(tmp_path, opt):
    import flax
    from fedml_tpu.sim import split_learning as ref_sl
    from fedml_tpu_torch.sim import split_learning as sl

    ref_cfg, cfg = _cfgs(tmp_path, opt, dataset="cifar10", norm="batch", client_num_in_total=2,
                         client_num_per_round=2, synthetic_train_size=16,
                         synthetic_test_size=8, comm_round=1)
    ref_ds, ds = _datasets(ref_cfg, cfg)
    Ref = ref_sl.SplitNNSimulator if opt == "split_nn" else ref_sl.FedGKTSimulator
    with pytest.raises(flax.errors.ModifyScopeVariableError, match="batch_stats"):
        Ref(ref_cfg, ref_ds).run_round()
    Sim = sl.SplitNNSimulator if opt == "split_nn" else sl.FedGKTSimulator
    with pytest.raises(ValueError, match="norm: group.*ModifyScopeVariableError"):
        Sim(cfg, ds, device="cpu")


def test_default_sampler_draws():
    """The port's own draws (``OwnNetSampler``): each table's shape, range
    and dtype, permutations that are permutations, the same draws from the
    same seed and others from another."""
    from fedml_tpu_torch.sim.own_nets import OwnNetSampler

    a, b, c = OwnNetSampler(3, 10, 4), OwnNetSampler(3, 10, 4), OwnNetSampler(4, 10, 4)
    ids = a.sample(1)
    assert len(set(ids.tolist())) == 4 and ids.max() < 10
    np.testing.assert_array_equal(ids, b.sample(1))
    for perms in (a.relay_perms(0, 2, 3, 16), a.client_perms(0, 2, 3, 16)):
        assert perms.shape == (3, 16) and perms.dtype == torch.int64
        assert all(sorted(p.tolist()) == list(range(16)) for p in perms)
    assert not torch.equal(a.relay_perms(0, 1, 3, 16), a.relay_perms(0, 2, 3, 16))
    assert sorted(a.server_perm(1, 12).tolist()) == list(range(12))
    assert sorted(a.epoch_perm(1, 2, 12).tolist()) == list(range(12))
    idx, z1, z2 = a.gan_draws(0, 5, 4, 20, 6, 3)
    assert idx.shape == (4, 6) and int(idx.max()) < 20 and z1.shape == z2.shape == (4, 6, 3)
    assert all(len(set(row.tolist())) == 6 for row in idx) and not torch.equal(z1, z2)
    iw, ia = a.nas_indices(0, 5, 4, 8, 16, 6)
    assert iw.shape == ia.shape == (4, 6) and int(iw.max()) < 8 and int(ia.min()) >= 8
    rows = a.seg_indices(0, 5, 4, 16, 6)
    assert rows.shape == (4, 6) and 0 <= int(rows.min()) and int(rows.max()) < 16
    assert torch.equal(rows, b.seg_indices(0, 5, 4, 16, 6))
    assert not torch.equal(rows, c.seg_indices(0, 5, 4, 16, 6))
    assert torch.equal(a.latent(5, 9, 3), b.latent(5, 9, 3))
