"""Port parity: asynchronous FedAvg (``fedml_tpu_torch/sim/async_fl.py``)
and Turbo-Aggregate (``sim/turboaggregate.py``) against
``fedml_tpu/sim/async_fl.py`` and ``fedml_tpu/sim/turboaggregate.py``.

``staleness_factor``: all three kinds over staleness 0..9 against the
reference's, within two f32 ulps (``(s + 1) ** -0.5`` is a library power
on each side: 0.6 * 9 ** -0.5 reads 0.20000002 in the reference, two ulps
above the port's correctly rounded 0.2; the rest agree bitwise).

Async FedAvg: 12 server steps on the logistic regression over
``synthetic`` (6 Dirichlet clients, f32), each of the three kinds, the
port taking the reference's arrivals (the client from ``fold_in(step_key,
1)``, the staleness below ``min(8, t + 1)`` from ``fold_in(step_key, 2)``)
and permutations through the sampler hook, from the reference's initial
weights: every arrival the same, each step's loss within rtol 1e-4, the
global and the whole 8-deep history within 1e-5 relative L2 of the
movement from the start (``tests/test_torch_algorithms.py``'s ``LR_TOL``).

Turbo-Aggregate: 2 rounds of 6 of 8 clients in 2 and 3 groups, with no
dropout and with ``ta_dropout_prob`` 0.4, the port taking the reference's
sampled ids, permutations and mask draws.  The survivors and groups
bitwise (host numpy); the global within 1e-5 relative L2 of the
reference's movement; the audit: each group observed only masked rows,
every one farther than 10 x sqrt(d) / 2 from every client's weighted row,
and the running sum it received.  Against FedAvg of the survivors: a
round's global within 2e-5 relative L2 of the sample-weighted mean of the
surviving clients' trained variables (the masks of scale 10 cancel to
within f32 rounding of sums of that scale: measured 1.9e-6 to 1.3e-5 over
the four rounds; the global against the reference's 0 to 6.0e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from .test_torch_algorithms import _rel
from .test_torch_mesh import JaxSampler, _port_vars

torch.set_num_threads(1)

LR_TOL = 1e-5


def _cfgs(tmp_path, **kw):
    import fedml_tpu.arguments as ref_args
    import fedml_tpu_torch.arguments as args

    base = dict(dataset="synthetic", model="lr", client_num_in_total=6, client_num_per_round=6,
                comm_round=2, epochs=1, batch_size=8, learning_rate=0.05,
                synthetic_train_size=120, synthetic_test_size=40, partition_method="hetero",
                partition_alpha=0.5, frequency_of_the_test=0, compute_dtype="float32",
                random_seed=0, data_cache_dir=str(tmp_path))
    base.update(kw)
    extra = base.pop("extra", {})
    return ref_args.Config(**base, extra=extra), args.Config(**base, extra=dict(extra))


def _flat(tree) -> np.ndarray:
    from fedml_tpu_torch import weights

    return weights.flatten_reference(tree)[0].double().numpy()


def _ref_flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(a, np.float64).ravel()
                           for a in jax.tree_util.tree_leaves(tree)])


@pytest.mark.parametrize("kind", ["constant", "polynomial", "hinge"])
def test_staleness_factor(kind):
    from fedml_tpu.sim.async_fl import staleness_factor as ref_factor
    from fedml_tpu_torch.sim.async_fl import staleness_factor

    s = np.arange(10)
    got = staleness_factor(kind, torch.from_numpy(s), 0.6)
    want = np.asarray(ref_factor(kind, jnp.asarray(s), 0.6))
    assert got.dtype == torch.float32
    assert (np.abs(got.numpy() - want) <= 2 * np.spacing(want)).all()  # two f32 ulps
    with pytest.raises(ValueError, match="unknown staleness"):
        staleness_factor("exp", 1, 0.5)


class JaxArrivals(JaxSampler):
    """The reference's arrivals, staleness and permutations."""

    def arrival(self, t):
        from fedml_tpu.core import rng

        skey = rng.round_key(self.root, t)
        client = int(jax.random.randint(jax.random.fold_in(skey, 1), (), 0, self.n_total))
        staleness = int(jax.random.randint(jax.random.fold_in(skey, 2), (), 0,
                                           jnp.minimum(8, t + 1)))
        return client, staleness


@pytest.mark.parametrize("kind", ["constant", "polynomial", "hinge"])
def test_async_steps_match_the_reference(tmp_path, kind):
    import fedml_tpu
    import fedml_tpu_torch
    from fedml_tpu.data import loader as ref_loader
    from fedml_tpu.models import simple as flax_simple
    from fedml_tpu.sim.async_fl import AsyncSimulator as JaxAsync
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.models import simple
    from fedml_tpu_torch.sim.async_fl import HISTORY, AsyncSimulator

    ref_cfg, cfg = _cfgs(tmp_path, federated_optimizer="Async_FedAvg", comm_round=12,
                         async_staleness_func=kind, async_staleness_alpha=0.6)
    fedml_tpu.init(ref_cfg)
    ref = JaxAsync(ref_cfg, ref_loader.load(ref_cfg), flax_simple.LogisticRegression(10))
    fedml_tpu_torch.init(cfg)
    ds = loader.load(cfg)
    sim = AsyncSimulator(cfg, ds, simple.LogisticRegression(10, 60), device="cpu",
                         sampler=JaxArrivals(ref.root_key, ds.n_clients, ds.n_clients))
    sim.global_vars = _port_vars(ref.global_vars)
    sim.history = pt.tree_map(lambda t: t.unsqueeze(0).repeat((HISTORY,) + (1,) * t.ndim),
                              sim.global_vars)
    start = _flat(sim.global_vars)
    seen = set()
    for t in range(cfg.comm_round):
        want, got = ref.run_step(), sim.run_step()
        assert got["staleness"] == want["staleness"]
        seen.add(int(got["staleness"]))
        np.testing.assert_allclose(got["train_loss"], want["train_loss"], rtol=1e-4)
        assert got["num_samples"] == want["num_samples"]  # the same arriving client
    assert len(seen) > 2  # stale starts taken from the ring buffer
    target = _ref_flat(ref.global_vars)
    assert np.abs(target - start).max() > 1e-3
    assert _rel(_flat(sim.global_vars), target, start) <= LR_TOL
    for h in range(HISTORY):
        row = _ref_flat(jax.tree_util.tree_map(lambda a, h=h: a[h], ref.history))
        got_row = _flat(pt.tree_map(lambda a, h=h: a[h], sim.history))
        assert _rel(got_row, row, start) <= LR_TOL
    np.testing.assert_allclose(sim.evaluate()["test_loss"], ref.evaluate()["test_loss"],
                               rtol=1e-4)


class JaxTA(JaxSampler):
    """The reference's sampled ids, permutations and group masks."""

    def ta_masks(self, r, g, shape, device):
        from fedml_tpu.core import rng

        key = jax.random.fold_in(jax.random.fold_in(rng.round_key(self.root, r), 0x7A), g)
        return torch.from_numpy(np.array(jax.random.normal(jax.random.fold_in(key, 7),
                                                           shape))).to(device)


@pytest.mark.parametrize("groups,drop", [(2, 0.0), (3, 0.4)])
def test_turboaggregate_matches_the_reference(tmp_path, groups, drop):
    import fedml_tpu
    import fedml_tpu_torch
    from fedml_tpu.data import loader as ref_loader
    from fedml_tpu.models import simple as flax_simple
    from fedml_tpu.sim.turboaggregate import TurboAggregateSimulator as JaxTA_
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.models import simple
    from fedml_tpu_torch.sim.turboaggregate import TurboAggregateSimulator

    ref_cfg, cfg = _cfgs(tmp_path, federated_optimizer="TA", client_num_in_total=8,
                         client_num_per_round=6,
                         extra={"ta_group_num": groups, "ta_dropout_prob": drop})
    fedml_tpu.init(ref_cfg)
    ref = JaxTA_(ref_cfg, ref_loader.load(ref_cfg), flax_simple.LogisticRegression(10))
    fedml_tpu_torch.init(cfg)
    ds = loader.load(cfg)
    sim = TurboAggregateSimulator(cfg, ds, simple.LogisticRegression(10, 60), device="cpu",
                                  sampler=JaxTA(ref.root_key, 8, 6))
    sim.global_vars = _port_vars(ref.global_vars)
    start = _flat(sim.global_vars)
    trained, train = [], sim._train

    def kept_train(*args):  # keeps each round's trained lanes for the checks
        out = train(*args)
        trained.append(out[0])
        return out

    sim._train = kept_train
    for r in range(2):
        before = pt.tree_map(torch.clone, sim.global_vars)
        want_m, got_m = ref.run_round(), sim.run_round()
        assert got_m["alive"] == want_m["alive"]
        np.testing.assert_allclose(got_m["train_loss"], want_m["train_loss"], rtol=1e-4)
        last = sim.last_round
        matrix = pt.stacked_tree_to_matrix(trained[-1])
        d = matrix.shape[1]
        assert d == start.size
        # the audit: every group saw masked rows and the running sum only
        assert len(sim.observed_by_group) == len(ref.observed_by_group) == groups
        rows = (matrix * last["weights"][:, None]).numpy()
        for seen, ref_seen in zip(sim.observed_by_group, ref.observed_by_group):
            assert len(seen) == len(ref_seen)
            for masked in seen[:-1]:
                assert np.linalg.norm(rows - masked[None], axis=1).min() > 10 * np.sqrt(d) / 2
        split = np.array_split(np.flatnonzero(last["alive"]), groups)
        assert len(last["groups"]) == len(split) == groups
        for g, (members, ref_members) in enumerate(zip(last["groups"], split)):
            np.testing.assert_array_equal(members, ref_members)
            if len(members):  # the masked rows: the plain x * w + noise * 10
                x = matrix[members] * last["weights"][members][:, None]
                want = x + sim.sampler.ta_masks(r, g, tuple(x.shape), "cpu") * 10.0
                np.testing.assert_array_equal(np.stack(sim.observed_by_group[g][:-1]),
                                              want.numpy())
        # against FedAvg of the survivors, from this round's trained rows
        w = last["weights"].double().numpy()
        mean = (matrix.double().numpy() * w[:, None]).sum(0) / w.sum()
        got = _flat(sim.global_vars)
        assert np.linalg.norm(got - mean) <= 2e-5 * np.linalg.norm(mean)
        assert not torch.equal(pt.tree_leaves(before)[0], pt.tree_leaves(sim.global_vars)[0])
    want = _ref_flat(ref.global_vars)
    assert _rel(_flat(sim.global_vars), want, start) <= LR_TOL
