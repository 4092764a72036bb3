"""Port parity: the MyAvg simulator (``fedml_tpu_torch/sim/myavg.py``) and
the ``synthetic_condshift`` loader against ``fedml_tpu/sim/myavg.py`` and
``fedml_tpu/data/loader.py``.

The loader is host numpy: bitwise, per-client test shards included.
``linear_cka_matrix`` within 1e-5 on random layer deltas; the partner
weights give the reference's partner sets (``lax.top_k`` with its
lower-index-first ties, written out here as the reference's round writes it,
``fedml_tpu/sim/myavg.py:313``), ties included.  Three rounds of both
simulators on the conditional-shift data with an MLP, from the reference's
initial weights, sampled ids and permutations: under the shipped gate (the
head never aggregates, so CKA never runs) and with ``agg_mod_list: [2]``
(round 2 aggregates everything and runs CKA on ``Dense_1``), with every
client and with 3 of 4 a round.  The global, every personal model and the
personalized accuracies within 1e-4.  Then the reference's refusals, and the
recipe through the runner.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from .test_torch_mesh import JaxSampler, _port_vars

torch.set_num_threads(1)

TOL = 1e-4


def _cfgs(tmp_path, **kw):
    import fedml_tpu.arguments as ref_args
    import fedml_tpu_torch.arguments as args

    base = dict(dataset="synthetic_condshift", model="mlp", federated_optimizer="MyAvg",
                client_num_in_total=4, client_num_per_round=4, comm_round=3, epochs=1,
                batch_size=8, learning_rate=0.5, synthetic_train_size=160,
                synthetic_test_size=80, frequency_of_the_test=0, compute_dtype="float32",
                random_seed=0, agg_unselect_layer=("Dense_1",), agg_mod_list=(9999,),
                cka_any_select_layer=("Dense_1",), cka_select_topk=2,
                data_cache_dir=str(tmp_path))
    base.update(kw)
    extra = {"mlp_hidden": 16, "condshift_clusters": 2, "condshift_scale": 2.5,
             **base.pop("extra", {})}
    return ref_args.Config(**base, extra=extra), args.Config(**base, extra=dict(extra))


def _pair(ref_cfg, cfg):
    import fedml_tpu
    import fedml_tpu_torch
    from fedml_tpu.data import loader as ref_loader
    from fedml_tpu.models import simple as flax_simple
    from fedml_tpu.parallel import mesh as meshlib
    from fedml_tpu.sim.myavg import MyAvgSimulator as JaxMyAvg
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.models import simple
    from fedml_tpu_torch.sim.myavg import MyAvgSimulator

    fedml_tpu.init(ref_cfg)
    ref = JaxMyAvg(ref_cfg, ref_loader.load(ref_cfg), flax_simple.MLP(hidden=16, num_classes=6),
                   mesh=meshlib.mesh_from_config(ref_cfg, devices=jax.devices()[:1]))
    fedml_tpu_torch.init(cfg)
    ds = loader.load(cfg)
    sim = MyAvgSimulator(cfg, ds, simple.MLP(16, 6, 64), device="cpu",
                         sampler=JaxSampler(ref.root_key, ds.n_clients,
                                            cfg.client_num_per_round))
    init = _port_vars(ref.global_vars)
    sim.global_vars = pt.tree_map(torch.clone, init)
    sim.client_states = pt.tree_map(lambda t: t.unsqueeze(0).repeat(
        (ds.n_clients,) + (1,) * t.ndim), init)
    return ref, sim


def _flat(tree):
    from fedml_tpu_torch.core import pytree as pt

    return np.concatenate([t.numpy().ravel() for t in pt.tree_leaves(tree)])


def _personal(ref, i):
    return _flat(_port_vars(jax.tree_util.tree_map(lambda a: np.asarray(a[i]),
                                                   ref.client_states)))


def test_condshift_loader_bitwise(tmp_path):
    """Train and test arrays, client shards and per-client test shards."""
    from fedml_tpu.data import loader as ref_loader
    from fedml_tpu_torch.data import loader

    for kw in (dict(), dict(random_seed=3, client_num_in_total=6,
                            extra={"condshift_clusters": 3, "condshift_scale": 0.9})):
        ref_cfg, cfg = _cfgs(tmp_path, **kw)
        a, b = ref_loader.load(ref_cfg), loader.load(cfg)
        for f in ("train_x", "train_y", "test_x", "test_y"):
            assert getattr(a, f).dtype == getattr(b, f).dtype
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        for f in ("client_idx", "test_client_idx"):
            assert len(getattr(a, f)) == len(getattr(b, f)) == cfg.client_num_in_total
            for u, v in zip(getattr(a, f), getattr(b, f)):
                assert u.dtype == v.dtype and np.array_equal(u, v)
        assert (a.class_num, a.name) == (b.class_num, b.name)
    _, cfg = _cfgs(tmp_path, extra={"condshift_clusters": 7})
    with pytest.raises(ValueError, match="out of range"):
        loader.load(cfg)


def test_linear_cka_matrix_matches_the_reference():
    from fedml_tpu.sim.myavg import linear_cka_matrix as ref_cka
    from fedml_tpu_torch.sim.myavg import linear_cka_matrix

    rs = np.random.RandomState(0)
    for m, r, c in ((4, 6, 16), (5, 16, 3), (3, 1, 7)):
        d = rs.randn(m, r, c).astype(np.float32)
        d[1] = 0.0  # a zero delta: self-similarity only
        want = np.asarray(ref_cka(jnp.asarray(d)))
        got = linear_cka_matrix(torch.from_numpy(d)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)
        assert np.all(np.diag(got) == 1.0) and got.max() <= 1.0


def _reference_partner_select(cka_row, i, weights, k, lo, hi):
    """The reference round's ``partner_select`` (myavg.py:313), as written
    there."""
    _, top_idx = jax.lax.top_k(cka_row, k)
    in_topk = jnp.zeros_like(cka_row).at[top_idx].set(1.0)
    ok = in_topk * (cka_row >= lo) * (cka_row <= hi)
    ok = ok.at[i].set(1.0)
    pw = weights * ok
    return pw / jnp.maximum(pw.sum(), 1e-12)


@pytest.mark.parametrize("case", ["random", "ties", "thresholds"])
def test_partner_weights_match_the_reference(case):
    """The same partner sets and weights; on equal CKA values both keep the
    lower client index."""
    from fedml_tpu_torch.sim.myavg import partner_weights

    rs = np.random.RandomState(1)
    m = 6
    cka = rs.rand(m, m).astype(np.float32)
    lo, hi, k = 0.0, 1.0, 3
    if case == "ties":
        cka = np.round(cka * 2) / 2  # values in {0, 0.5, 1}: many ties
    if case == "thresholds":
        lo, hi, k = 0.3, 0.8, 4
    np.fill_diagonal(cka, 1.0)
    weights = rs.randint(5, 50, size=m).astype(np.float32)
    want = np.stack([np.asarray(_reference_partner_select(
        jnp.asarray(cka[i]), i, jnp.asarray(weights), k, lo, hi)) for i in range(m)])
    got = partner_weights(torch.from_numpy(cka), torch.from_numpy(weights), k, lo, hi).numpy()
    assert np.array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("case", ["shipped_gate", "cka_every_2", "cka_partial"])
def test_three_rounds_match_the_reference(tmp_path, case):
    """Three rounds: the round metrics (the config id included), the
    global, every personal model and the personalized accuracies."""
    kw = {"shipped_gate": {},
          "cka_every_2": dict(agg_mod_list=(2,), agg_mod_dict={2: {}}),
          "cka_partial": dict(agg_mod_list=(2,), agg_mod_dict={2: {}},
                              client_num_per_round=3)}[case]
    ref_cfg, cfg = _cfgs(tmp_path, **kw)
    ref, sim = _pair(ref_cfg, cfg)
    start = _flat(sim.global_vars)
    for r in range(3):
        want_m, got_m = ref.run_round(), sim.run_round()
        for key in ("train_loss", "myavg_config_id"):
            np.testing.assert_allclose(got_m[key], want_m[key], rtol=TOL, err_msg=key)
    assert sim.cka_rounds == (0 if case == "shipped_gate" else 1)
    want = _flat(_port_vars(jax.tree_util.tree_map(np.asarray, ref.global_vars)))
    np.testing.assert_allclose(_flat(sim.global_vars), want, atol=TOL)
    assert np.abs(want - start).max() > 1e-3
    for i in range(cfg.client_num_in_total):
        np.testing.assert_allclose(_flat({k: {n: v[i] for n, v in layer.items()}
                                          for k, layer in sim.client_states["params"].items()}),
                                   _personal(ref, i), atol=TOL, err_msg=f"client {i}")
    heads = sim.client_states["params"]["Dense_1"]["kernel"]
    assert (heads - heads[:1]).abs().max() > 1e-3  # the heads personalized
    want_p, got_p = ref.evaluate_personalized(), sim.evaluate_personalized()
    for key in ("personalized_test_acc_mean", "personalized_test_acc_min"):
        np.testing.assert_allclose(got_p[key], want_p[key], atol=TOL, err_msg=key)


@pytest.mark.parametrize("case", ["sp", "secagg", "fhe", "contribution", "dead_substring",
                                  "cka_selects_nothing", "zero_mod"])
def test_refusals_match_the_reference(tmp_path, case):
    """What the reference's MyAvg refuses, the port refuses with the same
    exception."""
    from fedml_tpu.runner import FedMLRunner as RefRunner
    from fedml_tpu_torch.runner import FedMLRunner

    kw, exc, match = {
        "sp": (dict(backend_sim="sp"), NotImplementedError, "backend_sim='MESH'"),
        "secagg": (dict(enable_secagg=True), NotImplementedError, "secagg"),
        "fhe": (dict(enable_fhe=True), NotImplementedError, "fhe"),
        "contribution": (dict(enable_contribution=True), NotImplementedError, "contribution"),
        "dead_substring": (dict(agg_unselect_layer=("head",)), ValueError, "match NO model leaf"),
        "cka_selects_nothing": (dict(cka_unselect_layer=("Dense_1",)), ValueError,
                                "selects zero leaves"),
        "zero_mod": (dict(agg_mod_list=(0,)), ValueError, "positive"),
    }[case]
    ref_cfg, cfg = _cfgs(tmp_path, **kw)
    with pytest.raises(exc, match=match):
        RefRunner(ref_cfg)
    with pytest.raises(exc, match=match):
        FedMLRunner(cfg, device="cpu")


def test_recipe_runs_through_the_runner(tmp_path):
    """``myavg_condshift_mlp`` through ``fedml_tpu_torch.init`` and
    ``FedMLRunner(cfg, device="cpu")``, shrunk to 3 rounds; its gate never
    runs CKA.  ``MyAgg-7`` dispatches the same simulator."""
    import fedml_tpu_torch
    from fedml_tpu_torch.runner import FedMLRunner
    from fedml_tpu_torch.sim.myavg import MyAvgSimulator

    cfg = fedml_tpu_torch.init(argv=["--cf", "examples/myavg_condshift_mlp/fedml_config.yaml"])
    cfg.comm_round, cfg.frequency_of_the_test = 3, 3
    runner = FedMLRunner(cfg, device="cpu")
    sim = runner.runner
    assert isinstance(sim, MyAvgSimulator) and sim.cfg.federated_optimizer == "MyAvg"
    hist = runner.run()
    assert [h["round"] for h in hist] == [0, 1, 2] and sim.cka_rounds == 0
    last = hist[-1]
    assert 0.0 <= last["personalized_test_acc_min"] <= last["personalized_test_acc_mean"] <= 1.0
    assert np.isfinite(last["test_loss"])
    alias = FedMLRunner(dataclasses.replace(cfg, federated_optimizer="MyAgg-7"), device="cpu")
    assert isinstance(alias.runner, MyAvgSimulator)
