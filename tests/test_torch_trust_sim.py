"""Port parity: trust in the simulators (``sim/engine.py`` on MESH and sp,
``sim/myavg.py``), end to end against ``fedml_tpu`` on the CPU, and the
refusals that remain (``runner.py``).

Each pair of runs starts from the reference's initial weights, sampled ids
and permutations (``tests/test_torch_mesh.py``'s sampler hook) and the
reference's trust draws (``tests/test_torch_trust.py``'s
:class:`JaxTrustSampler`, installed as ``sim.trust.sampler``), on the
logistic regression of ``tests/test_torch_algorithms.py`` (6 clients, 3 a
round, 2 rounds, f32).

Tolerances:

- the globals as updates from the shared initial weights, within
  ``tests/test_torch_algorithms.py``'s ``LR_TOL`` (1e-5 relative L2): the
  reference's jitted round may contract ``x + noise * sigma`` into an FMA,
  and its sums run in another order;
- cross-round's history (the last global delta) at the same tolerance; a
  resumed port run (1 + 1 rounds) bitwise the straight one;
- the contribution replay: its FedAvg aggregate bitwise the round's global
  (the replay goes through the round's own backend call); the scores within
  two test samples' accuracy (``2 / n_test``: each accuracy in a score may
  move by one sample where a prediction sits on a decision boundary);
- MyAvg: ``tests/test_torch_myavg.py``'s 1e-4 on the global, every personal
  model and the personalized accuracies;
- refusals: the reference's exception type, raised by both.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from .test_torch_algorithms import LR_TOL, _cfgs, _models, _port_flat, _port_sim, _ref_flat, _rel
from .test_torch_mesh import JaxSampler, _jax_sim, _port_vars
from .test_torch_trust import JaxTrustSampler

torch.set_num_threads(1)

CASES = {
    "attack_multikrum": dict(enable_attack=True, attack_type="byzantine_random",
                             poisoned_client_list=(0, 1, 4), enable_defense=True,
                             defense_type="multikrum", byzantine_client_num=1, krum_param_m=2),
    "ldp": dict(enable_dp=True, dp_solution_type="ldp", epsilon=50.0, delta=1e-5,
                sensitivity=0.01),
    "cdp": dict(enable_dp=True, dp_solution_type="cdp", epsilon=50.0, delta=1e-5,
                sensitivity=0.01, clipping_norm=0.5),
    "label_flipping": dict(enable_attack=True, attack_type="label_flipping",
                           poisoned_client_list=(0, 1, 2),
                           extra={"attack_original_class": 0, "attack_target_class": 1}),
    "scaffold_trimmed_mean": dict(federated_optimizer="SCAFFOLD", enable_defense=True,
                                  defense_type="trimmed_mean", trimmed_mean_beta=0.34),
}


def _pair(tmp_path, **kw):
    """The reference's simulator and the port's on its draws, from its
    initial weights."""
    ref_cfg, cfg = _cfgs(tmp_path, "lr", **kw)
    ref_model, port_model = _models("lr")
    ref = _jax_sim(ref_cfg, ref_model)
    sim = _port_sim(cfg, port_model, JaxSampler(ref.root_key, 6, 3))
    sim.global_vars = _port_vars(ref.global_vars)
    sim.server_state = sim.algorithm.init_server_state(sim.global_vars)
    if sim.trust is not None:
        sim.trust.sampler = JaxTrustSampler(ref.root_key)
    return ref, sim


@pytest.mark.parametrize("backend", ["MESH", "sp"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_trust_rounds_match_reference(tmp_path, case, backend):
    """2 rounds with the trust flags of ``case`` on ``backend``: the globals
    (and a data attack's poisoned labels, bitwise) against the reference."""
    ref, sim = _pair(tmp_path, backend_sim=backend, **CASES[case])
    start = _port_flat(sim.global_vars)
    ref.run()
    sim.run()
    assert sim.backend == ref.backend == backend
    got, want = _port_flat(sim.global_vars), _ref_flat(ref.global_vars)
    assert np.isfinite(got).all() and np.abs(want - start).max() > 1e-4
    assert _rel(got, want, start) <= LR_TOL
    np.testing.assert_array_equal(sim.dataset.train_y, ref.dataset.train_y)
    kinds = {c[0] for c in sim.trust.sampler.calls}
    assert kinds == {"multikrum": {"attack"}, "ldp": {"ldp"}, "cdp": {"cdp"}}.get(
        CASES[case].get("defense_type", CASES[case].get("dp_solution_type")), set())


def test_cross_round_history_and_resume(tmp_path):
    """``cross_round`` on MESH, 3 rounds: the globals and the threaded
    history against the reference; then 2 + 1 rounds through a checkpoint
    bitwise 3 straight, history included."""
    kw = dict(enable_defense=True, defense_type="cross_round", comm_round=3)
    ref, sim = _pair(tmp_path, **kw)
    start = _port_flat(sim.global_vars)
    ref.run()
    sim.run()
    hist = sim.defense_history.double().numpy()
    assert np.abs(hist).max() > 0
    assert _rel(hist, np.asarray(ref.defense_history, np.float64)) <= LR_TOL
    assert _rel(_port_flat(sim.global_vars), _ref_flat(ref.global_vars), start) <= LR_TOL

    runs = {}
    for name, extra in (("first", dict(comm_round=2, checkpoint_dir=str(tmp_path / "ck"),
                                       checkpoint_every_rounds=1)),
                        ("resumed", dict(checkpoint_dir=str(tmp_path / "ck"), resume=True))):
        _, again = _pair(tmp_path, **{**kw, **extra})
        again.run()
        runs[name] = again
    resumed = runs["resumed"]
    assert resumed.round_idx == 3
    assert torch.equal(resumed.defense_history, sim.defense_history)
    np.testing.assert_array_equal(_port_flat(resumed.global_vars), _port_flat(sim.global_vars))


@pytest.mark.parametrize("backend,method", [("MESH", "leave_one_out"), ("sp", "gtg_shapley")])
def test_contribution_replay_and_scores(tmp_path, backend, method):
    """The last round replayed through the round's own backend call: its
    FedAvg aggregate bitwise the run's global; the scores against the
    reference's within two test samples."""
    ref, sim = _pair(tmp_path, backend_sim=backend, enable_contribution=True,
                     contribution_method=method, synthetic_test_size=200)
    ref.run()
    sim.run()
    stacked, weights, sampled, snap = sim.last_round_contributions()
    np.testing.assert_array_equal(sampled, np.asarray(ref.last_round_contributions()[2]))
    agg = sim.algorithm.aggregate(stacked, torch.tensor(weights, dtype=torch.float32))
    new_global, _ = sim.algorithm.server_update(snap["global_vars"], snap["server_state"], agg,
                                                snap["round"])
    np.testing.assert_array_equal(_port_flat(new_global), _port_flat(sim.global_vars))
    want, got = ref.assess_contribution(), sim.assess_contribution()
    n_test = sim._test[2]
    assert got.shape == want.shape == (3,)
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 / n_test + 1e-9)


def test_myavg_with_a_transforming_defense_and_ldp(tmp_path):
    """MyAvg (3 rounds, CKA in round 2) with ``norm_diff_clipping`` and local
    DP: the global, every personal model and the personalized accuracies
    against the reference; the gated-off head keeps each client's clean
    trained leaf."""
    from .test_torch_myavg import TOL, _cfgs as myavg_cfgs, _pair as myavg_pair

    ref_cfg, cfg = myavg_cfgs(tmp_path, client_num_per_round=3, agg_mod_list=(2,),
                              enable_defense=True, defense_type="norm_diff_clipping",
                              norm_bound=0.5, enable_dp=True, dp_solution_type="ldp",
                              epsilon=20.0, sensitivity=0.05)
    ref, sim = myavg_pair(ref_cfg, cfg)
    sim.trust.sampler = JaxTrustSampler(ref.root_key)
    ref.run()
    sim.run()
    np.testing.assert_allclose(_port_flat(sim.global_vars), _ref_flat(ref.global_vars),
                               atol=TOL)
    for ci in range(4):
        got = _port_flat(_row(sim.client_states, ci))
        want = _ref_flat(jax.tree_util.tree_map(lambda a, ci=ci: np.asarray(a)[ci],
                                                ref.client_states))
        np.testing.assert_allclose(got, want, atol=TOL, err_msg=f"client {ci}")
    got_p, want_p = sim.evaluate_personalized(), ref.evaluate_personalized()
    for key in ("personalized_test_acc_mean", "personalized_test_acc_min"):
        np.testing.assert_allclose(got_p[key], want_p[key], atol=TOL, err_msg=key)
    assert {c[0] for c in sim.trust.sampler.calls} == {"ldp"}


def _row(states, ci):
    from fedml_tpu_torch.core import pytree as pt

    return pt.tree_map(lambda t: t[ci], states)


REFUSALS = {
    "hierarchical_trust": (dict(federated_optimizer="HierarchicalFL", enable_attack=True,
                                attack_type="byzantine_zero"), NotImplementedError),
    "secagg_in_simulation": (dict(enable_secagg=True), NotImplementedError),
    "fhe_in_simulation": (dict(enable_fhe=True), NotImplementedError),
    "unknown_attack": (dict(enable_attack=True, attack_type="mind_control"), ValueError),
    "unknown_defense": (dict(enable_defense=True, defense_type="mind_shield"), ValueError),
    "myavg_on_agg_defense": (dict(enable_defense=True, defense_type="coordinate_median"),
                             NotImplementedError),
    "myavg_contribution": (dict(enable_contribution=True), NotImplementedError),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_match_the_reference(tmp_path, case):
    import fedml_tpu
    import fedml_tpu_torch
    from fedml_tpu.runner import FedMLRunner as RefRunner
    from fedml_tpu_torch.runner import FedMLRunner

    kw, exc = REFUSALS[case]
    if case.startswith("myavg"):
        from .test_torch_myavg import _cfgs as myavg_cfgs

        ref_cfg, cfg = myavg_cfgs(tmp_path, **kw)
    else:
        ref_cfg, cfg = _cfgs(tmp_path, "lr", **kw)
    fedml_tpu.init(ref_cfg)
    with pytest.raises(exc) as ref_err:
        RefRunner(ref_cfg)
    fedml_tpu_torch.init(cfg)
    with pytest.raises(exc) as err:
        FedMLRunner(cfg, device="cpu")
    if exc is ValueError:
        assert str(err.value) == str(ref_err.value)


def test_no_trust_flag_builds_no_pipeline(tmp_path):
    """With every trust flag off the simulator builds no pipeline and keeps
    no history: the round does no trust work."""
    _, cfg = _cfgs(tmp_path, "lr")
    sim = _port_sim(cfg, _models("lr")[1])
    assert sim.trust is None and sim.defense_history is None
    assert dataclasses.asdict(cfg)["enable_dp"] is False
