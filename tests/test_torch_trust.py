"""Port parity: the trust stack's modules (``fedml_tpu_torch/trust/``: the 24
registered defenses, the attacks, local / central DP and NbAFL, the RDP
accountant, the pipeline's hooks, contribution) and the matrix helpers of
``core/pytree.py`` against ``fedml_tpu/trust/`` on the CPU.

The same seeded numpy inputs go through both packages; every random draw is
the reference's (``jax.random`` from the same key), handed to the port
through its sampler or draw hook (:class:`JaxTrustSampler`, also used by
``tests/test_torch_trust_sim.py``).  The reference runs eagerly here (no
``jit``), so XLA contracts nothing into an FMA.

Tolerances, stated per check:

- host numpy (the data attacks, the accountant, NbAFL's sigmas, the matrix
  layout) and selections (Krum's, the three-sigma family's and cross-round's
  0/1 weights, the malicious mask): bitwise;
- the model attacks (elementwise ``where`` / ``a + b * c``): bitwise;
- local and central DP, ``x + noise * sigma`` rounded twice in both: within
  one f32 ulp of the result (measured: bitwise);
- every defense's updates, weights, aggregate and post-processed global:
  rtol 1e-5 / atol 1e-6 (norms, means and Gram matrices sum in another
  order; FoolsGold's and the residual reweighting's weights pass through
  ``log`` / a division of such sums);
- the median and the percentile helpers: bitwise against ``jnp.median`` /
  ``jnp.percentile``, and on a row of 2**24 + 1 elements bitwise against
  ``jnp.percentile``'s formula on numpy's sorted row (JAX places the
  position in f32, where n - 1 rounds) and within one order-statistic gap of
  numpy's f64 percentile;
- contribution scores from the same evaluation function: within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

DEFENSE_RTOL, DEFENSE_ATOL = 1e-5, 1e-6
# defenses whose weights are 0/1 selections (times the counts): bitwise
SELECTIONS = ("krum", "multikrum", "three_sigma", "three_sigma_geomedian", "three_sigma_krum",
              "cross_round")


def _jax_draw(key, kind, shape):
    fn = jax.random.normal if kind == "gaussian" else jax.random.laplace
    return np.array(fn(key, shape, jnp.float32))


class JaxTrustSampler:
    """The reference's trust draws as a port sampler (``trust/dp/dp.py``
    ``NoiseSampler``'s methods): every stream folded into the round key
    ``round_key(root, r)`` with the reference's tags; local DP's rows from
    ``split(fold_in(round key, 0x1D9), m)``, laid end to end."""

    def __init__(self, root_key):
        self.root = root_key
        self.calls = []

    def _key(self, r, tag):
        from fedml_tpu.core import rng

        return jax.random.fold_in(rng.round_key(self.root, r), tag)

    def _out(self, a, device):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def gaussian(self, r, shape, device):
        self.calls.append(("cdp", r, tuple(shape)))
        return self._out(_jax_draw(self._key(r, 0xCD9), "gaussian", shape), device)

    def laplace(self, r, shape, device):
        self.calls.append(("cdp_laplace", r, tuple(shape)))
        return self._out(_jax_draw(self._key(r, 0xCD9), "laplace", shape), device)

    def local(self, r, kind, m, d, device):
        self.calls.append(("ldp", r, kind, m, d))
        keys = jax.random.split(self._key(r, 0x1D9), m)
        rows = [_jax_draw(k, kind, (d,)) for k in keys]
        return self._out(np.concatenate(rows), device)

    def attack(self, r, shape, device):
        self.calls.append(("attack", r, tuple(shape)))
        return self._out(_jax_draw(self._key(r, 0xA77), "gaussian", shape), device)

    def defense(self, r, kind, shape, device):
        self.calls.append(("defense", r, kind, tuple(shape)))
        return self._out(_jax_draw(self._key(r, 0xDEF), kind, shape), device)


def _cfgs(**kw):
    import fedml_tpu.arguments as ref_args
    import fedml_tpu_torch.arguments as args

    return ref_args.Config(**kw), args.Config(**kw)


def _inputs(case, seed=0, d=40):
    """(updates, weights, global, history, new global) numpy inputs: ``m``
    even or odd with an outlier row, or duplicated rows of +-1 around a zero
    global, 16 wide (every norm 4, every product and sum exact: scores tie
    exactly in both packages)."""
    rs = np.random.RandomState(seed)
    m = {"even": 8, "odd": 7, "ties": 8}[case]
    if case == "ties":
        d = 16
        g = np.zeros(d, np.float32)
        base = rs.choice([-1.0, 1.0], (m // 2, d)).astype(np.float32)
        u = np.concatenate([base, base])
        w = np.full(m, 4.0, np.float32)
        prev = np.zeros(d, np.float32)
    else:
        g = rs.normal(0, 1, d).astype(np.float32)
        u = (g + rs.normal(0, 0.3, (m, d))).astype(np.float32)
        u[2] += 4.0  # an outlier
        w = rs.randint(5, 30, m).astype(np.float32)
        prev = rs.normal(0, 0.2, d).astype(np.float32)
    new_g = (g + rs.normal(0, 0.5, d)).astype(np.float32)
    return u, w, g, prev, new_g


DEFENSE_CFG = dict(enable_defense=True, byzantine_client_num=1, krum_param_m=3, norm_bound=2.0,
                   trimmed_mean_beta=0.2, outlier_detection_k=1.0,
                   extra={"soteria_percentile": 30.0, "wbc_pert_strength": 0.5})


def _reference_hooks(name, u, w, g, prev, new_g, key):
    from fedml_tpu.trust.defense import create

    ref_cfg, _ = _cfgs(defense_type=name, **DEFENSE_CFG)
    dfn = create(ref_cfg)
    if hasattr(dfn, "set_key"):
        dfn.set_key(key)
    if hasattr(dfn, "set_history"):
        dfn.set_history(jnp.asarray(prev))
    mat, wts = dfn.before(jnp.asarray(u), jnp.asarray(w), jnp.asarray(g))
    agg = dfn.on_agg(mat, wts, jnp.asarray(g))
    after = dfn.after(jnp.asarray(new_g), jnp.asarray(g))
    return (np.asarray(mat), np.asarray(wts), None if agg is None else np.asarray(agg),
            np.asarray(after))


def _port_hooks(name, u, w, g, prev, new_g, key):
    from fedml_tpu_torch.trust.defense import create
    from fedml_tpu_torch.trust.defense.base import DrawingDefense

    _, cfg = _cfgs(defense_type=name, **DEFENSE_CFG)
    dfn = create(cfg)
    if isinstance(dfn, DrawingDefense):
        dfn.set_draw(lambda kind, shape: torch.from_numpy(_jax_draw(key, kind, shape).copy()))
    if hasattr(dfn, "set_history"):
        dfn.set_history(torch.from_numpy(prev))
    t = torch.from_numpy
    mat, wts = dfn.before(t(u), t(w), t(g))
    agg = dfn.on_agg(mat, wts, t(g))
    after = dfn.after(t(new_g), t(g))
    return mat.numpy(), wts.numpy(), None if agg is None else agg.numpy(), after.numpy()


def _names():
    from fedml_tpu.trust.defense import names

    return names()


@pytest.mark.parametrize("case", ["even", "odd", "ties"])
@pytest.mark.parametrize("name", _names())
def test_defense_hooks_match_reference(name, case):
    """``before`` / ``on_agg`` / ``after`` of each of the 24 registered names
    on the same matrix (m even, m odd, tied scores), with the history and
    the draws of the reference."""
    u, w, g, prev, new_g = _inputs(case)
    key = jax.random.PRNGKey(11)
    want = _reference_hooks(name, u, w, g, prev, new_g, key)
    got = _port_hooks(name, u, w, g, prev, new_g, key)
    for what, a, b in zip(("updates", "weights", "aggregate", "after"), got, want):
        if b is None:
            assert a is None, what
            continue
        assert a.shape == b.shape and a.dtype == b.dtype, what
        if what == "weights" and name in SELECTIONS:
            np.testing.assert_array_equal(a, b, err_msg=what)
        else:
            np.testing.assert_allclose(a, b, rtol=DEFENSE_RTOL, atol=DEFENSE_ATOL, err_msg=what)
    if name in SELECTIONS and case != "ties":
        assert (want[1] == 0).any() and (want[1] > 0).any(), "the selection is not vacuous"


def test_registry_and_unknown_names_match_reference():
    from fedml_tpu.trust.defense import create as ref_create
    from fedml_tpu_torch.trust.defense import create, names

    assert names() == _names() and len(names()) == 24
    ref_cfg, cfg = _cfgs(enable_defense=True, defense_type="mind_shield")
    with pytest.raises(ValueError) as ref_err:
        ref_create(ref_cfg)
    with pytest.raises(ValueError) as err:
        create(cfg)
    assert str(err.value) == str(ref_err.value)


@pytest.mark.parametrize("m", [1, 2, 7, 8, 64])
def test_median_matches_jnp_median(m):
    """``jnp.median`` averages the two middle values of an even count; the
    port's helper too (``torch.median`` would return the lower one)."""
    from fedml_tpu_torch.trust.defense.base import median0

    x = np.random.RandomState(m).normal(0, 1, (m, 33)).astype(np.float32)
    want = np.asarray(jnp.median(jnp.asarray(x), axis=0))
    np.testing.assert_array_equal(median0(torch.from_numpy(x)).numpy(), want)
    np.testing.assert_array_equal(median0(torch.from_numpy(x[:, 0].copy())[:, None]).numpy(),
                                  want[:1])


@pytest.mark.parametrize("p", [0.0, 1.0, 30.0, 50.0, 99.5, 100.0])
def test_percentile_matches_jnp_percentile(p):
    from fedml_tpu_torch.trust.defense.base import percentile_rows

    x = np.random.RandomState(3).normal(0, 1, (3, 1001)).astype(np.float32)
    x[1, :500] = 0.25  # ties
    want = np.asarray(jnp.percentile(jnp.asarray(x), p, axis=1, keepdims=True))
    np.testing.assert_array_equal(percentile_rows(torch.from_numpy(x), p).numpy(), want)


def test_percentile_on_a_row_past_torch_quantile():
    """One row of 2**24 + 1 elements (``torch.quantile`` refuses more than
    2**24) against numpy: bitwise ``jnp.percentile``'s formula on numpy's
    sorted row (the position ``p / 100 * (n - 1)`` in f32, where ``n``
    itself rounds to 2**24, then ``lo * (1 - w) + hi * w`` in f32), and
    within one order-statistic gap of numpy's own f64 linear percentile."""
    from fedml_tpu_torch.trust.defense.base import percentile_rows

    n = 2**24 + 1
    x = np.random.default_rng(5).standard_normal(n, dtype=np.float32)
    s = np.sort(x)
    for p in (1.0, 50.0, 99.9):
        got = percentile_rows(torch.from_numpy(x)[None], p)[0, 0].numpy()
        pos = np.float32(p) / np.float32(100) * (np.float32(n) - np.float32(1))
        lo, hi = int(np.floor(pos)), int(np.ceil(pos))
        hw = np.float32(pos - np.float32(lo))
        want = s[lo] * (np.float32(1) - hw) + s[hi] * hw
        assert want.dtype == np.float32 and got == want, (p, got, want)
        gap = s[min(hi + 1, n - 1)] - s[max(lo - 1, 0)]
        assert abs(float(got) - np.percentile(x, p)) <= gap


def test_matrix_rows_are_the_reference_rows():
    """``stacked_tree_to_matrix`` of the port's lane-stacked tree (torch
    layouts) is bitwise the reference's matrix of the same weights in flax
    layout, for a structured tree too; ``matrix_to_stacked_tree`` inverts it
    with layouts and dtypes."""
    from fedml_tpu.core import pytree as ref_pt
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.core import pytree as pt

    rs = np.random.RandomState(0)
    flax = {"variables": {"params": {"Conv_0": {"kernel": rs.randn(4, 3, 3, 2, 5)},
                                     "Dense_0": {"kernel": rs.randn(4, 7, 3),
                                                 "bias": rs.randn(4, 3)}},
                          "batch_stats": {"mean": rs.randn(4, 5)}},
            "delta_c": {"Dense_0": {"kernel": rs.randn(4, 7, 3)}}, "a": rs.randn(4)}
    flax = jax.tree_util.tree_map(lambda a: a.astype(np.float32), flax)
    want = np.asarray(ref_pt.stacked_tree_to_matrix(jax.tree_util.tree_map(jnp.asarray, flax)))
    lanes = [jax.tree_util.tree_map(lambda a, i=i: a[i], flax) for i in range(4)]
    port = pt.tree_stack([weights.to_torch(weights.flax_to_torch(t)) if isinstance(t, dict)
                          else t for t in lanes])
    mat = pt.stacked_tree_to_matrix(port)
    np.testing.assert_array_equal(mat.numpy(), want)
    back = pt.matrix_to_stacked_tree(mat, port)
    for a, b in zip(pt.tree_leaves(back), pt.tree_leaves(port)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# attacks
# ---------------------------------------------------------------------------

ATTACK_CFG = dict(enable_attack=True, poisoned_client_list=(1, 4, 9),
                  extra={"attack_boost": 5.0, "attack_original_class": 0,
                         "attack_target_class": 1, "attack_poison_frac": 0.5})


@pytest.mark.parametrize("attack", ["byzantine_random", "byzantine_zero", "byzantine_flip",
                                    "model_replacement", "lazy_worker"])
def test_model_attacks_bitwise(attack):
    from fedml_tpu.trust.attack.attacks import FedMLAttacker as RefAttacker
    from fedml_tpu_torch.trust.attack.attacks import FedMLAttacker

    ref_cfg, cfg = _cfgs(attack_type=attack, **ATTACK_CFG)
    u, _, g, _, _ = _inputs("even")
    sampled = np.array([4, 0, 9, 3, 1, 7, 2, 5])
    key = jax.random.PRNGKey(3)
    want = np.asarray(RefAttacker(ref_cfg).poison_model(jnp.asarray(u), jnp.asarray(sampled),
                                                        jnp.asarray(g), key))
    atk = FedMLAttacker(cfg)
    noise = torch.from_numpy(_jax_draw(key, "gaussian", u.shape)) if atk.needs_draw() else None
    got = atk.poison_model(torch.from_numpy(u), sampled, torch.from_numpy(g), noise).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[[1, 3, 5, 6]] == u[[1, 3, 5, 6]]).all()  # honest rows untouched


def _dataset(pkg_dataset, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.normal(0, 1, (120, 4, 4, 3)).astype(np.float32)
    y = rs.randint(0, 3, 120)
    idx = [np.arange(i * 12, (i + 1) * 12) for i in range(10)]
    return pkg_dataset(train_x=x, train_y=y, test_x=x[:8], test_y=y[:8], client_idx=idx,
                       class_num=3)


@pytest.mark.parametrize("attack", ["label_flipping", "backdoor", "edge_case_backdoor"])
def test_data_attacks_bitwise(tmp_path, attack):
    """``poison_data`` on the host dataset, bitwise (the edge-case sets are
    not on disk: the synthesized tail, as in the reference)."""
    from fedml_tpu.data.dataset import FederatedDataset as RefDataset
    from fedml_tpu.trust.attack.attacks import FedMLAttacker as RefAttacker
    from fedml_tpu_torch.data.dataset import FederatedDataset
    from fedml_tpu_torch.trust.attack.attacks import FedMLAttacker

    ref_cfg, cfg = _cfgs(attack_type=attack, data_cache_dir=str(tmp_path), **ATTACK_CFG)
    want = RefAttacker(ref_cfg).poison_data(_dataset(RefDataset))
    got = FedMLAttacker(cfg).poison_data(_dataset(FederatedDataset))
    np.testing.assert_array_equal(got.train_x, want.train_x)
    np.testing.assert_array_equal(got.train_y, want.train_y)
    clean = _dataset(FederatedDataset)
    assert (got.train_y != clean.train_y).any()  # something was poisoned


def test_edge_case_backdoor_with_edge_examples_bitwise():
    from fedml_tpu.trust.attack.attacks import edge_case_backdoor as ref_edge
    from fedml_tpu_torch.data.extra_loaders import load_edge_case_sets
    from fedml_tpu_torch.trust.attack.attacks import edge_case_backdoor

    rs = np.random.RandomState(2)
    x = rs.normal(0, 1, (60, 4, 4, 3)).astype(np.float32)
    y = rs.randint(0, 3, 60)
    idx = [np.arange(i * 10, (i + 1) * 10) for i in range(6)]
    edge = rs.uniform(0, 1, (9, 4, 4, 3)).astype(np.float32)
    for examples in (edge, edge[:, :2]):  # the second's shape mismatches: synthesized
        want = ref_edge(x, idx, [0, 3], 2, y, frac=0.5, edge_examples=examples)
        got = edge_case_backdoor(x, idx, [0, 3], 2, y, frac=0.5, edge_examples=examples)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    from pathlib import Path

    assert load_edge_case_sets(Path("/nonexistent-cache"), "southwest") is None


def test_unknown_attack_raises_like_the_reference():
    from fedml_tpu.trust.attack.attacks import FedMLAttacker as RefAttacker
    from fedml_tpu_torch.trust.attack.attacks import FedMLAttacker

    ref_cfg, cfg = _cfgs(attack_type="mind_control", **ATTACK_CFG)
    with pytest.raises(ValueError) as ref_err:
        RefAttacker(ref_cfg)
    with pytest.raises(ValueError) as err:
        FedMLAttacker(cfg)
    assert str(err.value) == str(ref_err.value)


# ---------------------------------------------------------------------------
# DP
# ---------------------------------------------------------------------------

def _ulps(a, b):
    return np.abs(a.astype(np.float64) - b.astype(np.float64)) / np.spacing(
        np.maximum(np.abs(a), np.abs(b)).astype(np.float32)).astype(np.float64)


@pytest.mark.parametrize("mechanism", ["gaussian", "laplace"])
@pytest.mark.parametrize("solution", ["ldp", "cdp", "nbafl"])
def test_dp_noise_matches_reference(solution, mechanism):
    """Local DP over the (m, d) matrix in one call (one kernel launch on the
    card; the m rows' draws laid end to end) and central DP on a vector,
    against the reference with its draws: within one f32 ulp."""
    from fedml_tpu.trust.dp.dp import FedMLDifferentialPrivacy as RefDP
    from fedml_tpu_torch.trust.dp.dp import FedMLDifferentialPrivacy

    ref_cfg, cfg = _cfgs(enable_dp=True, dp_solution_type=solution, mechanism_type=mechanism,
                         epsilon=2.0, delta=1e-5, sensitivity=0.5, clipping_norm=1.0)
    ref, dp = RefDP(ref_cfg), FedMLDifferentialPrivacy(cfg)
    assert (dp.is_ldp_enabled(), dp.is_cdp_enabled()) == (ref.is_ldp_enabled(),
                                                          ref.is_cdp_enabled())
    u, _, g, _, _ = _inputs("odd")
    sampler = JaxTrustSampler(jax.random.PRNGKey(9))
    if dp.is_ldp_enabled():
        m, d = u.shape
        keys = jax.random.split(sampler._key(2, 0x1D9), m)
        want = np.asarray(jax.vmap(ref.add_local_noise)(jnp.asarray(u), keys))
        got = dp.add_local_noise(torch.from_numpy(u), sampler.local(2, mechanism, m, d, "cpu"))
        assert got.shape == (m, d) and _ulps(got.numpy(), want).max() <= 1.0
    if dp.is_cdp_enabled():
        clipped = np.asarray(ref.global_clip(jnp.asarray(g)))
        got_clip = dp.global_clip(torch.from_numpy(g)).numpy()
        np.testing.assert_allclose(got_clip, clipped, rtol=1e-6, atol=1e-7)
        want = np.asarray(ref.add_global_noise(jnp.asarray(clipped), sampler._key(2, 0xCD9)))
        draw = (sampler.gaussian if mechanism == "gaussian" else sampler.laplace)(
            2, clipped.shape, "cpu")
        got = dp.add_global_noise(torch.from_numpy(clipped), draw).numpy()
        assert _ulps(got, want).max() <= 1.0


def test_nbafl_sigmas_and_accountant_bitwise():
    from fedml_tpu.trust.dp import accountant as ref_acc, dp as ref_dp
    from fedml_tpu_torch.trust.dp import accountant, dp

    for args in ((1.0, 100, 2.0, 1e-5), (0.3, 1, 0.5, 1e-3)):
        assert dp.nbafl_uplink_sigma(*args) == ref_dp.nbafl_uplink_sigma(*args)
    for args in ((1.0, 100, 5, 2.0, 1e-5), (1.0, 100, 50, 2.0, 1e-5), (0.5, 9, 4, 1.0, 1e-4)):
        assert dp.nbafl_downlink_sigma(*args) == ref_dp.nbafl_downlink_sigma(*args)
    assert dp.gaussian_sigma(2.0, 1e-5, 0.5) == ref_dp.gaussian_sigma(2.0, 1e-5, 0.5)
    for q, sigma in ((0.01, 1.0), (1.0, 2.0), (0.0, 1.0), (0.2, 0.7)):
        a, b = accountant.RDPAccountant(q, sigma), ref_acc.RDPAccountant(q, sigma)
        for n in (1, 10, 990):
            a.step(n)
            b.step(n)
            assert a.get_epsilon(1e-5) == b.get_epsilon(1e-5)
        np.testing.assert_array_equal(accountant.compute_rdp(q, sigma, 7),
                                      ref_acc.compute_rdp(q, sigma, 7))


# ---------------------------------------------------------------------------
# the pipeline's hooks and contribution
# ---------------------------------------------------------------------------

def _contribs(m, seed=0):
    """A lane-stacked weight tree (a Dense and a conv kernel, a bias, a BN
    statistic), flax layout, and the global it came from."""
    rs = np.random.RandomState(seed)
    g = {"params": {"Conv_0": {"kernel": rs.randn(3, 3, 2, 4)},
                    "Dense_0": {"kernel": rs.randn(5, 3), "bias": rs.randn(3)}},
         "batch_stats": {"BatchNorm_0": {"mean": rs.randn(4)}}}
    g = jax.tree_util.tree_map(lambda a: a.astype(np.float32), g)
    stacked = jax.tree_util.tree_map(
        lambda a: (a[None] + 0.3 * rs.randn(m, *a.shape)).astype(np.float32), g)
    stacked["params"]["Dense_0"]["bias"][1] += 3.0  # an outlier
    return g, stacked


@pytest.mark.parametrize("flags", [
    dict(enable_attack=True, attack_type="byzantine_random", poisoned_client_list=(5, 2),
         enable_defense=True, defense_type="multikrum", byzantine_client_num=1, krum_param_m=3),
    dict(enable_dp=True, dp_solution_type="nbafl", epsilon=20.0, sensitivity=0.1,
         clipping_norm=0.5, enable_defense=True, defense_type="weak_dp", norm_bound=1.0),
    dict(enable_defense=True, defense_type="bulyan", byzantine_client_num=1),
    dict(enable_defense=True, defense_type="crfl", norm_bound=3.0),
    dict(enable_attack=True, attack_type="lazy_worker", poisoned_client_list=(5,),
         enable_defense=True, defense_type="cross_round"),
], ids=["byzantine_multikrum", "nbafl_weak_dp", "bulyan", "crfl", "lazy_cross_round"])
def test_pipeline_hooks_match_reference(flags):
    """The three hooks on a weight tree, flax kernels relaid by the port,
    with the reference's draws keyed by the round (rtol 1e-5 / atol 1e-6;
    Krum's weights bitwise)."""
    from fedml_tpu.core import rng as ref_rng
    from fedml_tpu.trust.pipeline import build_trust_pipeline as ref_build
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.trust.pipeline import build_trust_pipeline

    ref_cfg, cfg = _cfgs(**flags)
    m, r = 6, 3
    g, stacked = _contribs(m)
    w = np.arange(1, m + 1).astype(np.float32) * 3
    sampled = np.array([7, 5, 0, 2, 3, 4])
    root = jax.random.PRNGKey(4)
    rkey = ref_rng.round_key(root, r)
    prev = np.random.RandomState(1).randn(sum(a.size for a in jax.tree_util.tree_leaves(g)))
    prev = prev.astype(np.float32)

    ref = ref_build(ref_cfg)
    jg = jax.tree_util.tree_map(jnp.asarray, g)
    c, ww = ref.on_client_outputs(jax.tree_util.tree_map(jnp.asarray, stacked), jnp.asarray(w),
                                  jnp.asarray(sampled), jg, rkey)
    c, ww, agg = ref.on_aggregation(c, ww, jg, rkey, prev_delta=jnp.asarray(prev))
    new = jax.tree_util.tree_map(lambda a: a + 0.1, jg)
    after = ref.on_after_aggregation(new, jg, rkey)

    tp = build_trust_pipeline(cfg, sampler=JaxTrustSampler(root))
    pg = weights.to_torch(weights.flax_to_torch(g))
    lanes = [jax.tree_util.tree_map(lambda a, i=i: a[i], stacked) for i in range(m)]
    ps = pt.tree_stack([weights.to_torch(weights.flax_to_torch(t)) for t in lanes])
    pc, pw = tp.on_client_outputs(ps, torch.from_numpy(w), sampled, pg, r)
    pc, pw, pagg = tp.on_aggregation(pc, pw, pg, r, prev_delta=torch.from_numpy(prev))
    pnew = pt.tree_map(lambda a: a + 0.1, pg)
    pafter = tp.on_after_aggregation(pnew, pg, r)

    from fedml_tpu.core import pytree as ref_pt

    def close(a, b, what):
        np.testing.assert_allclose(a, b, rtol=DEFENSE_RTOL, atol=DEFENSE_ATOL, err_msg=what)

    close(pt.stacked_tree_to_matrix(pc).numpy(), np.asarray(ref_pt.stacked_tree_to_matrix(c)),
          "contributions")
    if flags.get("defense_type") in SELECTIONS:
        np.testing.assert_array_equal(pw.numpy(), np.asarray(ww))
    close(pw.numpy(), np.asarray(ww), "weights")
    assert (pagg is None) == (agg is None)
    if agg is not None:
        close(weights.flatten_reference(pagg)[0].numpy(),
              np.asarray(ref_pt.tree_flatten_to_vector(agg)[0]), "aggregate")
    close(weights.flatten_reference(pafter)[0].numpy(),
          np.asarray(ref_pt.tree_flatten_to_vector(after)[0]), "after")


def test_trust_pipeline_is_none_without_flags():
    from fedml_tpu_torch.trust.pipeline import build_trust_pipeline

    _, cfg = _cfgs()
    assert build_trust_pipeline(cfg) is None
    _, cfg = _cfgs(enable_dp=True, dp_solution_type="cdp")
    assert build_trust_pipeline(cfg).supports_streaming()


@pytest.mark.parametrize("method", ["leave_one_out", "gtg_shapley"])
def test_contribution_scores_match_reference(method):
    """The reference's own toy game (1-d models, ``eval = -|model - 1|``) and
    a 5-client one: the same coalitions walked, the scores within 1e-6."""
    from fedml_tpu.trust import contribution as ref_contrib
    from fedml_tpu_torch.trust import contribution

    rs = np.random.RandomState(0)
    vals = np.concatenate([[1.0, 1.0, -5.0], rs.normal(0, 2, 2)]).astype(np.float32)
    weights = np.array([1.0, 2.0, 1.0, 3.0, 1.0])

    def ref_eval(model):
        return -abs(float(np.asarray(model["w"]).reshape(-1)[0]) - 1.0)

    def port_eval(model):
        return -abs(float(model["w"].reshape(-1)[0]) - 1.0)

    ref_stacked, empty = {"w": jnp.asarray(vals[:, None])}, {"w": jnp.asarray([0.0])}
    stacked, pempty = {"w": torch.from_numpy(vals[:, None].copy())}, {"w": torch.zeros(1)}
    fn = getattr(contribution, method)
    ref_fn = getattr(ref_contrib, method)
    kw = dict(rounds_cap=30, eps=1e-4, seed=0) if method == "gtg_shapley" else {}
    want = ref_fn(ref_stacked, weights, ref_eval, empty, **kw)
    got = fn(stacked, weights, port_eval, pempty, **kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.abs(got).sum() > 0
    _, cfg = _cfgs(enable_contribution=True, contribution_method="banzhaf")
    with pytest.raises(ValueError, match="unknown contribution_method"):
        contribution.ContributionAssessorManager(cfg).assess(stacked, weights, port_eval, pempty)
