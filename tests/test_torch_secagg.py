"""Port parity: cross-silo Shamir SecAgg with the streaming field fold and
central DP (``fedml_tpu_torch/cross_silo``) against
``fedml_tpu/cross_silo/secagg_shamir.py``.

(a) the masked upload of the same ResNet-20 weights, (b) the aggregator's
finalize on the same masked uploads and reveals, with and without central
DP and with a dropout, (c) the whole 4-client run through ``FedMLRunner``
against the reference's ``run_shamir_secagg_process_group``, (d) the
refusals.

Tolerances: (a) and the finalize without DP are bitwise (exact field math,
the same f64 -> f32 rounding).  With central DP the clip's norm sums
271,098 f32 squares in another order than XLA (PyTorch's CPU norm is off
the f64 norm by 1.2e-6 relative, XLA's by 3e-8): the clipped global is held
to one ulp (the add after the clip) plus 1e-5 of the clipped delta's
largest element (measured 1.2e-6), the noised global to two ulps (the
interpret kernel's FMA rounds once) plus the same.  (c) is held as the
two-round simulation test holds its run (``tests/test_torch_sim.py``): every leaf
within 5e-2 of its own update's scale, the flat update within 1e-2
(relative L2); the reference's f32 gradients drift at that level.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

DP_KW = dict(enable_dp=True, dp_solution_type="cdp", mechanism_type="gaussian", epsilon=50.0,
             delta=1e-5, sensitivity=0.01, clipping_norm=1.0)
P = 2**31 - 1


def _cfgs(tmp_path, run_id, extra=None, **kw):
    """(reference Config, port Config) of a 4-silo Shamir SecAgg run."""
    import fedml_tpu.arguments as ref_args
    import fedml_tpu_torch.arguments as args

    base = dict(dataset="cifar10", model="resnet20", client_num_in_total=4,
                client_num_per_round=4, comm_round=2, epochs=1, batch_size=8,
                learning_rate=0.05, synthetic_train_size=64, synthetic_test_size=40,
                partition_method="hetero", partition_alpha=0.5, frequency_of_the_test=1,
                compute_dtype="float32", random_seed=0, training_type="cross_silo",
                role="server", backend="INPROC", enable_secagg=True, run_id=run_id,
                data_cache_dir=str(tmp_path),
                extra={"secagg_method": "shamir", "secagg_stream": True, **(extra or {})})
    base.update(kw)
    return ref_args.Config(**base), args.Config(**base)


class JaxNoise:
    """The reference's central-DP draws as the port's noise sampler, keyed
    ``fold_in(round_key(root, r), 0xCD9)``: ``normal`` of the padded shape
    (``ops/pallas/noise.py``) or ``laplace`` of the vector's
    (``trust/dp/dp.py``)."""

    def __init__(self, seed):
        from fedml_tpu.core import rng

        self.root = rng.root_key(seed)
        self.calls = []
        self.last = None

    def _key(self, round_idx):
        from fedml_tpu.core import rng

        return jax.random.fold_in(rng.round_key(self.root, round_idx), 0xCD9)

    def gaussian(self, round_idx, shape, device):
        self.calls.append((round_idx, tuple(shape)))
        self.last = np.array(jax.random.normal(self._key(round_idx), shape, jnp.float32))
        return torch.from_numpy(self.last).to(device)

    def laplace(self, round_idx, shape, device):
        self.calls.append((round_idx, tuple(shape)))
        self.last = np.array(jax.random.laplace(self._key(round_idx), shape, jnp.float32))
        return torch.from_numpy(self.last).to(device)


def _ref_flat(tree):
    import jax.flatten_util

    return np.asarray(jax.flatten_util.ravel_pytree(tree)[0])


def _port_as_flax(global_vars):
    from fedml_tpu_torch import weights

    return weights.torch_to_flax(weights.to_numpy(global_vars))


def _ref_aggregator(ref_cfg):
    from fedml_tpu.cross_silo.secagg_shamir import SAAggregator

    test = (np.zeros((32, 32, 32, 3), np.float32), np.zeros(32, np.int32), 32)
    return SAAggregator(ref_cfg, _flax_model(), np.zeros((8, 32, 32, 3), np.float32), test)


def _flax_model():
    from fedml_tpu.models import resnet as flax_resnet

    return flax_resnet.resnet20(10)


def _port_aggregator(cfg, ref_agg, noise_sampler=None):
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.cross_silo.secagg_shamir import SAAggregator
    from fedml_tpu_torch.models import resnet

    test = (np.zeros((32, 32, 32, 3), np.float32), np.zeros(32, np.int64), 32)
    init = weights.flax_to_torch(jax.tree_util.tree_map(np.asarray, ref_agg.global_vars))
    return SAAggregator(cfg, resnet.resnet20(10), test, "cpu", global_vars=weights.to_torch(init),
                        noise_sampler=noise_sampler)


class _Cohort:
    """Four clients' secrets, made from a seed (the run draws them from
    os.urandom): DH key pairs, self-mask seeds b_u, and their Shamir
    shares."""

    def __init__(self, t, seed=11):
        from fedml_tpu_torch.cross_silo import secagg_shamir as sa
        from fedml_tpu_torch.trust.secagg.shamir import shamir_share

        rs = np.random.RandomState(seed)
        self.ids = [1, 2, 3, 4]
        self.s_sk = {u: int(rs.randint(2, P - 1)) for u in self.ids}
        self.s_pk = {u: pow(sa.DH_G, self.s_sk[u], P) for u in self.ids}
        self.b = {u: int(rs.randint(0, 2**31)) for u in self.ids}
        self.b_shares = {u: shamir_share(self.b[u], 4, t + 1, rs) for u in self.ids}
        self.sk_shares = {u: shamir_share(self.s_sk[u], 4, t + 1, rs) for u in self.ids}

    def seeds(self, u, round_idx):
        from fedml_tpu_torch.cross_silo import secagg_shamir as sa

        peers = {v: sa.derive_round_seed(sa.dh_agree(self.s_sk[u], self.s_pk[v]), round_idx)
                 for v in self.ids if v != u}
        return peers, sa.derive_round_seed(self.b[u], round_idx)

    def reveals(self, v, survivors):
        dropped = [u for u in self.ids if u not in survivors]
        return ({str(u): self.b_shares[u][v - 1][1] for u in survivors},
                {str(u): self.sk_shares[u][v - 1][1] for u in dropped})


def test_masked_upload_bitwise_the_reference_composition():
    """(a) The same full-width ResNet-20 weights (carried across) and seeds:
    the port's flatten_reference -> quantize_to_field -> mask_vector ->
    pack_ring equals the reference's ravel_pytree composition, bitwise;
    so does the buffer-all int64 upload, and the protocol's seed helpers."""
    from fedml_tpu.cross_silo import secagg_shamir as ref_sa
    from fedml_tpu.trust.secagg import stream as ref_stream
    from fedml_tpu.trust.secagg.field import quantize_to_field as ref_quantize
    from fedml_tpu.trust.secagg.shamir import masked_input as ref_masked_input
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.cross_silo import secagg_shamir as sa
    from fedml_tpu_torch.trust.secagg import stream

    variables = jax.tree_util.tree_map(np.asarray, _flax_model().init(
        jax.random.PRNGKey(5), np.zeros((1, 32, 32, 3), np.float32), train=False))
    port_vars = weights.to_torch(weights.flax_to_torch(variables))
    ref_flat = _ref_flat(variables)
    flat = weights.flatten_reference(port_vars)[0].numpy()
    # params and BN statistics: the vector SecAgg masks and the noise meets
    assert flat.shape == (271098,) and np.array_equal(flat, ref_flat)

    cohort = _Cohort(t=2)
    peers, self_seed = cohort.seeds(2, round_idx=1)
    ring = stream.ring_for(None, 4, q_bits=16, q8_frac_bits=7)
    packed, meta = sa.mask_upload(flat, 2, peers, self_seed, 16, ring)
    ref_ring = ref_stream.ring_for(None, 4, q_bits=16, q8_frac_bits=7)
    want = ref_stream.pack_ring(ref_stream.mask_vector(
        ref_quantize(ref_flat, bits=16), 2, peers, self_seed, ref_ring.modulus), ref_ring.bits)
    assert packed.dtype == want.dtype and packed.tobytes() == want.tobytes()
    assert meta == dict(ref_ring.meta(271098), delta=False)
    legacy, none = sa.mask_upload(flat, 2, peers, self_seed, 16, None)
    assert none is None
    assert np.array_equal(legacy, ref_masked_input(ref_quantize(ref_flat, bits=16), 2, peers,
                                                   self_seed))
    for args in ((12345, 0), (2**31 - 2, 7)):
        assert sa.derive_round_seed(*args) == ref_sa.derive_round_seed(*args)
    assert sa._share_pad(99, 1, 3) == ref_sa._share_pad(99, 1, 3)
    assert sa.dh_agree(cohort.s_sk[1], cohort.s_pk[2]) == sa.dh_agree(cohort.s_sk[2],
                                                                      cohort.s_pk[1])


def _feed(agg, cohort, flats, survivors, round_idx=0):
    from fedml_tpu_torch.cross_silo.secagg_shamir import mask_upload

    agg.s_pk_table = dict(cohort.s_pk)
    for u in survivors:
        peers, self_seed = cohort.seeds(u, round_idx)
        packed, meta = mask_upload(flats[u], u, peers, self_seed, agg.q_bits, agg.ring)
        agg.add_masked_upload(u, packed, 1.0, meta)
    for v in survivors:
        agg.add_reveal(v, *cohort.reveals(v, survivors))


@pytest.mark.parametrize("case", ["no_dp", "no_dp_dropout", "cdp", "cdp_dropout",
                                  "cdp_laplace"])
def test_aggregator_finalize_matches_the_reference(tmp_path, case):
    """(b) The same masked uploads and reveals into both packages'
    ``SAAggregator``; ``dropout``: client 4 never uploads, its s_sk is
    reconstructed from the survivors' shares.  Without DP the new global is
    bitwise the reference's; with CDP (the reference's noise draw handed
    in) it is within the clip tolerance of the module docstring; the same
    for the Laplace mechanism (a plain add, no kernel)."""
    dp = DP_KW if case.startswith("cdp") else {}
    if case == "cdp_laplace":
        dp = dict(DP_KW, mechanism_type="laplace")
    survivors = [1, 2, 3] if case.endswith("dropout") else [1, 2, 3, 4]
    ref_cfg, cfg = _cfgs(tmp_path, f"sa_b_{case}", extra={"secagg_privacy_t": 2}, **dp)
    ref_agg = _ref_aggregator(ref_cfg)
    noise = JaxNoise(0)
    agg = _port_aggregator(cfg, ref_agg, noise)
    assert agg.model_dim == ref_agg.model_dim == 271098 and agg.field_stream
    base = _ref_flat(ref_agg.global_vars)
    rs = np.random.RandomState(1)
    # deltas of norm ~2.6 on average: the CDP clip to 1.0 engages
    flats = {u: (base + rs.normal(0, 0.01, base.size)).astype(np.float32) for u in (1, 2, 3, 4)}
    cohort = _Cohort(t=2)
    _feed(ref_agg, cohort, flats, survivors)
    _feed(agg, cohort, flats, survivors)
    ref_agg.aggregate(0)
    agg.aggregate(0)
    assert agg.peak_buffered_updates == ref_agg.peak_buffered_updates == 2
    assert (4 in agg.compromised) == (4 in ref_agg.compromised) == (len(survivors) == 3)
    want = _ref_flat(ref_agg.global_vars)
    got = _ref_flat(_port_as_flax(agg.global_vars))
    if not dp:
        assert noise.calls == []
        np.testing.assert_array_equal(got, want)
        return
    assert noise.calls == [(0, (265, 8, 128) if case != "cdp_laplace" else (271098,))]
    # the unmasked mean both packages finalize: fixed point at 2^-16, summed
    # exactly, dequantized in f64, rounded to f32
    total = sum(np.round(flats[u].astype(np.float64) * 2.0**16).astype(np.int64)
                for u in survivors)
    mean = (total.astype(np.float64) / 2.0**16) / len(survivors)
    delta = jnp.asarray(mean.astype(np.float32)) - jnp.asarray(base)
    from fedml_tpu.trust.dp.dp import clip_by_norm

    ref_clipped = np.asarray(clip_by_norm(delta, 1.0))
    assert np.linalg.norm(ref_clipped) == pytest.approx(1.0, rel=1e-5)  # the clip engaged
    ref_pre = np.asarray(jnp.asarray(base) + jnp.asarray(ref_clipped))
    pre = agg.dp_pre_noise.numpy()
    scale = np.abs(ref_clipped).max()
    assert (np.abs(pre - ref_pre) <= np.spacing(np.abs(ref_pre)) + 1e-5 * scale).all()
    scale_of_noise = agg._dp.sigma() if case != "cdp_laplace" else 0.01 / 50.0
    product = noise.last.reshape(-1)[:base.size] * np.float32(scale_of_noise)
    ulp = np.spacing(np.maximum(np.maximum(np.abs(want), np.abs(ref_pre)), np.abs(product)))
    assert (np.abs(got - want) <= 2 * ulp + 1e-5 * scale).all()
    assert not np.array_equal(got, pre)  # the noise landed


class JaxPerms:
    """The reference's per-epoch permutations of a client's local SGD
    (``client_key(round_key(root, r), client)``) as the trainer's hook."""

    def __init__(self, seed):
        from fedml_tpu.core import rng

        self.root = rng.root_key(seed)

    def __call__(self, r, client, epochs, cap):
        from fedml_tpu.core import rng

        key = rng.client_key(rng.round_key(self.root, r), client)
        return torch.from_numpy(np.stack([np.asarray(jax.random.permutation(
            jax.random.fold_in(jax.random.fold_in(key, e), 1), cap)) for e in range(epochs)]))


def _record_clip_inputs(monkeypatch, dp_cls, to_numpy):
    """Wraps ``dp_cls.global_clip``: the list it returns gets each round's
    delta before the clip, as f64 numpy."""
    seen = []
    clip = dp_cls.global_clip

    def recording(self, delta_flat):
        seen.append(to_numpy(delta_flat).astype(np.float64))
        return clip(self, delta_flat)

    monkeypatch.setattr(dp_cls, "global_clip", recording)
    return seen


def test_secagg_cdp_run_matches_the_reference(tmp_path, monkeypatch):
    """(c) Two rounds of the whole slice: the reference's
    ``run_shamir_secagg_process_group`` and the port's ``FedMLRunner(cfg,
    device="cpu")`` on a tiny fused ResNet (one block per stage), 4 silos,
    streaming SecAgg with central DP; the initial global, the clients'
    permutations and the noise draws carried across.  Per round, the test
    accuracy is the reference's, and the round delta before the clip has
    the reference's L2 norm (within 1e-2) and the same share of its squared
    norm in the BN running statistics (the head of the flat layout; within
    1e-3): how far central DP's clip to norm 1.0 moves the weights is the
    reference's behaviour, not the port's."""
    import fedml_tpu
    import fedml_tpu.trust.dp.dp as ref_dp
    import fedml_tpu_torch
    import fedml_tpu_torch.trust.dp.dp as port_dp
    from fedml_tpu.cross_silo.secagg_shamir import run_shamir_secagg_process_group
    from fedml_tpu.data import loader as ref_loader
    from fedml_tpu.models import resnet as flax_resnet
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.models import resnet
    from fedml_tpu_torch.ops import noise as nz
    from fedml_tpu_torch.runner import FedMLRunner

    ref_deltas = _record_clip_inputs(monkeypatch, ref_dp.FedMLDifferentialPrivacy, np.asarray)
    deltas = _record_clip_inputs(monkeypatch, port_dp.FedMLDifferentialPrivacy,
                                 lambda t: t.numpy())
    ref_cfg, cfg = _cfgs(tmp_path, "sa_c", extra={"fused_blocks": True}, **DP_KW)
    fedml_tpu.init(ref_cfg)
    ref_model = flax_resnet.CifarResNet(num_blocks=1, fused=True)
    ref_hist, ref_srv = run_shamir_secagg_process_group(ref_cfg, ref_loader.load(ref_cfg),
                                                        ref_model, timeout=300.0)
    init = jax.tree_util.tree_map(np.asarray, _ref_aggregator_init(ref_cfg, ref_model))

    cfg = fedml_tpu_torch.init(cfg)
    runner = FedMLRunner(cfg, model=resnet.CifarResNet(1, fused=True), device="cpu")
    group = runner.runner
    group.global_vars = weights.to_torch(weights.flax_to_torch(init))
    group.perms = JaxPerms(cfg.random_seed)
    group.noise_sampler = JaxNoise(cfg.random_seed)
    nz.reset_launch_counts()
    hist = runner.run()
    server = group.server
    assert [h["round"] for h in hist] == [0, 1] and len(ref_hist) == 2
    assert group.noise_sampler.calls == [(r, nz.noise_shape(server.aggregator.model_dim))
                                         for r in (0, 1)]
    assert nz.launch_counts() == {"gaussian_noise": 0}  # CPU: the plain version
    assert server.aggregator.field_stream and server.aggregator.peak_buffered_updates <= 2
    assert all(c.rounds_trained == 2 for c in group.clients)
    for h in hist:
        assert np.isfinite(h["test_loss"]) and 0.0 <= h["test_acc"] <= 1.0
        assert h["upload_bytes"] > 4 * 4 * server.aggregator.model_dim  # four u32 uploads
    np.testing.assert_allclose(hist[-1]["test_loss"], ref_hist[-1]["test_loss"], rtol=1e-2)
    assert [h["test_acc"] for h in hist] == [h["test_acc"] for h in ref_hist]
    n_stats = weights.flatten_reference(
        {"batch_stats": server.aggregator.global_vars["batch_stats"]})[0].numel()
    assert len(deltas) == len(ref_deltas) == 2
    for got, want in zip(deltas, ref_deltas):
        np.testing.assert_allclose(np.linalg.norm(got), np.linalg.norm(want), rtol=1e-2)
        share = [float(np.square(d[:n_stats]).sum() / np.square(d).sum()) for d in (got, want)]
        assert abs(share[0] - share[1]) <= 1e-3, share

    got = jax.tree_util.tree_leaves(_port_as_flax(server.aggregator.global_vars))
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                            ref_srv.aggregator.global_vars))
    start = jax.tree_util.tree_leaves(init)
    for a, b, i in zip(got, want, start):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.abs(a - b).max() <= 5e-2 * np.abs(b - i).max() + 1e-6
    upd = np.concatenate([(b - i).ravel() for b, i in zip(want, start)])
    diff = np.concatenate([(a - b).ravel() for a, b in zip(got, want)])
    assert np.linalg.norm(diff) <= 1e-2 * np.linalg.norm(upd)
    assert np.abs(upd).max() > 1e-3  # training moved the weights: not vacuous


def _ref_aggregator_init(ref_cfg, ref_model):
    """The reference server's initial global (deterministic from the seed)."""
    from fedml_tpu.cross_silo.secagg_shamir import SAAggregator

    test = (np.zeros((32, 32, 32, 3), np.float32), np.zeros(32, np.int32), 32)
    return SAAggregator(ref_cfg, ref_model, np.zeros((8, 32, 32, 3), np.float32),
                        test).global_vars


def test_plain_cross_silo_server_runs_through_the_runner(tmp_path):
    """The plain synchronous server (no SecAgg) on the same fabric: two
    rounds of 2 of 4 clients, selected as the reference selects them, a
    history row per round with evaluation."""
    import fedml_tpu_torch
    from fedml_tpu.core import rng as ref_rng
    from fedml_tpu_torch.core import rng
    from fedml_tpu_torch.models import resnet
    from fedml_tpu_torch.runner import FedMLRunner

    for r in range(6):
        assert np.array_equal(rng.sample_clients_np(r, 4, 2), ref_rng.sample_clients_np(r, 4, 2))

    _, cfg = _cfgs(tmp_path, "plain", enable_secagg=False, client_num_per_round=2)
    cfg = fedml_tpu_torch.init(cfg)
    runner = FedMLRunner(cfg, model=resnet.CifarResNet(1), device="cpu")
    hist = runner.run()
    assert [h["round"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["test_loss"]) for h in hist)
    assert sum(c.rounds_trained for c in runner.runner.clients) == 4
    assert runner.runner.server.aggregator.peak_buffered_updates == 2


@pytest.mark.parametrize("case", ["ldp", "cdp_without_stream", "partial_participation",
                                  "fedprox", "unported_flag", "grpc_backend", "lightsecagg",
                                  "client_role", "qsgd8_wire", "fhe"])
def test_refusals_match_the_reference(tmp_path, case):
    """(d) What the reference refuses the port refuses (LDP, CDP without
    the streaming fold, partial participation, a non-FedAvg optimizer, DP
    under LightSecAgg), and what this slice has not ported raises
    ``NotImplementedError``.  ``qsgd8_wire`` runs as the reference runs it:
    the quantize-then-mask ring under ``secagg_stream``, the codec ignored
    (the dense buffer-all wire) without it; neither takes the f32 fold."""
    from fedml_tpu.cross_silo.secagg_shamir import shamir_secagg_params as ref_params
    from fedml_tpu_torch.runner import FedMLRunner

    kw = {
        "ldp": dict(enable_dp=True, dp_solution_type="ldp"),
        "cdp_without_stream": dict(DP_KW, extra={"secagg_stream": False}),
        "partial_participation": dict(client_num_per_round=3),
        "fedprox": dict(federated_optimizer="FedProx"),
        "unported_flag": dict(extra={"client_journal_dir": str(tmp_path / "j")}),
        "grpc_backend": dict(backend="GRPC"),
        "lightsecagg": dict(DP_KW, extra={"secagg_method": "lightsecagg"}),
        "client_role": dict(role="client"),
        "qsgd8_wire": dict(extra={"comm_compression": "qsgd8"}),
        "fhe": dict(enable_fhe=True),
    }[case]
    ref_cfg, cfg = _cfgs(tmp_path, f"refuse_{case}", **kw)
    if case in ("ldp", "cdp_without_stream", "lightsecagg"):
        if case == "lightsecagg":  # ported; DP stays refused, as the reference refuses it
            from fedml_tpu.cross_silo.lightsecagg import secagg_params as ref_lsa_params

            ref_params = ref_lsa_params
        with pytest.raises(NotImplementedError, match="enable_dp"):
            ref_params(ref_cfg)
        with pytest.raises(NotImplementedError, match="enable_dp"):
            FedMLRunner(cfg, device="cpu")
    elif case == "qsgd8_wire":
        from fedml_tpu_torch.models import resnet

        for stream in (True, False):
            ref_cfg, cfg = _cfgs(tmp_path, f"qsgd8_wire_{stream}",
                                 extra={"comm_compression": "qsgd8", "secagg_stream": stream})
            runner = FedMLRunner(cfg, model=resnet.CifarResNet(1), device="cpu")
            runner.runner.setup()
            agg, ref_agg = runner.runner.server.aggregator, _ref_aggregator(ref_cfg)
            ring = (agg.ring.codec, agg.ring.bits, agg.ring.frac_bits, agg.ring.modulus)
            assert ring == (ref_agg.ring.codec, ref_agg.ring.bits, ref_agg.ring.frac_bits,
                            ref_agg.ring.modulus) == ("qsgd8", 11, 7, 2**11)
            assert agg.field_stream == ref_agg.field_stream == stream
            assert not agg.stream_mode and not ref_agg.stream_mode
            assert all(c.stream == stream and c.ring.codec == "qsgd8"
                       for c in runner.runner.clients)
    elif case == "partial_participation":
        with pytest.raises(ValueError, match="full participation"):
            FedMLRunner(cfg, device="cpu")
    else:
        with pytest.raises(NotImplementedError):
            FedMLRunner(cfg, device="cpu")
