"""Port parity: LightSecAgg (``fedml_tpu_torch/trust/secagg/lightsecagg.py``,
``fedml_tpu_torch/cross_silo/lightsecagg.py``) against
``fedml_tpu/trust/secagg/lightsecagg.py`` and
``fedml_tpu/cross_silo/lightsecagg.py``.

Exact: the Lagrange coefficients, the masks, the encode, the aggregate and
the decode for the same seed (both packages run the same numpy int64
math), and the masked-upload frame for the same model and mask.  The whole
4-silo run on a logistic regression through ``FedMLRunner`` against the
reference's ``run_lightsecagg_process_group``, from the reference's initial
global with its permutations, is held as ``tests/test_torch_secagg.py``
holds its runs: every leaf within 5e-2 of its own update's scale, the flat
update within 1e-2 (relative L2).  The straggler round is exact: a silo
that sends its mask shares and drops out, the round decoded from the three
survivors after the timeout, and the global is bitwise the uniform mean of
the survivors' field-quantized models.
"""

import jax
import numpy as np
import pytest
import torch

from .test_torch_secagg import JaxPerms

torch.set_num_threads(1)

P = 2**31 - 1


def _cfgs(tmp_path, run_id, extra=None, **kw):
    """(reference Config, port Config) of a 4-silo LightSecAgg run on the
    ``synthetic`` features with a logistic regression."""
    import fedml_tpu.arguments as ref_args
    import fedml_tpu_torch.arguments as args

    base = dict(dataset="synthetic", model="lr", client_num_in_total=4, client_num_per_round=4,
                comm_round=2, epochs=1, batch_size=16, learning_rate=0.1,
                synthetic_train_size=320, synthetic_test_size=80, partition_method="homo",
                frequency_of_the_test=1, compute_dtype="float32", random_seed=0,
                training_type="cross_silo", role="server", backend="INPROC",
                enable_secagg=True, run_id=run_id, data_cache_dir=str(tmp_path))
    base.update(kw)
    return (ref_args.Config(**base, extra=dict(extra or {})),
            args.Config(**base, extra=dict(extra or {})))


@pytest.mark.parametrize("n,t,u", [(4, 2, 3), (5, 1, 4), (7, 3, 5)])
def test_protocol_bitwise_for_the_same_seed(n, t, u):
    """Masks, the encode, each survivor's aggregate and the one-shot decode
    equal the reference's; the decoded sum unmasks the survivors' sum."""
    from fedml_tpu.trust.secagg import field as ref_field
    from fedml_tpu.trust.secagg.lightsecagg import LightSecAggProtocol as RefLSA
    from fedml_tpu_torch.trust.secagg import field
    from fedml_tpu_torch.trust.secagg.lightsecagg import LightSecAggProtocol

    d = 1001
    pts, interp = np.arange(u + 1, u + n + 1), np.arange(1, u + 1)
    np.testing.assert_array_equal(field.gen_lagrange_coeffs(pts, interp),
                                  ref_field.gen_lagrange_coeffs(pts, interp))
    seeds = [2**200 + 17 * i for i in range(n)]
    ref = [RefLSA(n, t, u, seed=s) for s in seeds]
    port = [LightSecAggProtocol(n, t, u, seed=s) for s in seeds]
    assert port[0].pad_len(d) == ref[0].pad_len(d)
    masks = [p.gen_mask(d) for p in port]
    for a, b in zip(masks, (r.gen_mask(d) for r in ref)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    encoded = [p.encode_mask(m) for p, m in zip(port, masks)]
    for a, r, m in zip(encoded, ref, masks):
        np.testing.assert_array_equal(a, r.encode_mask(m))
    rs = np.random.RandomState(0)
    x = [rs.randint(0, P, size=d).astype(np.int64) for _ in range(n)]
    dp = port[0].pad_len(d)
    survivors = list(range(n))[: max(u, n - 1)]
    agg = {j: LightSecAggProtocol.aggregate_encoded_masks([encoded[i][j] for i in survivors])
           for j in survivors}
    for j in survivors:
        np.testing.assert_array_equal(
            agg[j], RefLSA.aggregate_encoded_masks([encoded[i][j] for i in survivors]))
    mask_sum = port[0].decode_aggregate_mask(agg, dp)
    np.testing.assert_array_equal(mask_sum, ref[0].decode_aggregate_mask(agg, dp))
    total = np.zeros(dp, np.int64)
    for i in survivors:
        total = (total + np.pad(x[i], (0, dp - d)) + masks[i]) % P
    want = np.zeros(dp, np.int64)
    for i in survivors:
        want = (want + np.pad(x[i], (0, dp - d))) % P
    np.testing.assert_array_equal((total - mask_sum) % P, want)
    with pytest.raises(ValueError, match="aggregate masks"):
        port[0].decode_aggregate_mask({j: agg[j] for j in survivors[: u - 1]}, dp)


def test_masked_upload_frame_byte_identical():
    """The masked-model upload of the same flat model and mask encodes to
    the reference's frame (the reference client's composition, written out
    as its ``_train_masked`` writes it)."""
    from fedml_tpu.comm.message import Message as RefMessage
    from fedml_tpu.cross_silo import lightsecagg as ref_lsa
    from fedml_tpu.cross_silo import message_define as ref_md
    from fedml_tpu.trust.secagg.field import quantize_to_field as ref_quantize
    from fedml_tpu.trust.secagg.lightsecagg import LightSecAggProtocol as RefLSA
    from fedml_tpu.trust.secagg.stream import DENSE_RING_BITS, pack_ring as ref_pack
    from fedml_tpu_torch.comm.message import Message
    from fedml_tpu_torch.cross_silo import lightsecagg as lsa
    from fedml_tpu_torch.trust.secagg.lightsecagg import LightSecAggProtocol

    flat = np.random.RandomState(1).randn(610).astype(np.float32)
    mask = LightSecAggProtocol(4, 2, 3, seed=99).gen_mask(flat.size)
    ref_proto = RefLSA(4, 2, 3, seed=99)
    assert np.array_equal(mask, ref_proto.gen_mask(flat.size))

    field_vec = ref_quantize(np.asarray(flat), bits=16)
    padded = np.zeros(ref_proto.pad_len(flat.size), dtype=np.int64)
    padded[: flat.size] = field_vec
    masked = (padded + mask) % ref_proto.p
    ref = RefMessage(ref_md.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER, 3, 0)
    ref.add_params(ref_md.MSG_ARG_KEY_MODEL_PARAMS, ref_pack(masked, DENSE_RING_BITS))
    ref.add_params(ref_lsa.MSG_ARG_KEY_MASKED_RING,
                   {"ring_bits": DENSE_RING_BITS, "length": int(masked.size)})
    ref.add_params(ref_md.MSG_ARG_KEY_NUM_SAMPLES, 80.0)
    ref.add_params(ref_md.MSG_ARG_KEY_ROUND_INDEX, 1)

    payload, meta, got_field = lsa.masked_upload(flat, mask, P, 16)
    assert np.array_equal(got_field, field_vec)
    frame = lsa.masked_model_message(3, payload, meta, 80.0, 1).encode()
    assert frame == ref.encode()
    back = Message.decode(frame)
    assert back.get_control(lsa.MSG_ARG_KEY_MASKED_RING) == meta
    for name in ("MSG_TYPE_C2S_SEND_ENCODED_MASK", "MSG_TYPE_S2C_ENCODED_MASK",
                 "MSG_TYPE_S2C_ACTIVE_CLIENTS", "MSG_TYPE_C2S_SEND_AGG_MASK",
                 "MSG_ARG_KEY_ENCODED_MASK", "MSG_ARG_KEY_AGG_ENCODED_MASK",
                 "MSG_ARG_KEY_MASK_SOURCE", "MSG_ARG_KEY_ACTIVE_CLIENTS"):
        assert getattr(lsa, name) == getattr(ref_lsa, name), name


def _ref_init(ref_cfg, ref_model, x):
    """The reference server's initial global (deterministic from the seed)."""
    from fedml_tpu.cross_silo.lightsecagg import LSAAggregator

    test = (np.zeros((32, 60), np.float32), np.zeros(32, np.int32), 32)
    return jax.tree_util.tree_map(np.asarray, LSAAggregator(ref_cfg, ref_model, x, test).global_vars)


@pytest.mark.parametrize("stream", [False, True])
def test_run_matches_the_reference(tmp_path, stream):
    """Two rounds of 4 silos: the reference's ``run_lightsecagg_process_group``
    and the port through ``FedMLRunner(cfg, device="cpu")`` with the
    reference's initial global and permutations and set mask seeds; with
    the buffer-all server and with ``extra.secagg_stream``."""
    import fedml_tpu
    import fedml_tpu_torch
    from fedml_tpu.cross_silo.lightsecagg import run_lightsecagg_process_group as ref_run
    from fedml_tpu.data import loader as ref_loader
    from fedml_tpu.models import simple as flax_simple
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.cross_silo.lightsecagg import LSAAggregator
    from fedml_tpu_torch.runner import FedMLRunner

    extra = {"secagg_stream": True} if stream else {}
    ref_cfg, cfg = _cfgs(tmp_path, f"lsa_run_{stream}", extra=extra)
    fedml_tpu.init(ref_cfg)
    ref_ds = ref_loader.load(ref_cfg)
    ref_model = flax_simple.LogisticRegression(10)
    init = _ref_init(ref_cfg, ref_model, ref_ds.train_x[:16])
    ref_hist, ref_srv = ref_run(ref_cfg, ref_ds, ref_model, timeout=120.0)

    cfg = fedml_tpu_torch.init(cfg)
    runner = FedMLRunner(cfg, device="cpu")
    group = runner.runner
    group.global_vars = weights.to_torch(weights.flax_to_torch(init))
    group.perms = JaxPerms(cfg.random_seed)
    group.mask_seeds = {r: 1000 + r for r in range(1, 5)}
    hist = runner.run()
    agg = group.server.aggregator
    assert isinstance(agg, LSAAggregator) and agg.field_stream == stream
    assert agg.peak_buffered_updates == (2 if stream else 4)
    assert [h["round"] for h in hist] == [0, 1] and len(ref_hist) == 2
    assert all(c.rounds_trained == 2 for c in group.clients)
    for h, rh in zip(hist, ref_hist):
        assert h["upload_bytes"] > 4 * 4 * agg.d_pad  # four u32 masked uploads
        assert h["finalize_time_s"] > 0
        np.testing.assert_allclose(h["test_acc"], rh["test_acc"], atol=1e-2)

    got = jax.tree_util.tree_leaves(weights.torch_to_flax(weights.to_numpy(agg.global_vars)))
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


def test_straggler_round_decodes_from_the_survivors_bitwise(tmp_path):
    """Silo 4 sends its mask shares and never uploads; after the straggler
    timeout the server proceeds with the 3 survivors (>= U = 3) and decodes
    their masks from their aggregates: the global is bitwise the uniform
    mean of the survivors' field-quantized models."""
    import fedml_tpu_torch
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.cross_silo import run_group
    from fedml_tpu_torch.cross_silo.lightsecagg import build_lightsecagg_process_group
    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.models import model_hub
    from fedml_tpu_torch.trust.secagg.field import dequantize_from_field

    _, cfg = _cfgs(tmp_path, "lsa_drop", comm_round=1,
                   extra={"straggler_timeout_s": 0.5, "straggler_quorum_frac": 0.5})
    cfg = fedml_tpu_torch.init(cfg)
    ds = loader.load(cfg)
    model = model_hub.create(cfg, ds.class_num, input_shape=ds.train_x.shape[1:])
    server, clients = build_lightsecagg_process_group(cfg, ds, model, "cpu",
                                                      drop_ranks=frozenset({4}))
    hist = run_group(server, clients, timeout=60.0)
    agg = server.aggregator
    assert len(hist) == 1 and server.active_first == [1, 2, 3]
    assert agg.protocol.u == 3 and clients[3].last_field_vec is None
    total = np.zeros(agg.model_dim, np.int64)
    for c in clients[:3]:
        total = (total + c.last_field_vec) % P
    mean = dequantize_from_field(total, 3, bits=agg.q_bits) / 3
    got = weights.flatten_reference(agg.global_vars)[0].numpy()
    assert np.array_equal(got, mean.astype(np.float32))


def test_refusals_match_the_reference(tmp_path):
    """What the reference's ``secagg_params`` refuses the port refuses with
    the same exception, before any data loads; partial participation is a
    ``ValueError`` in both."""
    from fedml_tpu.cross_silo.lightsecagg import secagg_params as ref_params
    from fedml_tpu_torch.cross_silo.lightsecagg import secagg_params
    from fedml_tpu_torch.runner import FedMLRunner

    for kw, exc in ((dict(extra={"secagg_privacy_t": 3, "secagg_target_u": 3}), ValueError),
                    (dict(extra={"secagg_target_u": 5}), ValueError),
                    (dict(enable_dp=True, dp_solution_type="cdp"), NotImplementedError),
                    (dict(enable_attack=True), NotImplementedError),
                    (dict(federated_optimizer="FedOpt"), NotImplementedError)):
        ref_cfg, cfg = _cfgs(tmp_path, "lsa_refuse", **kw)
        with pytest.raises(exc):
            ref_params(ref_cfg)
        with pytest.raises(exc):
            secagg_params(cfg)
        with pytest.raises(exc):
            FedMLRunner(cfg, device="cpu")
    ref_cfg, cfg = _cfgs(tmp_path, "lsa_partial", client_num_per_round=3)
    assert secagg_params(cfg) == ref_params(ref_cfg) == (2, 3, 16)
    with pytest.raises(ValueError, match="full participation"):
        FedMLRunner(cfg, device="cpu")


def test_recipe_runs_through_the_runner(tmp_path):
    """``cross_silo_lightsecagg_lr`` through ``fedml_tpu_torch.init`` and
    ``FedMLRunner(cfg, device="cpu")``, shrunk (800 samples, 2 rounds): the
    recipe's defaults T = 2, U = 3 and its straggler timer."""
    import fedml_tpu_torch
    from fedml_tpu_torch.runner import FedMLRunner

    cfg = fedml_tpu_torch.init(argv=["--cf", "examples/cross_silo_lightsecagg_lr/fedml_config.yaml"])
    cfg.comm_round, cfg.synthetic_train_size, cfg.frequency_of_the_test = 2, 800, 1
    runner = FedMLRunner(cfg, device="cpu")
    hist = runner.run()
    agg = runner.runner.server.aggregator
    assert (agg.protocol.t, agg.protocol.u) == (2, 3)
    assert runner.runner.server.straggler_timeout == 10.0
    assert [h["round"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["test_loss"]) and h["test_acc"] > 0.5 for h in hist)
