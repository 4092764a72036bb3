"""Port parity: FHE aggregation (``fedml_tpu_torch/trust/fhe/rlwe.py``,
``cross_silo/fhe.py``) against ``fedml_tpu/trust/fhe/rlwe.py`` and
``fedml_tpu/cross_silo/fhe.py`` on the CPU.

Tolerances:

- the RLWE scheme is host numpy in both packages: the secret key, the
  fixed-point codec, the negacyclic product, ciphertexts made from the same
  draws (the reference's cipher given a seeded ``RandomState`` in place of
  its OS entropy, the port's through its ``rng`` argument), the homomorphic
  sum, the scalar multiply and the aggregate's decryption: bitwise;
- the FHE group (INPROC, 4 clients, 2 rounds, the reference's initial
  weights and permutations handed in): each client's upload is its
  model / n rounded to the fixed-point grid (2^-16), so a local-SGD
  difference between XLA and PyTorch (~1e-7) can move one element's level
  by one step per client: the final globals are held to ``n * 2^-16``
  (plus ``RUN_TOL``) element by element, and the test accuracy to 0.05 of
  the plain run, as the reference's test holds its own.
"""

import jax
import numpy as np
import pytest
import torch

from .conftest import tiny_config
from .test_torch_secagg import JaxPerms

torch.set_num_threads(1)

RUN_TOL = 2e-6
N_RING = 256


def _ciphers(key_seed=42, draw_seed=None):
    """The reference's and the port's ciphers; with ``draw_seed`` both draw
    their encryption randomness from ``RandomState(draw_seed)``."""
    from fedml_tpu.trust.fhe.rlwe import RLWECipher as RefCipher, RLWEParams as RefParams
    from fedml_tpu_torch.trust.fhe.rlwe import RLWECipher, RLWEParams

    ref = RefCipher(RefParams(n=N_RING), key_seed=key_seed)
    port = RLWECipher(RLWEParams(n=N_RING), key_seed=key_seed,
                      rng=None if draw_seed is None else np.random.RandomState(draw_seed))
    if draw_seed is not None:
        ref._rng = np.random.RandomState(draw_seed)
    return ref, port


def _same_blocks(a, b):
    return len(a) == len(b) and all(x.dtype == y.dtype == np.int64 and np.array_equal(x, y)
                                    for x, y in zip(a, b))


def test_secret_key_codec_and_product_bitwise():
    from fedml_tpu.trust.fhe.rlwe import _poly_mul_negacyclic as ref_mul
    from fedml_tpu_torch.trust.fhe.rlwe import poly_mul_negacyclic

    for seed in (0, 42, 2**31 + 7):
        ref, port = _ciphers(key_seed=seed)
        assert [int(v) for v in port._s] == [int(v) for v in ref._s]
    rs = np.random.RandomState(0)
    x = rs.uniform(-3, 3, size=600)
    assert np.array_equal(port.encode(x).astype(np.int64), ref.encode(x).astype(np.int64))
    m = port.encode(x)
    assert np.array_equal(port.decode(m), ref.decode(m))
    a = rs.randint(0, 1 << 62, size=N_RING).astype(object) % port.params.q
    got, want = poly_mul_negacyclic(a, port._s, port.params.q), ref_mul(a, ref._s, ref.params.q)
    assert got.dtype == object and [int(v) for v in got] == [int(v) for v in want]


def test_ciphertexts_for_fed_draws_bitwise():
    """The same draws give the same ciphertext blocks, one polynomial and
    a vector of three; each decrypts to the encoded plaintext."""
    ref, port = _ciphers(draw_seed=11)
    x = np.random.RandomState(1).uniform(-2, 2, size=700)
    got, want = port.encrypt_vector(x), ref.encrypt_vector(x)
    assert len(got) == 3 and _same_blocks(got, want)
    ref2, port2 = _ciphers(draw_seed=12)
    m = port2.encode(x[:N_RING])
    assert np.array_equal(port2.encrypt_poly(m).to_int64(), ref2.encrypt_poly(m).to_int64())
    assert np.array_equal(port.decrypt_vector(got, len(x)), ref.decrypt_vector(want, len(x)))
    np.testing.assert_allclose(port.decrypt_vector(got, len(x)), x, atol=2 ** -16)


def test_homomorphic_sum_scale_and_aggregate_decryption_bitwise():
    from fedml_tpu.trust.fhe.rlwe import add_ciphertexts as ref_add, scale_ciphertext as ref_scale
    from fedml_tpu_torch.trust.fhe.rlwe import add_ciphertexts, scale_ciphertext

    rs = np.random.RandomState(3)
    vecs = [rs.uniform(-2, 2, size=500) for _ in range(5)]
    pairs = [_ciphers(draw_seed=100 + i) for i in range(5)]
    ref_blocks = [r.encrypt_vector(v) for (r, _), v in zip(pairs, vecs)]
    port_blocks = [p.encrypt_vector(v) for (_, p), v in zip(pairs, vecs)]
    q = pairs[0][1].params.q
    summed, ref_summed = add_ciphertexts(port_blocks, q), ref_add(ref_blocks, q)
    assert _same_blocks(summed, ref_summed)
    ref0, port0 = pairs[0]
    got, want = port0.decrypt_vector(summed, 500), ref0.decrypt_vector(ref_summed, 500)
    assert np.array_equal(got, want)
    np.testing.assert_allclose(got, np.sum(vecs, axis=0), atol=5 * 2 ** -16)
    assert _same_blocks(scale_ciphertext(summed, 3, q), ref_scale(ref_summed, 3, q))
    # another key cannot decrypt
    _, wrong = _ciphers(key_seed=43)
    assert np.mean(np.abs(wrong.decrypt_vector(summed, 500) - got)) > 100.0


def _pair(run_id, **kw):
    import fedml_tpu_torch.arguments as args

    base = dict(client_num_in_total=4, client_num_per_round=4, comm_round=2, epochs=1,
                batch_size=16, synthetic_train_size=256, synthetic_test_size=64,
                training_type="cross_silo", enable_fhe=True, frequency_of_the_test=1,
                run_id=run_id, role="server", backend="INPROC")
    base.update(kw)
    ref_cfg = tiny_config(**base)
    fields = {k: v for k, v in vars(ref_cfg).items() if k in args.Config.__dataclass_fields__}
    return ref_cfg, args.Config(**{**fields, "extra": dict(ref_cfg.extra)})


def _ref_fhe_run(ref_cfg):
    """The reference's FHE group: its history, initial and final globals."""
    import fedml_tpu
    from fedml_tpu.cross_silo.fhe import FHEAggregator, run_fhe_process_group
    from fedml_tpu.data import loader
    from fedml_tpu.models import model_hub

    fedml_tpu.init(ref_cfg)
    ds = loader.load(ref_cfg)
    model = model_hub.create(ref_cfg, ds.class_num)
    from fedml_tpu.cross_silo import build_aggregator

    init = jax.tree_util.tree_map(np.asarray, jax.device_get(
        build_aggregator(ref_cfg, ds, model).global_vars))
    hist, server = run_fhe_process_group(ref_cfg, ds, model, timeout=120.0)
    glob = jax.tree_util.tree_map(np.asarray, jax.device_get(server.aggregator.global_vars))
    assert isinstance(server.aggregator, FHEAggregator)
    return hist, init, glob


def _port_run(cfg, init):
    import fedml_tpu_torch
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.runner import FedMLRunner

    runner = FedMLRunner(fedml_tpu_torch.init(cfg), device="cpu")
    group = runner.runner
    group.global_vars = weights.to_torch(weights.flax_to_torch(init))
    group.perms = JaxPerms(cfg.random_seed)
    return runner.run(), group


def test_fhe_group_matches_the_reference_and_the_plain_run(monkeypatch):
    """The port's FHE group (through ``FedMLRunner``): every server payload
    an int64 ``(B, 2, N)`` stack, the final global within the fixed-point
    bound of the reference's, the decrypted mean of each round within
    ``n * 2^-16`` of the plaintext mean of the same uploads, and test
    accuracy within 0.05 of the plain run."""
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.cross_silo.fhe import FHEAggregator, FHEClientManager

    ref_cfg, cfg = _pair("fhe_group")
    ref_hist, init, ref_glob = _ref_fhe_run(ref_cfg)
    seen, plain_means, fhe_means = [], [], []
    flats = {}
    send = FHEClientManager.send_message

    def spy_send(self, msg):
        if msg.get_type() == 3:
            flats[self.rank] = weights.flatten_reference(self._last_vars)[0].numpy()
        send(self, msg)

    train = FHEClientManager._train_and_send

    def spy_train(self, msg):
        orig = self.trainer.train

        def keep(*a, **k):
            out = orig(*a, **k)
            self._last_vars = out[0]
            return out

        self.trainer.train = keep
        train(self, msg)

    add = FHEAggregator.add_local_trained_result

    def spy_add(self, client_idx, blocks, sample_num, is_delta=False):
        seen.append(np.asarray(blocks))
        add(self, client_idx, blocks, sample_num, is_delta)

    agg = FHEAggregator.aggregate

    def spy_agg(self, round_idx):
        plain_means.append(np.mean([np.asarray(flats[r], np.float64) for r in sorted(flats)], 0))
        out = agg(self, round_idx)
        fhe_means.append(weights.flatten_reference(self.global_vars)[0].numpy())
        return out

    monkeypatch.setattr(FHEClientManager, "send_message", spy_send)
    monkeypatch.setattr(FHEClientManager, "_train_and_send", spy_train)
    monkeypatch.setattr(FHEAggregator, "add_local_trained_result", spy_add)
    monkeypatch.setattr(FHEAggregator, "aggregate", spy_agg)
    hist, group = _port_run(cfg, init)
    n = cfg.client_num_in_total
    assert len(hist) == len(ref_hist) == 2 and len(seen) == 2 * n
    for arr in seen:
        assert arr.dtype == np.int64 and arr.ndim == 3 and arr.shape[1:] == (2, 1024)
    step = 2.0 ** -16
    for got, want in zip(fhe_means, plain_means):
        assert np.max(np.abs(got - want)) <= n * step
    got = weights.torch_to_flax(weights.to_numpy(group.server.aggregator.global_vars))
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(ref_glob)):
        assert np.max(np.abs(a - b)) <= n * step + RUN_TOL
    monkeypatch.undo()
    _, plain_cfg = _pair("fhe_group_plain", enable_fhe=False,
                         extra={"streaming_aggregation": False})
    plain, _ = _port_run(plain_cfg, init)
    for h_fhe, h_plain in zip(hist, plain):
        assert abs(h_fhe["test_acc"] - h_plain["test_acc"]) < 0.05


FLAG_CASES = {
    "simulation": (dict(training_type="simulation"), NotImplementedError, "cross-silo"),
    "secagg": (dict(enable_secagg=True), NotImplementedError, "enable_secagg"),
    "dp": (dict(enable_dp=True, dp_solution_type="cdp"), NotImplementedError, "enable_dp"),
    "fedopt": (dict(federated_optimizer="FedOpt"), NotImplementedError, "plaintext updates"),
    "partial": (dict(client_num_per_round=2), ValueError, "full participation"),
    "server_journal": (dict(extra={"server_journal_dir": "/nonexistent/j"}),
                       NotImplementedError, "FHE server"),
    "client_journal": (dict(extra={"client_journal_dir": "/nonexistent/j"}),
                       NotImplementedError, "FHE client"),
}


@pytest.mark.parametrize("case", sorted(FLAG_CASES))
def test_fhe_flag_guards(case):
    """The reference's refusals (``test_fhe_flag_guards``, its
    ``check_fhe_compatible`` and full participation), and the journals the
    port does not serve under FHE, all before any data loads."""
    from fedml_tpu.cross_silo.fhe import check_fhe_compatible as ref_check
    from fedml_tpu_torch.runner import FedMLRunner

    kw, exc, match = FLAG_CASES[case]
    ref_cfg, cfg = _pair(f"fhe_guard_{case}", **kw)
    with pytest.raises(exc, match=match):
        FedMLRunner(cfg, device="cpu")
    if case in ("secagg", "dp", "fedopt"):
        with pytest.raises(NotImplementedError, match=match):
            ref_check(ref_cfg)
