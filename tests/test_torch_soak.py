"""Port parity: the soak harnesses (``fedml_tpu_torch/cross_silo/
async_soak.py``, ``soak_worker.py``, ``secagg_soak.py``) on the CPU, at
the sizes and with the assertions of the reference's own tests
(``tests/test_async_agg.py::test_soak_small``,
``test_journal_chaos.py::test_kill_recover_soak_invariants``,
``test_client_recovery.py::test_client_kill_soak_resumes_and_accounts`` and
``::test_multiproc_sigkill_soak``).

The timed soaks are driven by threads and processes racing, so no two runs
(of either package) fold in the same order: they are held to the
reference's accounting identities, not to its numbers.  The secure-stream
soak is numpy field math: its unmasked totals are the reference's integers,
bitwise.

The multi-process soak runs each worker as a process of its own started
with ``sys.executable`` (``python -m fedml_tpu_torch.cross_silo.soak_worker
... cpu``), every worker bounded by the soak's timeout and killed at its
end; each worker's report says it never imported ``jax`` or
``fedml_tpu``.  In tier-1 it runs small (LR, 3 silos, 30 versions, one
server and one silo SIGKILL, chaos on); the reference's full size (160
versions, two silo kills) is marked ``slow`` as the reference's is.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def test_soak_small():
    from fedml_tpu_torch.cross_silo.async_soak import run_soak

    res = run_soak(n_clients=200, concurrency=32, buffer_k=8, versions=3, drop_prob=0.1,
                   latency_mean_s=0.002, redispatch_timeout_s=0.5, seed=1, timeout_s=60.0,
                   device="cpu")
    assert res["versions"] == 3
    assert res["arrivals"] == 24
    assert res["versions_per_sec"] > 0
    assert res["peak_buffered_updates"] <= 2
    assert res["unaccounted_drops"] == 0
    assert res["fold_lag_p95_s"] is not None
    assert res["staleness_max"] >= 1  # concurrency >> K forces staleness
    assert sum(res["staleness_hist_counts"]) == res["arrivals"]


def test_percentile_from_counts_is_the_reference_rule():
    """The quantile of plain bucket counts is the reference registry's
    (the upper edge where the cumulative count reaches the quantile)."""
    from fedml_tpu.cross_silo.async_soak import _percentile_from_hist
    from fedml_tpu.obs.registry import MetricsRegistry
    from fedml_tpu_torch.cross_silo.async_server import FOLD_LAG_BUCKETS, BucketCounts
    from fedml_tpu_torch.cross_silo.async_soak import _percentile_from_counts

    ref = MetricsRegistry().histogram("lag", "fold lag")
    port = BucketCounts(FOLD_LAG_BUCKETS)
    assert _percentile_from_counts(port, 0.5) is None
    values = np.random.default_rng(3).lognormal(-6.0, 2.0, 500).tolist() + [1e-4, 0.0, 1e4]
    for v in values:
        ref.observe(v)
        port.observe(v)
    assert list(port.edges) == list(ref._snapshot()["buckets"])
    assert port.counts == ref._snapshot()["samples"][0]["counts"]
    for q in (0.0, 0.1, 0.5, 0.95, 0.999, 1.0):
        assert _percentile_from_counts(port, q) == _percentile_from_hist(ref, q)


def test_kill_recover_soak_invariants():
    from fedml_tpu_torch.cross_silo.async_soak import run_kill_recover_soak

    res = run_kill_recover_soak(n_clients=64, concurrency=16, buffer_k=8, versions=6,
                                drop_prob=0.05, latency_mean_s=0.002, redispatch_timeout_s=1.0,
                                seed=0, timeout_s=180.0, device="cpu")
    assert res["versions"] == 6
    assert res["monotone"], res
    assert 0 < res["recovered_version"] <= res["versions_at_kill"], res
    assert res["session_epoch"] == 1, res
    assert res["unaccounted"] == 0, res
    assert res["peak_buffered_updates"] <= 2, res
    assert res["chaos_silent_losses"] + res["fleet_drops_injected"] > 0, res


def test_client_kill_soak_resumes_and_accounts():
    from fedml_tpu_torch.cross_silo.async_soak import run_client_kill_soak

    res = run_client_kill_soak(n_clients=4, versions=4, buffer_k=2, concurrency=2,
                               kill_marks=((2, 1),), redispatch_timeout_s=1.0, seed=0,
                               timeout_s=180.0, device="cpu")
    assert res["versions"] == 4, res
    assert res["kills"] == 1, res
    assert res["resumed_from_journal"] == 1, res
    assert res["unaccounted"] == 0, res
    assert res["peak_buffered_updates"] <= 2, res
    assert res["clients_finished"] == 4, res


@pytest.mark.parametrize("codec", ["qsgd8", "dense"])
def test_secagg_stream_soak_integers_are_the_reference(monkeypatch, codec):
    """A cohort of 40 with clients dropped before and after upload: every
    round's unmasked total is the reference's, integer for integer, and
    equals the exact sum; the reports agree but for the times."""
    from fedml_tpu.cross_silo.secagg_soak import run_secagg_stream_soak as ref_soak
    from fedml_tpu.trust.secagg import stream as ref_stream
    from fedml_tpu_torch.cross_silo.secagg_soak import run_secagg_stream_soak
    from fedml_tpu_torch.trust.secagg import stream

    totals = {"ref": [], "port": []}
    for tag, mod in (("ref", ref_stream), ("port", stream)):
        fin = mod.StreamingMaskedSum.finalize

        def finalize(self, *a, _fin=fin, _out=totals[tag]):
            out = _fin(self, *a)
            _out.append(np.array(out))
            return out

        monkeypatch.setattr(mod.StreamingMaskedSum, "finalize", finalize)
    kw = dict(cohort=40, dim=300, rounds=2, neighbors=2, codec=codec,
              drop_before_frac=0.05, drop_after_frac=0.05, seed=4)
    got, want = run_secagg_stream_soak(**kw), ref_soak(**kw)
    assert len(totals["port"]) == len(totals["ref"]) == 2
    for a, b in zip(totals["port"], totals["ref"]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    timed = ("versions_per_sec_on", "versions_per_sec_off", "throughput_ratio")
    assert {k: v for k, v in got.items() if k not in timed} == \
        {k: v for k, v in want.items() if k not in timed}
    assert got["bitwise_identity"] and got["peak_buffered"] <= 2
    assert got["dropped_before"] == got["dropped_after"] == 2


def _assert_multiproc(res, versions, server_kills, client_kills):
    assert res["completed"], res
    assert res["versions"] == versions, res
    assert res["server_kills"] == server_kills, res
    assert res["client_kills"] == client_kills, res
    assert res["monotone"], res
    assert res["session_epoch"] >= 1, res
    assert res["unaccounted"] == 0, res
    assert res["resumed_from_journal"] + res["cold_rejoins"] == res["client_kills"], res
    assert res["chaos"] is not None and sum(res["chaos"]["injected"].values()) > 0, res
    reports = res["reports"]
    assert {r["role"] for r in reports} == {"server", "client"}
    for r in reports:
        assert r["device"] == "cpu" and not r["jax_loaded"] and not r["fedml_tpu_loaded"], r
        assert all(v == 0 for v in r["launches"].values()), r  # the CPU: plain versions


def test_multiproc_sigkill_soak_small():
    """Real processes and SIGKILLs, cut for tier-1: LR on 1,000 images a
    silo and 4 epochs (a version takes ~0.3 s, so the restarts, a few
    seconds each, land mid-run), 3 silos, 30 versions, the server killed at
    14 and silo 1 at 6, the default chaos on every worker."""
    from fedml_tpu_torch.cross_silo.async_soak import (DEFAULT_CHAOS_FLAGS,
                                                       run_multiproc_kill_soak)

    res = run_multiproc_kill_soak(n_clients=3, versions=30, kill_server_at=14,
                                  client_kills=((1, 6),), journal_every_rounds=2,
                                  chaos=dict(DEFAULT_CHAOS_FLAGS), timeout_s=150.0,
                                  device="cpu",
                                  cfg_overrides={"synthetic_train_size": 3000, "epochs": 4})
    _assert_multiproc(res, 30, 1, 1)
    assert res["clients_finished"] == 3, res


@pytest.mark.slow
def test_multiproc_sigkill_soak():
    """The reference's acceptance soak at its size: 160 versions, the server
    killed at 80, silos 1 and 2 at 20 and 45, chaos on every worker."""
    from fedml_tpu_torch.cross_silo.async_soak import (DEFAULT_CHAOS_FLAGS,
                                                       run_multiproc_kill_soak)

    res = run_multiproc_kill_soak(chaos=dict(DEFAULT_CHAOS_FLAGS), device="cpu",
                                  cfg_overrides={"synthetic_train_size": 3000, "epochs": 4})
    _assert_multiproc(res, 160, 1, 2)
