"""Port parity: the buffered-async cross-silo server
(``fedml_tpu_torch/cross_silo/async_server.py``) and its hooks in
``cross_silo/server.py`` / ``__init__.py``, against
``fedml_tpu/cross_silo/async_server.py`` on the CPU, driven as the
reference's own tests drive it (``tests/test_async_agg.py``,
``test_journal_chaos.py``, ``test_client_recovery.py``).

- ``staleness_scale`` is the reference's Python float, bitwise, for every
  ``tau`` in 0..256 and three exponents.
- Both servers (LR, 6 clients, concurrency 4, K = 3, the reference's
  initial weights carried across) fed the same wire-encoded uploads in a
  fixed order: the same dispatch sequence, staleness, counters, staleness
  histogram and ``async_summary`` (its wall times aside), and after each
  virtual round the same global, bitwise (both fold in f32 in arrival order
  with the same f32 weights ``n * s(tau)``: the port on its device, the
  reference on the host).  With every upload fresh (``tau = 0``) the async
  global is bitwise the port's synchronous streaming fold.
- The watchdog re-issues an overdue slot to the same next client as the
  reference's; the epoch fence folds a journaled in-flight upload once and
  rejects the rest alike; the dedup table survives ``hard_kill`` alike.
- The reference's health ledger is not ported (the port journals
  ``health`` as ``{}`` and throttles no one): the two are compared where
  the reference's ledger keeps its default state.
- The async server runs in-process with real clients, over the in-process
  fabric and over loopback TCP, through ``FedMLRunner``.
"""

import jax
import numpy as np
import pytest
import torch

from .conftest import tiny_config

torch.set_num_threads(1)

_WALL = ("wall_s", "versions_per_sec")
# history keys only the port records (the reference's go to its registry)
_PORT_ONLY = ("fold_time_s", "finalize_time_s", "round_time_s", "aggregate_time_s",
              "upload_bytes")


def _pair(run_id, tmp_path=None, journal=False, **extra_kw):
    """The reference's and the port's async servers (INPROC, not started),
    the port's initial global the reference's; returns ``(ref, port, base,
    (port cfg, port dataset, port model))``, ``base`` the flax-layout
    initial global."""
    import fedml_tpu
    import fedml_tpu_torch
    import fedml_tpu_torch.arguments as args
    from fedml_tpu.comm.inproc import InProcRouter as RefRouter
    from fedml_tpu.cross_silo import build_server as ref_build
    from fedml_tpu.data import loader as ref_loader
    from fedml_tpu.models import model_hub as ref_hub
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.comm.inproc import InProcRouter
    from fedml_tpu_torch.cross_silo import build_server
    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.models import model_hub

    def cfg_pair(tag):
        extra = {"async_aggregation": True, "async_buffer_k": 3,
                 "async_staleness_exponent": 0.5, "async_concurrency": 4,
                 "async_redispatch_timeout_s": 0.0, **extra_kw}
        if journal:
            extra["server_journal_dir"] = str(tmp_path / tag / "j")
        ref_cfg = tiny_config(training_type="cross_silo", client_num_in_total=6,
                              client_num_per_round=4, comm_round=4, frequency_of_the_test=0,
                              run_id=f"{run_id}_{tag}", role="server", backend="INPROC")
        ref_cfg.extra = extra
        fields = {k: v for k, v in vars(ref_cfg).items() if k in args.Config.__dataclass_fields__}
        return ref_cfg, args.Config(**{**fields, "extra": dict(extra)})

    ref_cfg, _ = cfg_pair("ref")
    _, cfg = cfg_pair("port")
    fedml_tpu.init(ref_cfg)
    ds = ref_loader.load(ref_cfg)
    RefRouter.reset(ref_cfg.run_id)
    ref = ref_build(ref_cfg, ds, ref_hub.create(ref_cfg, ds.class_num), backend="INPROC")
    base = jax.tree_util.tree_map(np.asarray, jax.device_get(ref.aggregator.global_vars))
    cfg = fedml_tpu_torch.init(cfg)
    pds = loader.load(cfg)
    model = model_hub.create(cfg, pds.class_num, input_shape=pds.train_x.shape[1:])
    InProcRouter.reset(cfg.run_id)
    port = build_server(cfg, pds, model, "cpu", backend="INPROC",
                        global_vars=weights.to_torch(weights.flax_to_torch(base)))
    return ref, port, base, (cfg, pds, model)


def _upload(pkg, rank, params, version, n=16.0, key=None, epoch=None):
    """A model reply as the server reads it: encoded and decoded."""
    if pkg == "ref":
        from fedml_tpu.comm.message import Message
        from fedml_tpu.cross_silo import message_define as md
    else:
        from fedml_tpu_torch.comm.message import Message
        from fedml_tpu_torch.cross_silo import message_define as md
    m = Message(md.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER, rank, 0)
    m.add_params(md.MSG_ARG_KEY_MODEL_PARAMS, params)
    m.add_params(md.MSG_ARG_KEY_NUM_SAMPLES, float(n))
    m.add_params(md.MSG_ARG_KEY_ROUND_INDEX, int(version))
    if key is not None:
        m.add_params(md.MSG_ARG_KEY_UPLOAD_KEY, key)
    if epoch is not None:
        m.add_params(md.MSG_ARG_KEY_SESSION_EPOCH, int(epoch))
    return Message.decode(m.encode())


def _both(ref, port, rank, params, version, **kw):
    ref.handle_message_receive_model(_upload("ref", rank, params, version, **kw))
    port.handle_message_receive_model(_upload("port", rank, params, version, **kw))


def _perturbed(base, salt):
    return jax.tree_util.tree_map(
        lambda a: (a + np.float32(1e-3 * (salt + 1))).astype(a.dtype) if a.dtype.kind == "f"
        else a, base)


def _port_global(server):
    from fedml_tpu_torch import weights

    return weights.torch_to_flax(weights.to_numpy(server.aggregator.global_vars))


def _ref_global(server):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(server.aggregator.global_vars))


def _bitwise(got, want) -> bool:
    got_l, want_l = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    return len(got_l) == len(want_l) and all(
        a.shape == np.asarray(b).shape and np.array_equal(a, np.asarray(b))
        for a, b in zip(got_l, want_l))


def _tap_dispatch(server) -> list:
    """Record ``(client, server_version)`` of each dispatch."""
    sent = []
    inner = server._dispatch

    def tapped(cid):
        sent.append((int(cid), int(server.server_version)))
        inner(cid)

    server._dispatch = tapped
    return sent


def _summary(server) -> dict:
    out = server.async_summary()
    for k in _WALL:
        out.pop(k)
    return out


@pytest.mark.parametrize("exponent", [0.0, 0.5, 1.3])
def test_staleness_scale_bitwise(exponent):
    from fedml_tpu.cross_silo.async_server import staleness_scale as ref_scale
    from fedml_tpu_torch.cross_silo.async_server import staleness_scale

    for tau in range(0, 257):
        got, want = staleness_scale(tau, exponent), ref_scale(tau, exponent)
        assert type(got) is type(want) is float and got.hex() == want.hex(), (tau, exponent)
    assert staleness_scale(0, exponent) == 1.0


def test_fixed_arrival_order_matches_the_reference():
    """Uploads in a fixed order, stale ones among them (a client may come
    twice in one virtual round): the same dispatches, staleness, counters,
    histogram, summary and history, the same global after each virtual
    round, bitwise, and the finish at ``comm_round``."""
    from fedml_tpu.cross_silo.async_server import STALENESS
    from fedml_tpu.cross_silo.async_soak import _hist_counts

    ref, port, base, _ = _pair("async_order")
    sent = {"ref": _tap_dispatch(ref), "port": _tap_dispatch(port)}
    stal_base = _hist_counts(STALENESS)
    arrivals = [(1, 0), (3, 0), (2, 0), (4, 0), (5, 1), (1, 1), (6, 1), (2, 2), (3, 1),
                (4, 2), (5, 2), (1, 3)]
    try:
        for srv in (ref, port):
            srv.send_init_msg()
        assert sent["port"] == sent["ref"] == [(1, 0), (2, 0), (3, 0), (4, 0)]
        for i, (cid, ver) in enumerate(arrivals):
            _both(ref, port, cid, _perturbed(base, i), ver, n=16.0 + cid)
            assert port.server_version == ref.server_version
            assert port._round_staleness == ref._round_staleness
            if (i + 1) % 3 == 0:
                assert _bitwise(_port_global(port), _ref_global(ref)), f"after arrival {i}"
        assert sent["port"] == sent["ref"] and len(sent["port"]) > 4
        assert port.server_version == ref.server_version == 4
        assert port.done.is_set() and ref.done.is_set()
        assert _summary(port) == _summary(ref) and port.staleness_max >= 1
        assert (port._rr_cursor, sorted(port._outstanding)) == (ref._rr_cursor,
                                                                sorted(ref._outstanding))
        assert [{k: v for k, v in h.items() if k not in _PORT_ONLY}
                for h in port.history] == ref.history
        want_hist = [c - (stal_base[i] if i < len(stal_base) else 0)
                     for i, c in enumerate(_hist_counts(STALENESS))]
        assert port.staleness_hist.counts == want_hist
        assert list(port.staleness_hist.edges) == list(STALENESS.buckets)
        assert port.aggregator.peak_buffered_updates <= 2
        assert port.arrivals_by_path == {"folded": len(arrivals), "buffered": 0}
        # after the finish, an upload is ignored by both
        _both(ref, port, 6, base, 3)
        assert port.total_arrivals == ref.total_arrivals == len(arrivals)
    finally:
        ref.finish()
        port.finish()


def test_fresh_fold_bitwise_the_sync_streaming_fold():
    """``tau = 0`` everywhere: the async virtual round's global is bitwise
    the port's synchronous streaming fold of the same uploads, and the
    reference's async global."""
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.arguments import Config
    from fedml_tpu_torch.cross_silo import build_aggregator

    ref, port, base, (cfg, pds, model) = _pair("async_tau0")
    fields = {k: getattr(cfg, k) for k in Config.__dataclass_fields__}
    sync_cfg = Config(**{**fields, "extra": {"streaming_aggregation": True}})
    agg = build_aggregator(sync_cfg, pds, model, "cpu",
                           global_vars=weights.to_torch(weights.flax_to_torch(base)))
    assert agg.stream_mode and port.aggregator.stream_mode
    try:
        for srv in (ref, port):
            srv.send_init_msg()
        for i, cid in enumerate((2, 1, 3)):
            params = _perturbed(base, i)
            _both(ref, port, cid, params, 0, n=16.0 + cid)
            assert agg.ingest_streaming(cid, _upload("port", cid, params, 0, 16.0 + cid),
                                        16.0 + cid, False)
        agg.aggregate(0)
        assert port.server_version == 1 and port.history[0]["staleness_max"] == 0
        sync_global = weights.torch_to_flax(weights.to_numpy(agg.global_vars))
        assert _bitwise(_port_global(port), sync_global)
        assert _bitwise(_port_global(port), _ref_global(ref))
    finally:
        ref.finish()
        port.finish()


def test_watchdog_reissues_to_the_reference_next_client():
    """Client 4's dispatch goes unanswered past the timeout: both watchdogs
    re-issue its slot to the same next client, with the same counts."""
    import time

    ref, port, base, _ = _pair("async_watchdog", async_redispatch_timeout_s=1000.0)
    sent = {"ref": _tap_dispatch(ref), "port": _tap_dispatch(port)}
    try:
        for srv in (ref, port):
            srv._runtime.close()  # the test fires the watchdog itself
            srv.send_init_msg()
        for i, cid in enumerate((1, 2, 3)):
            _both(ref, port, cid, _perturbed(base, i), 0, n=16.0 + cid)
        for srv in (ref, port):
            ver, _t0 = srv._outstanding[4]
            srv._outstanding[4] = (ver, time.monotonic() - 2000.0)
            srv._on_watchdog()
        assert sent["port"] == sent["ref"]
        assert sent["port"][-1][0] != 4 and 4 not in port._outstanding
        assert port.timeout_redispatches == ref.timeout_redispatches == 1
        assert _summary(port) == _summary(ref)
    finally:
        ref.finish()
        port.finish()


def test_epoch_fence_folds_inflight_once_and_rejects_the_rest(tmp_path):
    """The reference's fence drill on both servers: a recovered server
    (epoch 1, clients 1 and 2 in flight at versions 0 and 1) folds client
    1's old-epoch upload once, rejects its redelivery, a mismatched version
    and a client never in flight, and leaves current-epoch uploads alone;
    the same counts and global, bitwise."""
    ref, port, base, _ = _pair("async_fence", tmp_path, journal=True, async_buffer_k=100)
    try:
        for srv in (ref, port):
            srv.session_epoch = 1
            srv._prev_epoch_inflight = {1: 0, 2: 1}
            srv.server_version = 2
        steps = [(1, 0, 0, (1, 0, {2: 1})), (1, 0, 0, (1, 1, {2: 1})),
                 (2, 0, 0, (1, 2, {2: 1})), (3, 1, 0, (1, 3, {2: 1})),
                 (4, 2, 1, (2, 3, {2: 1}))]
        for rank, version, epoch, want in steps:
            _both(ref, port, rank, _perturbed(base, rank), version, epoch=epoch)
            for srv in (ref, port):
                assert (srv.total_arrivals, srv.rejected_stale,
                        srv._prev_epoch_inflight) == want
        assert port._round_staleness == ref._round_staleness == [2, 0]
        assert _summary(port) == _summary(ref)
    finally:
        ref.finish()
        port.finish()


def test_dedup_and_its_table_survive_a_hard_kill(tmp_path):
    """Keyed uploads fold once per key (a new attempt is new work, key-less
    uploads take the old path); the journaled key table makes a duplicate
    of a pre-crash fold dedup at the recovered server, in both packages."""
    from fedml_tpu.cross_silo import build_server as ref_build
    from fedml_tpu_torch.cross_silo import build_server

    ref, port, base, (cfg, pds, model) = _pair("async_dedup", tmp_path, journal=True,
                                               async_buffer_k=2)
    feed = [(1, "1:0:-1:0", (1, 0)), (1, "1:0:-1:0", (1, 1)), (1, "1:0:-1:1", (2, 1))]
    for rank, key, want in feed:
        _both(ref, port, rank, base, 0, key=key)
        for srv in (ref, port):
            assert (srv.total_arrivals, srv.deduped_uploads) == want
    assert port.server_version == ref.server_version == 1
    for srv in (ref, port):
        srv.hard_kill()
    ref_ds = _ref_ds(ref.cfg)
    ref_b = ref_build(ref.cfg, ref_ds, _ref_model(ref.cfg, ref_ds), backend="INPROC")
    port_b = build_server(cfg, pds, model, "cpu", backend="INPROC")
    try:
        for srv in (ref_b, port_b):
            assert (srv.server_version, srv.session_epoch, srv.total_arrivals) == (1, 1, 2)
        _both(ref_b, port_b, 1, base, 0, key="1:0:-1:1", epoch=0)
        for srv in (ref_b, port_b):
            assert (srv.deduped_uploads, srv.total_arrivals, srv.rejected_stale) == (2, 2, 0)
        # key-less uploads (no client journal): folded each time, stale by 1
        _both(ref_b, port_b, 2, base, 0)
        _both(ref_b, port_b, 2, base, 0)
        for srv in (ref_b, port_b):
            assert (srv.deduped_uploads, srv.total_arrivals, srv.server_version) == (2, 4, 2)
        assert _summary(port_b) == _summary(ref_b)
        assert _bitwise(_port_global(port_b), _ref_global(ref_b))
    finally:
        ref_b.finish()
        port_b.finish()


def _ref_ds(ref_cfg):
    from fedml_tpu.data import loader

    return loader.load(ref_cfg)


def _ref_model(ref_cfg, ds):
    from fedml_tpu.models import model_hub

    return model_hub.create(ref_cfg, ds.class_num)


@pytest.mark.parametrize("backend", ["INPROC", "TCP"])
def test_async_group_runs_through_the_runner(backend):
    """The async server with 4 real clients in this process (qsgd8 uploads
    folded as they land), through ``FedMLRunner``: every virtual round
    closes on K arrivals, stale arrivals come, at most 2 updates buffered,
    finite metrics that learn; over TCP on ports the system picks too."""
    import fedml_tpu_torch
    from fedml_tpu_torch.arguments import Config
    from fedml_tpu_torch.runner import FedMLRunner

    cfg = Config(training_type="cross_silo", dataset="synthetic", model="lr",
                 client_num_in_total=4, client_num_per_round=4, comm_round=4, epochs=1,
                 batch_size=16, learning_rate=0.1, synthetic_train_size=640,
                 synthetic_test_size=160, partition_method="homo", frequency_of_the_test=1,
                 compute_dtype="float32", role="server", backend=backend,
                 run_id=f"async_group_{backend}",
                 extra={"async_aggregation": True, "async_buffer_k": 2,
                        "async_redispatch_timeout_s": 5.0, "comm_compression": "qsgd8",
                        "comm_compress_min_size": 64, "tcp_base_port": 0})
    runner = FedMLRunner(fedml_tpu_torch.init(cfg), device="cpu")
    hist = runner.run()
    server = runner.runner.server
    assert type(server).__name__ == "AsyncFedMLServerManager"
    assert [h["round"] for h in hist] == [0, 1, 2, 3]
    assert all(h["arrivals"] == 2 for h in hist)
    assert server.staleness_max >= 1 and server.aggregator.peak_buffered_updates <= 2
    assert all(np.isfinite(h["test_loss"]) for h in hist)
    assert hist[-1]["test_loss"] < hist[0]["test_loss"]
    assert all(c.done.is_set() for c in runner.runner.clients)
