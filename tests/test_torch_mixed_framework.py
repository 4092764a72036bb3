"""Mixed-framework cross-silo runs: the port's silos against the reference's
server, and the reference's silos against the port's server, on the
``cross_silo_horizontal_lr`` recipe in f32 (4 silos, 3 rounds), over
loopback TCP and over one MQTT broker and HTTP store (each package's
``MiniMqttBroker`` / ``MiniObjectStoreServer`` in turn), with plain and
qsgd8 uploads, and with both journals on (the session epoch on the
dispatches, the upload keys on the uploads).  The port never imports JAX:
only this test holds both packages.

Tolerance: each mixed run's last global against the all-JAX run's.  The
port's silos take the reference's permutations and upload draws, and the
port's server the reference's initial global, so the runs differ only in
local SGD (XLA against PyTorch, not bitwise) and in the server's fold.
Measured on this recipe before the tolerance was set: 1.19e-7 (plain) and
7.45e-8 (qsgd8, no int8 level moved), one or two f32 ulps of the weights.
The globals are held to ``MIXED_TOL`` = 1e-6, the repo's tolerance for
uncompressed LR / MLP runs against the reference
(``tests/test_torch_stream_fold.py``), eight times the measured spread;
the test accuracy to 1e-6.
"""

import jax
import numpy as np
import pytest
import torch

from .test_torch_secagg import JaxPerms
from .test_torch_stream_fold import JaxUploadNoise

torch.set_num_threads(1)

RECIPE = "examples/cross_silo_horizontal_lr/fedml_config.yaml"
ROUNDS = 3
MIXED_TOL = 1e-6
QSGD8 = {"comm_compression": "qsgd8", "comm_compress_min_size": 256}
_BASELINES: dict = {}


def _cfgs(run_id, backend, extra):
    import os

    import fedml_tpu
    import fedml_tpu_torch

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), RECIPE)
    out = []
    for top in (fedml_tpu, fedml_tpu_torch):
        cfg = top.init(argv=["--cf", path])
        cfg.comm_round, cfg.compute_dtype, cfg.frequency_of_the_test = ROUNDS, "float32", 1
        cfg.run_id, cfg.backend, cfg.role = run_id, backend, "server"
        cfg.extra = dict(cfg.extra or {}, **extra)
        out.append(cfg)
    return out


def _parts(pkg, cfg):
    if pkg == "ref":
        from fedml_tpu.data import loader
        from fedml_tpu.models import model_hub

        ds = loader.load(cfg)
        return ds, model_hub.create(cfg, ds.class_num)
    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.models import model_hub

    ds = loader.load(cfg)
    return ds, model_hub.create(cfg, ds.class_num, input_shape=ds.train_x.shape[1:])


def _run(server_pkg, client_pkg, backend, extra, tag):
    """One run: ``(history, global leaves, initial global leaves, server)``."""
    from fedml_tpu.comm.inproc import InProcRouter as RefRouter
    from fedml_tpu.cross_silo import build_aggregator
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.comm.comm_manager import reset_in_memory_fabric

    ref_cfg, cfg = _cfgs(f"mixed_{tag}", backend, extra)
    ref_parts, port_parts = _parts("ref", ref_cfg), _parts("port", cfg)
    init = jax.tree_util.tree_map(np.asarray, jax.device_get(
        build_aggregator(ref_cfg, *ref_parts).global_vars))
    RefRouter.reset(cfg.run_id)
    reset_in_memory_fabric(cfg.run_id)
    clients = []
    for r in range(1, 5):
        if client_pkg == "ref":
            from fedml_tpu.cross_silo import build_client

            c = build_client(ref_cfg, *ref_parts, rank=r, backend=backend)
        else:
            from fedml_tpu_torch.cross_silo import build_client

            c = build_client(cfg, *port_parts, r, "cpu", backend=backend,
                             perms=JaxPerms(cfg.random_seed))
            c.upload_noise = JaxUploadNoise(cfg.random_seed)
        clients.append(c)
    if server_pkg == "ref":
        from fedml_tpu.cross_silo import build_server

        srv = build_server(ref_cfg, *ref_parts, backend=backend)
    else:
        from fedml_tpu_torch.cross_silo import build_server

        srv = build_server(cfg, *port_parts, "cpu", backend=backend,
                           global_vars=weights.to_torch(weights.flax_to_torch(init)))
    for c in clients:
        c.run_in_thread()
    try:
        hist = srv.run_until_done(timeout=120.0)
    finally:
        for c in clients:
            c.finish()
        srv.finish()
    if server_pkg == "ref":
        glob = jax.device_get(srv.aggregator.global_vars)
    else:
        glob = weights.torch_to_flax(weights.to_numpy(srv.aggregator.global_vars))
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(glob)]
    return hist, leaves, [np.asarray(x) for x in jax.tree_util.tree_leaves(init)], srv, clients


def _baseline(codec):
    """The all-JAX run of ``codec`` (INPROC), once per module."""
    if codec not in _BASELINES:
        extra = QSGD8 if codec == "qsgd8" else {}
        _BASELINES[codec] = _run("ref", "ref", "INPROC", extra, f"baseline_{codec}")[:3]
    return _BASELINES[codec]


def _transport(transport, broker_pkg, monkeypatch):
    """``(backend, extra, stop)`` of a transport; MQTT over ``broker_pkg``'s
    broker and store, payloads over 512 bytes through the store."""
    from fedml_tpu_torch.cross_silo.async_soak import _free_port_block

    if transport == "tcp":
        return "TCP", {"tcp_base_port": _free_port_block(5)}, lambda: None
    if broker_pkg == "ref":
        from fedml_tpu.comm.mqtt_wire import MiniMqttBroker
        from fedml_tpu.comm.object_store_http import MiniObjectStoreServer
    else:
        from fedml_tpu_torch.comm.mqtt_wire import MiniMqttBroker
        from fedml_tpu_torch.comm.object_store_http import MiniObjectStoreServer
    from fedml_tpu.comm import mqtt_s3 as ref_mqtt
    from fedml_tpu_torch.comm import mqtt_s3

    for mod in (ref_mqtt, mqtt_s3):
        monkeypatch.setattr(mod, "PAYLOAD_INLINE_LIMIT", 512)
    broker, store = MiniMqttBroker(), MiniObjectStoreServer()
    broker.start()
    store.start()

    def stop():
        broker.stop()
        store.stop()

    stop.store = store
    return "MQTT_S3", {"mqtt_host": "127.0.0.1", "mqtt_port": broker.port,
                       "object_store_url": store.url}, stop


def _close_brokers(srv, clients):
    for party in (srv, *clients):
        disconnect = getattr(getattr(party.com_manager, "broker", None), "disconnect", None)
        if disconnect is not None:
            disconnect()


@pytest.mark.parametrize("codec", ["plain", "qsgd8"])
@pytest.mark.parametrize("transport", ["tcp", "mqtt"])
@pytest.mark.parametrize("server_pkg", ["ref", "port"], ids=["jax_server", "port_server"])
def test_mixed_run_matches_the_all_jax_run(monkeypatch, server_pkg, transport, codec):
    """Silos of one package against the other package's server: every round
    closes on all four silos, and the history and last global are the
    all-JAX run's (module docstring's tolerance)."""
    client_pkg = "port" if server_pkg == "ref" else "ref"
    want_hist, want, init = _baseline(codec)
    backend, extra, stop = _transport(transport, client_pkg, monkeypatch)
    if codec == "qsgd8":
        extra.update(QSGD8)
    try:
        hist, got, start, srv, clients = _run(server_pkg, client_pkg, backend, extra,
                                              f"{server_pkg}_{transport}_{codec}")
        _close_brokers(srv, clients)
    finally:
        stop()
    assert all(np.array_equal(a, b) for a, b in zip(start, init))
    assert [h["round"] for h in hist] == [h["round"] for h in want_hist] == list(range(ROUNDS))
    np.testing.assert_allclose([h["test_acc"] for h in hist],
                               [h["test_acc"] for h in want_hist], atol=1e-6)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=0, atol=MIXED_TOL)
    assert max(float(np.abs(b - s).max()) for b, s in zip(want, init)) > 1e-2
    assert all(c.rounds_trained == ROUNDS for c in clients)
    if transport == "mqtt":
        assert stop.store._blobs  # the model payloads rode the store
    if codec == "qsgd8":
        assert srv.aggregator.stream_mode


@pytest.mark.parametrize("server_pkg", ["ref", "port"], ids=["jax_server", "port_server"])
def test_mixed_run_with_both_journals(tmp_path, server_pkg):
    """Over TCP with the server's and the silos' journals: the server stamps
    its session epoch on every dispatch and the silos echo it, with an
    upload key on every upload; the server takes each key once and rejects
    none as stale; the global is the all-JAX run's."""
    from fedml_tpu_torch.cross_silo.async_soak import _free_port_block

    client_pkg = "port" if server_pkg == "ref" else "ref"
    want_hist, want, _ = _baseline("plain")
    extra = {"tcp_base_port": _free_port_block(5), "server_journal_dir": str(tmp_path / "s"),
             "client_journal_dir": str(tmp_path / "c")}
    hist, got, _, srv, clients = _run(server_pkg, client_pkg, "TCP", extra,
                                      f"{server_pkg}_journals")
    assert srv.session_epoch == 0 and srv.rejected_stale == 0 and srv.deduped_uploads == 0
    keys = sorted(k for dq in srv._folded_keys.values() for k in dq)
    assert keys == sorted(f"{r}:{i}:0:0" for r in range(1, 5) for i in range(ROUNDS))
    assert [h["round"] for h in hist] == list(range(ROUNDS))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=MIXED_TOL)
    np.testing.assert_allclose([h["test_acc"] for h in hist],
                               [h["test_acc"] for h in want_hist], atol=1e-6)
