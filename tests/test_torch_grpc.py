"""Port parity: the gRPC backend (``fedml_tpu_torch/comm/grpc_backend.py``)
and cross-silo over it, against ``fedml_tpu/comm/grpc_backend.py`` on the
CPU.  gRPC is checked here alone: the card's machine has no ``grpcio``
(``chip_smoke.py`` drives TCP, whose device work is the same).

Tolerances:

- one endpoint of each package against one of the other (the same generic
  method, ``/fedml_tpu.CommService/SendMessage``): the message delivered
  bitwise, unchunked and as chunk frames of 8 KiB reassembled by the other
  package's receive loop;
- a cross-silo run (the LR, 4 silos, 2 rounds, the reference's initial
  weights and permutations): local SGD is not bitwise between XLA and
  PyTorch, so the port's global is held to the reference's run over gRPC at
  ``RUN_TOL`` = 2e-6 (a spread of 1.2e-7, measured on the LR), the test
  accuracy to 1e-6; the port's run over gRPC (ephemeral ports, with and
  without chunk frames) against its INPROC run: bitwise.

The reference's endpoints take fixed ports; they come from a block that
bound free just before (``_free_port_block``), never a constant.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from .conftest import tiny_config

torch.set_num_threads(1)

RUN_TOL = 2e-6


def _grpc(pkg):
    if pkg == "ref":
        from fedml_tpu.comm.grpc_backend import GRPCCommManager
        from fedml_tpu.comm.message import Message
    else:
        from fedml_tpu_torch.comm.grpc_backend import GRPCCommManager
        from fedml_tpu_torch.comm.message import Message
    return GRPCCommManager, Message


def _free_block(n):
    from fedml_tpu_torch.cross_silo.async_soak import _free_port_block

    return _free_port_block(n)


@pytest.mark.parametrize("chunk", [0, 8192], ids=["whole", "chunked"])
@pytest.mark.parametrize("sender_pkg,receiver_pkg", [("port", "port"), ("port", "ref"),
                                                     ("ref", "port")])
def test_echo_pair(sender_pkg, receiver_pkg, chunk):
    """Endpoint 0 of one package sends a model message to endpoint 1 of
    another: delivered once, the tensor bitwise, chunk frames counted by a
    port receiver."""
    base = _free_block(2)
    Sender, SMessage = _grpc(sender_pkg)
    Receiver, _ = _grpc(receiver_pkg)
    a = Sender("127.0.0.1", base, 0, base_port=base, chunk_bytes=chunk)
    b = Receiver("127.0.0.1", base + 1, 1, base_port=base, chunk_bytes=chunk)
    got = []

    class Obs:
        def receive_message(self, t, m):
            got.append(m)

    b.add_observer(Obs())
    t = threading.Thread(target=b.handle_receive_message, daemon=True)
    t.start()
    w = np.arange(128 * 128, dtype=np.float32).reshape(128, 128)
    try:
        msg = SMessage(5, 0, 1)
        msg.add_params("model_params", {"w": w})
        msg.add_params("round_idx", 3)
        a.send_message(msg)
        deadline = time.monotonic() + 10.0
        while not got and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.1)
    finally:
        b.stop_receive_message()
        a.stop_receive_message()
        t.join(timeout=5.0)
    assert len(got) == 1 and got[0].get_type() == 5 and got[0].get("round_idx") == 3
    np.testing.assert_array_equal(got[0].get("model_params")["w"], w)
    if receiver_pkg == "port":
        assert b.chunk_frames == (-(-len(msg.encode()) // chunk) if chunk else 0)


def test_failed_send_is_a_transport_fault():
    """A send to a rank nobody listens on raises ``ConnectionError`` (an
    ``OSError``: the port's probes log it and its upload path retries),
    where the reference lets ``grpc.RpcError`` through."""
    import grpc

    base = _free_block(2)
    out = {}
    for pkg in ("port", "ref"):
        cls, Message = _grpc(pkg)
        a = cls("127.0.0.1", base, 0, base_port=base)
        try:
            a.send_message(Message(1, 0, 1))
        except Exception as e:  # noqa: BLE001 - the kind is the finding
            out[pkg] = e
        finally:
            a.stop_receive_message()
    assert isinstance(out["port"], ConnectionError)
    assert isinstance(out["ref"], grpc.RpcError)


def _cfgs(run_id, **extra):
    import fedml_tpu_torch.arguments as args

    ref = tiny_config(training_type="cross_silo", client_num_in_total=4, client_num_per_round=4,
                      comm_round=2, learning_rate=0.3, frequency_of_the_test=1, run_id=run_id,
                      role="server", extra=dict(extra))
    fields = {k: v for k, v in vars(ref).items() if k in args.Config.__dataclass_fields__}
    return ref, args.Config(**{**fields, "extra": dict(extra)})


def _port_group(cfg, backend, init):
    import fedml_tpu_torch
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.cross_silo import build_process_group, run_group
    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.models import model_hub

    from .test_torch_secagg import JaxPerms

    cfg = fedml_tpu_torch.init(cfg)
    ds = loader.load(cfg)
    model = model_hub.create(cfg, ds.class_num, input_shape=ds.train_x.shape[1:])
    server, clients = build_process_group(
        cfg, ds, model, "cpu", backend, perms=JaxPerms(cfg.random_seed),
        global_vars=weights.to_torch(weights.flax_to_torch(init)))
    hist = run_group(server, clients, timeout=60.0)
    glob = weights.torch_to_flax(weights.to_numpy(server.aggregator.global_vars))
    return hist, [np.asarray(x) for x in jax.tree_util.tree_leaves(glob)], server


def test_cross_silo_over_grpc_matches_the_reference():
    """The reference's ``test_cross_silo_over_grpc`` (4 silos here) and the
    port's group over gRPC on ports the system picks: the same history and
    the global within ``RUN_TOL``; the port's gRPC runs, whole and in chunk
    frames of 512 bytes, bitwise its INPROC run."""
    import fedml_tpu
    from fedml_tpu.cross_silo import build_client, build_server
    from fedml_tpu.data import loader
    from fedml_tpu.models import model_hub
    from fedml_tpu_torch.comm.grpc_backend import GRPCCommManager

    ref_cfg, _ = _cfgs("grpc_ref", grpc_base_port=_free_block(5))
    fedml_tpu.init(ref_cfg)
    ds = loader.load(ref_cfg)
    model = model_hub.create(ref_cfg, ds.class_num)
    clients = [build_client(ref_cfg, ds, model, rank=r, backend="GRPC") for r in range(1, 5)]
    for c in clients:
        c.run_in_thread()
    srv = build_server(ref_cfg, ds, model, backend="GRPC")
    init = jax.tree_util.tree_map(np.asarray, jax.device_get(srv.aggregator.global_vars))
    try:
        ref_hist = srv.run_until_done(timeout=60.0)
    finally:
        for c in clients:
            c.finish()
        srv.finish()
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(
        jax.device_get(srv.aggregator.global_vars))]
    runs = {}
    for tag, backend, extra in (("grpc", "GRPC", {"grpc_base_port": 0}),
                                ("grpc_chunked", "GRPC", {"grpc_base_port": 0,
                                                          "comm_chunk_bytes": 512}),
                                ("inproc", "INPROC", {})):
        _, cfg = _cfgs(f"grpc_port_{tag}", **extra)
        runs[tag] = _port_group(cfg, backend, init)
    hist, got, server = runs["grpc"]
    assert isinstance(server.com_manager, GRPCCommManager) and server.com_manager.listen_port
    assert runs["grpc_chunked"][2].com_manager.chunk_frames > 0
    assert [h["round"] for h in hist] == [h["round"] for h in ref_hist] == [0, 1]
    np.testing.assert_allclose([h["test_acc"] for h in hist],
                               [h["test_acc"] for h in ref_hist], atol=1e-6)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=RUN_TOL)
    assert max(float(np.abs(b - s).max())
               for b, s in zip(want, jax.tree_util.tree_leaves(init))) > 1e-2
    for tag in ("grpc_chunked", "inproc"):
        assert all(np.array_equal(a, b) for a, b in zip(got, runs[tag][1])), tag


def test_lone_server_takes_the_configured_backend():
    """``role: server`` over GRPC builds the server alone over GRPC (the
    reference's ``run``), also with ``tcp_base_port: 0``, which makes the
    in-process group over TCP alone; a lone server with ``grpc_base_port:
    0`` is refused, as over TCP."""
    from fedml_tpu_torch.comm.grpc_backend import GRPCCommManager
    from fedml_tpu_torch.runner import FedMLRunner

    _, cfg = _cfgs("grpc_lone", grpc_base_port=_free_block(5), tcp_base_port=0)
    cfg.backend = "GRPC"
    runner = FedMLRunner(cfg, device="cpu")
    runner.runner.setup()
    try:
        assert runner.runner.clients == []
        assert isinstance(runner.runner.server.com_manager, GRPCCommManager)
        assert runner.runner.server.com_manager.listen_port == cfg.extra["grpc_base_port"]
    finally:
        runner.runner.server.finish()
    _, cfg = _cfgs("grpc_lone_zero", grpc_base_port=0)
    cfg.backend = "GRPC"
    with pytest.raises(ValueError, match="grpc_base_port 0"):
        FedMLRunner(cfg, device="cpu")
