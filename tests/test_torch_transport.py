"""Port parity: the transport layers (``fedml_tpu_torch/comm/``: transport
chunk frames, ``ChunkAssembler`` and the receive loop's decode retry and
sweep, chaos injection, the TCP backend, the backend factory) against
``fedml_tpu/comm/`` on the CPU, and whole runs of the plain cross-silo
server over the in-process fabric and TCP, with the trust pipeline, against
the reference's runs.

Tolerances:

- host layers: bitwise (chunk frame bytes, reassembled messages, the
  decode-retry schedule, chaos schedules and the frames they deliver, TCP
  frames);
- a TCP run against the same INPROC run of the port: bitwise (globals,
  history);
- a run against the reference's (the MLP of ``mlp_hidden`` 512, 4 clients,
  2 rounds, the reference's initial weights, permutations and trust draws
  handed in): local SGD is not bitwise between XLA and PyTorch, so the
  globals are held to ``RUN_TOL`` = 2e-6 (central DP's clip scales the
  ~7.5e-8 difference of the plain run, ``tests/test_torch_stream_fold.py``,
  by at most one, and its noise is the same draw in both), the attack and
  defense run to ``ATTACK_TOL`` = 1e-5 (the poisoned rows reach ~1e2).

Every TCP endpoint binds port 0; every join and receive has its own
timeout.
"""

import socket
import threading
import time

import jax
import numpy as np
import pytest
import torch

from .conftest import tiny_config
from .test_torch_secagg import JaxPerms
from .test_torch_stream_fold import _cfgs, _flax_global
from .test_torch_trust import JaxTrustSampler

torch.set_num_threads(1)

RUN_TOL = 2e-6
ATTACK_TOL = 1e-5


def _msg(pkg, msg_type=3, sender=2, receiver=0, n=3000, seed=0):
    """A model reply of both packages' Message classes: float, int and a
    qsgd8 compressed leaf."""
    if pkg == "ref":
        from fedml_tpu.comm import wire
        from fedml_tpu.comm.message import Message
    else:
        from fedml_tpu_torch.comm import wire
        from fedml_tpu_torch.comm.message import Message
    rs = np.random.RandomState(seed)
    m = Message(msg_type, sender, receiver)
    m.add_params("round_idx", 1)
    m.add_params("num_samples", 64.0)
    m.add_params("model_params", {
        "w": rs.randn(n).astype(np.float32), "count": np.arange(7, dtype=np.int32),
        "q": wire.CompressedLeaf("qsgd8", np.float32, (1500,), {"blocks": 2, "length": 1500},
                                 (rs.rand(2).astype(np.float32),
                                  rs.randint(-127, 128, 2048).astype(np.int8)))})
    return m


def _sent_params():
    """The reference's model params as a receiver decodes them."""
    from fedml_tpu.comm.message import Message

    return Message.decode(_msg("ref").encode()).get("model_params")


def _params_equal(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    return len(la) == len(lb) and all(
        np.asarray(x).dtype == np.asarray(y).dtype and np.array_equal(np.asarray(x), np.asarray(y))
        for x, y in zip(la, lb))


# -- chunk frames ---------------------------------------------------------------

@pytest.mark.parametrize("chunk", [1024, 4096, 10**6])
def test_chunk_frames_bitwise(chunk):
    from fedml_tpu.comm import wire as ref_wire
    from fedml_tpu_torch.comm import wire

    data = _msg("port").encode()
    assert data == _msg("ref").encode()
    got = list(wire.encode_chunk_frames(data, stream_id="2.7", sender=2, chunk_bytes=chunk))
    want = list(ref_wire.encode_chunk_frames(data, stream_id="2.7", sender=2, chunk_bytes=chunk))
    assert got == want and len(got) == max(1, -(-len(data) // chunk))
    assert wire.CHUNK_MAGIC == ref_wire.CHUNK_MAGIC
    for frame in got:
        assert wire.is_chunk_frame(frame) and not wire.is_chunk_frame(data)
        sub, payload = wire.parse_chunk_frame(frame)
        ref_sub, ref_payload = ref_wire.parse_chunk_frame(frame)
        assert sub == ref_sub and bytes(payload) == bytes(ref_payload)
    with pytest.raises(ValueError):
        wire.parse_chunk_frame(data)
    with pytest.raises(ValueError):
        wire.parse_chunk_frame(got[0][:10])


def test_chunk_assembler_interleaved_out_of_order_like_the_reference():
    """Three uploads of two senders, their frames interleaved and shuffled
    within each stream: the port's assembler yields the reference's
    messages, errors and senders at the same frames; its reassembled
    message keeps each leaf's segments for the device fold."""
    from fedml_tpu.comm.message import ChunkAssembler as RefAssembler
    from fedml_tpu_torch.comm import wire
    from fedml_tpu_torch.comm.message import ChunkAssembler

    rs = np.random.RandomState(3)
    streams = []
    for i, (sender, seed) in enumerate(((2, 0), (3, 1), (2, 2))):
        data = _msg("port", sender=sender, seed=seed).encode()
        frames = list(wire.encode_chunk_frames(data, stream_id=f"{sender}.{i}", sender=sender,
                                               chunk_bytes=1500))
        perm = rs.permutation(len(frames))
        streams.append([frames[j] for j in perm])
    order = []
    while any(streams):
        k = rs.randint(len(streams))
        if streams[k]:
            order.append(streams[k].pop(0))
    port, ref = ChunkAssembler(), RefAssembler()
    got_msgs, want_msgs = [], []
    for f in order:
        m, err, sender = port.feed(f)
        rm, rerr, rsender = ref.feed(f)
        assert (m is None, err, sender) == (rm is None, rerr, rsender)
        if m is not None:
            seg = m.tensor_segments()
            assert seg is not None
            header, it = seg
            assert [s for _, s, _ in it] == header["leaves"]
            got_msgs.append(m)
            want_msgs.append(rm)
    assert len(got_msgs) == 3 and port.pending_streams() == ref.pending_streams() == 0
    for m, rm in zip(got_msgs, want_msgs):
        assert m.wire_nbytes == rm.wire_nbytes
        assert m.get_control("round_idx") == rm.get_control("round_idx")
        assert _params_equal(m.get("model_params"), rm.get("model_params"))


def test_chunk_assembler_errors_and_sweep_like_the_reference():
    from fedml_tpu.comm.message import ChunkAssembler as RefAssembler
    from fedml_tpu_torch.comm import wire
    from fedml_tpu_torch.comm.message import ChunkAssembler

    data = _msg("port").encode()
    frames = list(wire.encode_chunk_frames(data, stream_id="2.0", sender=2, chunk_bytes=2000))
    broken = bytearray(frames[0])
    broken[-(len(frames[0]) - 60):] = b"\xff" * (len(frames[0]) - 60)  # control JSON garbage
    cases = {
        "corrupt": [frames[0][:12]],
        "decode": [bytes(broken)] + frames[1:],
        "cut_short": frames[:-1] + [frames[-1][:-5]],
        "trailing": frames[:-1] + [frames[-1] + b"\0\0"],
        "stale": frames[:2],
    }
    for name, feed in cases.items():
        port, ref = ChunkAssembler(stream_timeout_s=0.0), RefAssembler(stream_timeout_s=0.0)
        got = [(m is None, e, s) for m, e, s in (port.feed(f) for f in feed)]
        want = [(m is None, e, s) for m, e, s in (ref.feed(f) for f in feed)]
        assert got == want, name
        time.sleep(0.01)
        assert port.sweep() == ref.sweep(), name
    assert got[-1][1] is None  # the stale stream only waits, then the sweep takes it


def test_receive_loop_reassembles_drops_and_sweeps():
    """Over the in-process fabric with ``comm_chunk_bytes``: a chunked
    upload dispatches once, a corrupt frame is dropped as undecodable, an
    abandoned stream is swept after ``comm_chunk_idle_sweep_s`` and charged
    to its sender, and the event sinks hear both drops."""
    import fedml_tpu_torch.arguments as args
    from fedml_tpu_torch.comm import base as comm_base
    from fedml_tpu_torch.comm import wire
    from fedml_tpu_torch.comm.comm_manager import FedMLCommManager
    from fedml_tpu_torch.comm.inproc import InProcRouter

    run_id = "transport_loop"
    InProcRouter.reset(run_id)
    cfg = args.Config(run_id=run_id, extra={"comm_chunk_bytes": 2000,
                                           "comm_chunk_idle_sweep_s": 0.05})
    got = []

    class Mgr(FedMLCommManager):
        def register_message_receive_handlers(self):
            self.register_message_receive_handler(3, got.append)

    rx, tx = Mgr(cfg, rank=0, backend="INPROC"), Mgr(cfg, rank=2, backend="INPROC")
    assert rx.com_manager._chunk_sweep_s == 0.05
    events = []
    sink = comm_base.add_comm_event_sink(lambda event, **info: events.append((event, info)))
    try:
        t = rx.run_in_thread()
        tx.send_message(_msg("port"))
        tx.com_manager.send_raw(0, b"\x05\x00\x00\x00{bad")
        frames = list(wire.encode_chunk_frames(_msg("port").encode(), stream_id="9.0", sender=9,
                                               chunk_bytes=2000))
        tx.com_manager.send_raw(0, frames[0])
        deadline = time.monotonic() + 5.0
        loop = rx.com_manager
        while loop.dropped.get("chunk_stream_timeout", 0) == 0:
            assert time.monotonic() < deadline, "stale stream never swept"
            time.sleep(0.01)
        rx.finish()
        t.join(timeout=5.0)
        assert not t.is_alive()
    finally:
        comm_base.remove_comm_event_sink(sink)
        InProcRouter.reset(run_id)
    assert len(got) == 1 and _params_equal(got[0].get("model_params"), _sent_params())
    assert loop.dropped == {"undecodable": 1, "chunk_stream_timeout": 1}
    assert loop.received == 1 and loop.chunk_frames > 2
    assert ("dropped", {"reason": "undecodable"}) in events
    assert ("dropped", {"reason": "chunk_stream_timeout", "client": 9}) in events


def test_decode_retry_schedule_matches_the_reference(monkeypatch):
    """The deferred retry of a transiently undecodable payload: the port's
    schedule is the reference's, a payload that decodes at its third try
    dispatches once after two retries, one that never decodes is dropped
    after ``DECODE_RETRY_LIMIT`` retries; healthy messages keep flowing
    meanwhile."""
    from fedml_tpu.comm import base as ref_base
    from fedml_tpu_torch.comm import base
    from fedml_tpu_torch.comm.inproc import InProcCommManager, InProcRouter
    from fedml_tpu_torch.comm.message import Message

    assert (base.DECODE_RETRY_LIMIT, base.DECODE_RETRY_BACKOFF_S, base.DECODE_RETRY_CAP_S) == (
        ref_base.DECODE_RETRY_LIMIT, ref_base.DECODE_RETRY_BACKOFF_S, ref_base.DECODE_RETRY_CAP_S)
    for purpose in ("DECODE_RETRY", "RECONNECT", "STATUS_PROBE"):
        name = f"BACKOFF_PURPOSE_{purpose}"
        assert getattr(base, name) == getattr(ref_base, name)
    want = [ref_base.backoff_delay(a, purpose=ref_base.BACKOFF_PURPOSE_DECODE_RETRY)
            for a in range(6)]
    assert [base.decode_retry_delay(a) for a in range(6)] == want
    for a in range(6):
        assert base.backoff_delay(a, base=0.05, cap=2.0, seed=1_000_004, purpose=7) == \
            ref_base.backoff_delay(a, base=0.05, cap=2.0, seed=1_000_004, purpose=7)

    waits = []
    monkeypatch.setattr(base, "decode_retry_delay", lambda a: waits.append(a) or 0.01 * (a + 1))
    run_id = "transport_retry"
    InProcRouter.reset(run_id)
    ep = InProcCommManager(run_id, 0)
    calls = {"flaky": 0}
    decode = Message.decode

    def flaky(data):
        if data == b"flaky":
            calls["flaky"] += 1
            if calls["flaky"] < 3:
                raise ConnectionError("store briefly unreachable")
            return Message(5, 1, 0)
        if data == b"never":
            raise TimeoutError("store gone")
        return decode(data)

    monkeypatch.setattr(Message, "decode", staticmethod(flaky))
    got = []

    class Obs:
        def receive_message(self, t, m):
            got.append(t)

    ep.add_observer(Obs())
    for item in (b"flaky", b"never", Message(3, 1, 0).encode()):
        ep._inbox.put(item)
    t = threading.Thread(target=ep.handle_receive_message, daemon=True)
    t.start()
    deadline = time.monotonic() + 5.0
    while ep.dropped.get("retries_exhausted", 0) == 0 or 5 not in got:
        assert time.monotonic() < deadline
        time.sleep(0.01)
    ep.stop_receive_message()
    t.join(timeout=5.0)
    assert not t.is_alive()
    InProcRouter.reset(run_id)
    assert got[0] == 3 and sorted(got) == [3, 5]  # the healthy message went first
    assert calls["flaky"] == 3
    assert ep.decode_retries == 2 + base.DECODE_RETRY_LIMIT
    assert sorted(waits) == sorted([0, 1] + list(range(base.DECODE_RETRY_LIMIT)))


# -- chaos --------------------------------------------------------------------------

class _FakeComm:
    """An inner backend that records every delivery as bytes."""

    def __init__(self):
        self.sent, self.raw = [], []

    def send_message(self, msg):
        self.sent.append(msg.encode())

    def send_raw(self, rid, payload):
        self.raw.append((rid, bytes(payload)))

    def add_observer(self, obs):
        pass

    def handle_receive_message(self):
        pass

    def stop_receive_message(self):
        pass


def _chaos_pair(**kw):
    from fedml_tpu.comm.chaos import ChaosCommManager as RefChaos, ChaosConfig as RefConfig
    from fedml_tpu_torch.comm.chaos import ChaosCommManager, ChaosConfig

    a, b = _FakeComm(), _FakeComm()
    return (ChaosCommManager(a, ChaosConfig(**kw), rank=0), a,
            RefChaos(b, RefConfig(**kw), rank=0), b)


def _drive(mgr, pkg, n):
    out = []
    for i in range(n):
        m = _msg(pkg, msg_type=2 + i % 2, sender=0, receiver=1 + i % 3, n=64, seed=i)
        try:
            mgr.send_message(m)
        except ConnectionResetError:
            out.append(i)
    mgr.stop_receive_message()
    return out


@pytest.mark.parametrize("seed", [7, 8])
def test_chaos_schedule_and_deliveries_bitwise(seed):
    """The same seed over the same sends: the reference's schedule, resets,
    injection counts and delivered frames (duplicates, the reorder's
    order, the corrupt frames' truncated bytes), bitwise."""
    kw = dict(seed=seed, drop=0.15, duplicate=0.1, reorder=0.1, corrupt=0.1, reset=0.05)
    port, inner, ref, ref_inner = _chaos_pair(**kw)
    assert _drive(port, "port", 240) == _drive(ref, "ref", 240)
    assert port.schedule == ref.schedule and len(port.schedule) > 40
    assert port.injected == ref.injected
    assert set(port.injected) == {"drop", "duplicate", "reorder", "corrupt", "reset"}
    assert port.silent_losses() == ref.silent_losses()
    assert inner.sent == ref_inner.sent and inner.raw == ref_inner.raw
    assert port.sends == 240
    assert len(port.schedule_types) == len(port.schedule)


def test_chaos_nonces_hold_under_concurrent_senders():
    """Eight threads sending through one wrapper with a short switch
    interval: every send gets its own nonce per receiver (none lost or
    reused), and after the shutdown flush every frame is delivered once,
    plus once more per duplicate."""
    import sys

    from fedml_tpu_torch.comm.chaos import ChaosCommManager, ChaosConfig

    inner = _FakeComm()
    mgr = ChaosCommManager(inner, ChaosConfig(seed=1, duplicate=0.2, reorder=0.2), rank=0)
    msgs = [_msg("port", receiver=1 + i % 3, n=8, seed=i) for i in range(3)]
    per_thread, n_threads = 150, 8

    def send():
        for i in range(per_thread):
            mgr.send_message(msgs[i % 3])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=send) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    mgr.stop_receive_message()
    total = per_thread * n_threads
    assert mgr.sends == total and sum(mgr._nonce.values()) == total
    for rid in (1, 2, 3):
        nonces = [n for _, r, n in mgr.schedule if r == rid]
        assert len(nonces) == len(set(nonces)) and max(nonces) <= mgr._nonce[rid]
    assert len(inner.sent) == total + mgr.injected["duplicate"]


def test_chaos_delay_partition_and_gate():
    import fedml_tpu_torch.arguments as args
    from fedml_tpu.comm.chaos import chaos_from_config as ref_from_config
    from fedml_tpu_torch.comm.chaos import chaos_from_config, wrap_with_chaos

    port, inner, ref, ref_inner = _chaos_pair(seed=4, delay=0.5, delay_max_s=0.005)
    _drive(port, "port", 40)
    _drive(ref, "ref", 40)
    assert port.schedule == ref.schedule and port.injected["delay"] > 5
    deadline = time.monotonic() + 5.0
    while len(inner.sent) < 40 or len(ref_inner.sent) < 40:
        assert time.monotonic() < deadline
        time.sleep(0.01)
    assert sorted(inner.sent) == sorted(ref_inner.sent)
    # the partition window: open now, every send fails and the held frame is lost
    port, inner, ref, ref_inner = _chaos_pair(seed=0, reorder=1.0, partition=(0.0, 60.0))
    with pytest.raises(ConnectionResetError):
        port.send_message(_msg("port", receiver=1))
    with pytest.raises(ConnectionResetError):
        ref.send_message(_msg("ref", receiver=1))
    assert port.schedule == ref.schedule == [("partition", 1, 1)]
    closed, _, _, _ = _chaos_pair(seed=0, partition=(60.0, 60.0))
    closed.send_message(_msg("port", receiver=1))
    assert closed.inner.sent and closed.schedule == []
    # the gate: no flag, no wrapper
    fake = _FakeComm()
    cfg = args.Config()
    assert chaos_from_config(cfg) is None and wrap_with_chaos(fake, cfg, 0) is fake
    on = args.Config(extra={"chaos_drop_prob": 0.5, "chaos_partition": "1:2"})
    ref_on = tiny_config(extra={"chaos_drop_prob": 0.5, "chaos_partition": "1:2"})
    got, want = chaos_from_config(on), ref_from_config(ref_on)
    assert {k: getattr(got, k) for k in got.__slots__} == {k: getattr(want, k)
                                                          for k in want.__slots__}
    assert wrap_with_chaos(fake, on, 0).inner is fake
    with pytest.raises(ValueError, match="start_s:duration_s"):
        chaos_from_config(args.Config(extra={"chaos_partition": "soon"}))


# -- TCP ----------------------------------------------------------------------------

def test_tcp_frames_bitwise_and_chunked_delivery():
    """``send_frame`` / ``recv_frame`` over a socket pair carry the
    reference's bytes both ways; two endpoints on ephemeral ports deliver a
    chunked message whole."""
    from fedml_tpu.comm import tcp_backend as ref_tcp
    from fedml_tpu_torch.comm import tcp_backend as tcp
    from fedml_tpu_torch.comm.message import Message

    data = _msg("port").encode()
    a, b = socket.socketpair()
    try:
        a.settimeout(5.0)
        b.settimeout(5.0)
        tcp.send_frame(a, data)
        assert ref_tcp.recv_frame(b) == data
        ref_tcp.send_frame(b, data)
        assert tcp.recv_frame(a) == data
        a.sendall(tcp.FRAME_HEADER.pack(tcp.MAX_FRAME_BYTES + 1))
        with pytest.raises(ValueError):
            tcp.recv_frame(b)
    finally:
        a.close()
        b.close()
    assert tcp.FRAME_HEADER.format == ref_tcp.FRAME_HEADER.format
    assert tcp.MAX_FRAME_BYTES == ref_tcp.MAX_FRAME_BYTES

    rx = tcp.TCPCommManager("127.0.0.1", 0, 0, base_port=0)
    tx = tcp.TCPCommManager("127.0.0.1", 0, 2, base_port=0, chunk_bytes=1000)
    assert tcp.link_ports([rx, tx]) == {0: rx.listen_port, 2: tx.listen_port}
    got = []

    class Obs:
        def receive_message(self, t, m):
            got.append(m)

    rx.add_observer(Obs())
    t = threading.Thread(target=rx.handle_receive_message, daemon=True)
    t.start()
    try:
        tx.send_message(_msg("port"))
        tx.send_raw(0, Message(8, 2, 0).encode())
        deadline = time.monotonic() + 5.0
        while len(got) < 2:
            assert time.monotonic() < deadline
            time.sleep(0.01)
    finally:
        rx.stop_receive_message()
        tx.stop_receive_message()
        t.join(timeout=5.0)
    assert not t.is_alive()
    assert rx.chunk_frames == -(-len(data) // 1000)
    # two connections: either may land first
    by_type = {m.get_type(): m for m in got}
    assert sorted(by_type) == [3, 8]
    assert _params_equal(by_type[3].get("model_params"), _sent_params())


@pytest.mark.parametrize("backend,exc", [("GRPC", NotImplementedError),
                                         ("MQTT_S3", NotImplementedError),
                                         ("WEB3", NotImplementedError),
                                         ("THETASTORE", NotImplementedError),
                                         ("PIGEON", ValueError)])
def test_unported_backends_refused(tmp_path, backend, exc):
    from fedml_tpu_torch.runner import FedMLRunner

    _, cfg = _cfgs(f"backend_{backend}", {}, model="lr", comm_round=1)
    cfg.backend = backend
    with pytest.raises(exc):
        FedMLRunner(cfg, device="cpu")
    if exc is NotImplementedError:
        with pytest.raises(exc, match="not ported"):
            FedMLRunner(cfg, device="cpu")


def test_tcp_over_other_hosts_and_under_secagg_refused():
    from fedml_tpu_torch.runner import FedMLRunner

    # the in-process group (tcp_base_port 0) cannot reach silos on other
    # hosts; with fixed ports the silos run as processes of their own
    # (tests/test_torch_silo_process.py)
    _, cfg = _cfgs("tcp_remote", {"tcp_ip_config": {"1": "10.0.0.5"}, "tcp_base_port": 0},
                   model="lr")
    cfg.backend = "TCP"
    with pytest.raises(NotImplementedError, match="role 'client'"):
        FedMLRunner(cfg, device="cpu")
    # under SecAgg too (TCP itself runs under both secure protocols:
    # tests/test_torch_secure_roles.py)
    _, cfg = _cfgs("tcp_secagg", {"secagg_method": "shamir", "tcp_base_port": 0,
                                  "tcp_ip_config": {"1": "10.0.0.5"}},
                   model="lr", enable_secagg=True)
    cfg.backend = "TCP"
    with pytest.raises(NotImplementedError, match="role 'client'"):
        FedMLRunner(cfg, device="cpu")


# -- whole runs -------------------------------------------------------------------

def _port_run(cfg, trust_sampler=None, init=None, perms=None, tap=None):
    """The port's run; ``tap(group)`` sees the built server and clients
    before it starts."""
    import fedml_tpu_torch
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.runner import FedMLRunner

    runner = FedMLRunner(fedml_tpu_torch.init(cfg), device="cpu")
    group = runner.runner
    if init is not None:
        group.global_vars = weights.to_torch(weights.flax_to_torch(init))
    group.perms = perms
    group.trust_sampler = trust_sampler
    if tap is not None:
        group.setup()
        tap(group)
    hist = runner.run()
    return hist, group


def _ref_run(ref_cfg):
    import fedml_tpu
    from fedml_tpu.comm.inproc import InProcRouter
    from fedml_tpu.cross_silo import build_client, build_server
    from fedml_tpu.data import loader
    from fedml_tpu.models import model_hub

    fedml_tpu.init(ref_cfg)
    ds = loader.load(ref_cfg)
    model = model_hub.create(ref_cfg, ds.class_num)
    InProcRouter.reset(ref_cfg.run_id)
    clients = [build_client(ref_cfg, ds, model, rank=r, backend="INPROC") for r in range(1, 5)]
    for c in clients:
        c.run_in_thread()
    srv = build_server(ref_cfg, ds, model, backend="INPROC")
    init = jax.tree_util.tree_map(np.asarray, jax.device_get(srv.aggregator.global_vars))
    try:
        hist = srv.run_until_done(timeout=120.0)
    finally:
        for c in clients:
            c.finish()
    glob = jax.tree_util.tree_map(np.asarray, jax.device_get(srv.aggregator.global_vars))
    return hist, glob, init, srv


DP = dict(enable_dp=True, mechanism_type="gaussian", epsilon=50.0, delta=1e-5,
          sensitivity=0.01, clipping_norm=1.0)
TRUST_RUNS = {
    "cdp_buffer_all": (dict(DP, dp_solution_type="cdp"), {}, False, RUN_TOL),
    "cdp_streaming": (dict(DP, dp_solution_type="cdp"), {"streaming_aggregation": True}, True,
                      RUN_TOL),
    "ldp": (dict(DP, dp_solution_type="ldp"), {"streaming_aggregation": True}, False, RUN_TOL),
    "attack_defense": (dict(enable_attack=True, attack_type="byzantine_random",
                            poisoned_client_list=(2,), enable_defense=True,
                            defense_type="norm_diff_clipping", norm_bound=2.0),
                       {"streaming_aggregation": True}, False, ATTACK_TOL),
}


@pytest.mark.parametrize("case", sorted(TRUST_RUNS))
def test_trust_run_matches_the_reference(monkeypatch, case):
    """The plain server with the trust pipeline, port against reference
    (module docstring's tolerances): the fold engages under central DP
    alone, a defense, an attack or LDP keeps the buffer-all path, and the
    noise kernel's wrapper runs once a round under central DP."""
    from fedml_tpu.core import rng as ref_rng
    from fedml_tpu_torch.ops import noise

    flags, extra, streams, tol = TRUST_RUNS[case]
    calls = []
    wrapped = noise.apply_gaussian_noise

    def counting(x, z, sigma):
        calls.append(x.numel())
        return wrapped(x, z, sigma)

    monkeypatch.setattr(noise, "apply_gaussian_noise", counting)
    extra = {"mlp_hidden": 512, "silo_dp": False, **extra}
    ref_cfg, cfg = _cfgs(f"trust_{case}", extra, model="mlp", comm_round=2, learning_rate=0.3,
                         **flags)
    ref_hist, ref_global, init, ref_srv = _ref_run(ref_cfg)
    assert ref_srv.aggregator.stream_mode == streams
    sampler = JaxTrustSampler(ref_rng.root_key(cfg.random_seed))
    hist, group = _port_run(cfg, sampler, init, JaxPerms(cfg.random_seed))
    agg = group.server.aggregator
    assert agg.stream_mode == streams and (agg.trust is not None)
    if "dp_solution_type" in flags and flags["dp_solution_type"] == "cdp":
        assert len([n for n in calls if n > 1000]) == 2  # one launch a round
    kinds = {c[0] for c in sampler.calls}
    assert kinds == {"cdp": {"cdp"}, "ldp": {"ldp"}}.get(flags.get("dp_solution_type"),
                                                          kinds)
    got = jax.tree_util.tree_leaves(_flax_global(agg))
    want = jax.tree_util.tree_leaves(ref_global)
    start = jax.tree_util.tree_leaves(init)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol)
    assert max(np.abs(b - s).max() for b, s in zip(want, start)) > 1e-3  # it moved
    assert [h["round"] for h in hist] == [0, 1]


def test_stream_cdp_global_bitwise_the_buffer_all_global():
    """The reference's ``test_cdp_trust_streams_bitwise_sync_and_async_flags``
    on the port: two raw uploads of weight 64 folded on the streaming path
    and buffered on the exact path give the same clipped and noised global,
    bit for bit, with one noise launch each."""
    import fedml_tpu_torch
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.comm.message import Message
    from fedml_tpu_torch.cross_silo import build_aggregator
    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.models import model_hub

    out = {}
    for stream in (True, False):
        _, cfg = _cfgs("stream_cdp", {"streaming_aggregation": stream}, model="lr",
                       dp_solution_type="cdp", **{k: v for k, v in DP.items()})
        cfg = fedml_tpu_torch.init(cfg)
        ds = loader.load(cfg)
        model = model_hub.create(cfg, ds.class_num, input_shape=ds.train_x.shape[1:])
        agg = build_aggregator(cfg, ds, model, "cpu")
        assert agg.stream_mode == stream
        base = agg.host_global_flax()
        for cid in (1, 2):
            rs = np.random.RandomState(cid)
            params = jax.tree_util.tree_map(
                lambda x: np.asarray(x, np.float32) + rs.randn(*np.shape(x)).astype(np.float32),
                base)
            if stream:
                m = Message(3, cid, 0)
                m.add_params("model_params", params)
                assert agg.ingest_streaming(cid, Message.decode(m.encode()), 64.0, False)
            else:
                agg.add_local_trained_result(cid, params, 64.0)
        out[stream] = weights.torch_to_flax(weights.to_numpy(agg.aggregate(0)))
    assert _params_equal(out[True], out[False])


def test_tcp_run_matches_the_inproc_run():
    """The same CDP run (chunk frames of 2 KB, both journals) over TCP on
    ephemeral ports and over the in-process fabric: the same globals and
    history, bit for bit, every frame over TCP in chunks."""
    from fedml_tpu_torch.core import pytree as pt

    runs = {}
    for backend in ("INPROC", "TCP"):
        _, cfg = _cfgs(f"tcp_vs_{backend}", {"comm_chunk_bytes": 2048, "tcp_base_port": 0,
                                             "mlp_hidden": 64}, model="mlp", comm_round=2,
                       dp_solution_type="cdp", **DP)
        cfg.backend = backend
        hist, group = _port_run(cfg)
        runs[backend] = (hist, group)
    (h_in, g_in), (h_tcp, g_tcp) = runs["INPROC"], runs["TCP"]
    from fedml_tpu_torch.comm.tcp_backend import TCPCommManager

    assert isinstance(g_tcp.server.com_manager, TCPCommManager)
    assert g_tcp.server.com_manager.chunk_frames > 0
    assert [h["test_acc"] for h in h_in] == [h["test_acc"] for h in h_tcp]
    for a, b in zip(pt.tree_leaves(g_in.server.aggregator.global_vars),
                    pt.tree_leaves(g_tcp.server.aggregator.global_vars)):
        assert torch.equal(a, b)


def test_chaos_run_duplicates_deduped_and_global_unchanged(tmp_path):
    """A run with duplicates and short delays only (seed 1057: no fault on
    a dispatch) and the client journal: every duplicated upload the server
    read is deduped by its key, every round takes all four clients, and
    the buffer-all CDP global is bitwise the chaos-free run's."""
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.cross_silo import message_define as md

    runs, taps = {}, []
    for chaos in (False, True):
        extra = {"mlp_hidden": 64, "client_journal_dir": str(tmp_path / f"cj_{chaos}")}
        if chaos:
            extra.update(chaos_seed=1057, chaos_duplicate_prob=0.3, chaos_delay_prob=0.3,
                         chaos_delay_max_s=0.001)
        _, cfg = _cfgs(f"chaos_{chaos}", extra, model="mlp", comm_round=2,
                       dp_solution_type="cdp", **DP)
        tap = (lambda g: taps.extend(_tap_dedup(g))) if chaos else None
        runs[chaos] = _port_run(cfg, tap=tap)[1]
    g = runs[True]
    dup_keys, deduped, rounds = taps
    # a probe, the two dispatches and FINISH to each client: nothing resent,
    # and no dispatch duplicated
    assert g.server.com_manager.sends == 4 * 4
    assert sum(g.server.com_manager.injected_of_type("duplicate", t)
               for t in (md.MSG_TYPE_S2C_INIT_CONFIG, md.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT)) == 0
    assert rounds == [[1, 2, 3, 4]] * 2
    _assert_deduped(g.server, dup_keys, deduped, last_round=1)
    for a, b in zip(pt.tree_leaves(runs[False].server.aggregator.global_vars),
                    pt.tree_leaves(g.server.aggregator.global_vars)):
        assert torch.equal(a, b)


def _assert_deduped(server, dup_keys, deduped, last_round):
    """Every duplicated upload whose original the server took before the
    last round is deduped, each once, and no other key is (the final
    round's duplicates may arrive after the server finished)."""
    taken = {k for dq in server._folded_keys.values() for k in dq}
    must = {k for k in dup_keys if k in taken and int(k.split(":")[1]) < last_round}
    assert must and must <= set(deduped) <= {k for k in dup_keys if k in taken}
    assert len(deduped) == len(set(deduped)) == server.deduped_uploads


def _tap_dedup(group):
    """The upload keys chaos duplicated at the clients and those the server
    deduped, recorded as the run goes, and the clients each round
    aggregated."""
    from fedml_tpu_torch.cross_silo import message_define as md

    dup_keys, deduped, rounds = [], [], []
    for c in group.clients:
        def note(fault, rid, nonce, msg, inner=c.com_manager._note):
            if fault == "duplicate" and msg.get_type() == md.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER:
                dup_keys.append(msg.get_control(md.MSG_ARG_KEY_UPLOAD_KEY))
            inner(fault, rid, nonce, msg)

        c.com_manager._note = note
    server, agg = group.server, group.server.aggregator
    is_dup, aggregate = server._is_duplicate_upload, agg.aggregate

    def check(sender, key):
        hit = is_dup(sender, key)
        if hit:
            deduped.append(key)
        return hit

    def tapped(round_idx):
        rounds.append(sorted(agg.model_dict))
        return aggregate(round_idx)

    server._is_duplicate_upload, agg.aggregate = check, tapped
    return dup_keys, deduped, rounds


def test_chaos_faults_inside_a_round_match_the_reference(tmp_path):
    """Chaos that reaches into a round (seed 9620: round 1's dispatch to
    client 4 dropped, client 2's round-1 upload held back behind its
    round-2 upload, uploads duplicated in rounds 0 and 2, delays; the
    schedule is a pure function of the seed and the message ordinals): in
    both packages round 1 closes on its 2 s straggler timer with clients 1
    and 3, and the port's buffer-all CDP global is the reference's
    (``RUN_TOL``).  Every duplicated upload the server read before it shut
    down is deduped by its key, and nothing else: a duplicate of the last
    round's upload may arrive after the server finished."""
    from fedml_tpu.core import rng as ref_rng
    from fedml_tpu_torch.cross_silo import message_define as md

    chaos = dict(chaos_seed=9620, chaos_drop_prob=0.05, chaos_duplicate_prob=0.1,
                 chaos_reorder_prob=0.05, chaos_delay_prob=0.3, chaos_delay_max_s=0.001,
                 straggler_timeout_s=2.0)
    ref_cfg, cfg = _cfgs("chaos_round", {"mlp_hidden": 64, "silo_dp": False, **chaos},
                         model="mlp", comm_round=3, learning_rate=0.3,
                         dp_solution_type="cdp", **DP)
    ref_cfg.extra["client_journal_dir"] = str(tmp_path / "ref")
    cfg.extra["client_journal_dir"] = str(tmp_path / "port")
    ref_hist, ref_global, init, _ = _ref_run(ref_cfg)
    taps = []
    hist, group = _port_run(cfg, JaxTrustSampler(ref_rng.root_key(cfg.random_seed)), init,
                            JaxPerms(cfg.random_seed), tap=lambda g: taps.extend(_tap_dedup(g)))
    dup_keys, deduped, rounds = taps
    server = group.server
    assert [h["round"] for h in hist] == [h["round"] for h in ref_hist] == [0, 1, 2]
    assert rounds == [[1, 2, 3, 4], [1, 3], [1, 2, 3, 4]]
    assert server.com_manager.injected_of_type("drop", md.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT) == 1
    held = group.clients[1].com_manager
    assert held.injected_of_type("reorder", md.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER) == 1
    _assert_deduped(server, dup_keys, deduped, last_round=2)
    got = jax.tree_util.tree_leaves(_flax_global(server.aggregator))
    for a, b in zip(got, jax.tree_util.tree_leaves(ref_global)):
        np.testing.assert_allclose(a, b, rtol=RUN_TOL, atol=RUN_TOL)
