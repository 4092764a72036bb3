"""Port parity: the journals under FHE aggregation
(``fedml_tpu_torch/cross_silo/fhe.py``, the refusal in ``server.py``), as
the reference behaves when it is crashed by its protocol's own messages
(``cross_silo/crash_drill.py`` in the port; the same drills on
``fedml_tpu/cross_silo/fhe.py``), on the CPU.

An FHE run is bitwise repeatable in both packages: a client's upload is its
model / n rounded to the fixed-point grid, and the aggregate decrypts to
the sum of those levels whatever the encryption draws.  So every drill is
held bitwise to its package's uninterrupted run:

- the reference's FHE client writes no journal and sends its upload with no
  session epoch and no upload key; a silo killed before round 2 and rebuilt
  over ``client_journal_dir`` joins the next dispatch, bitwise (both
  packages; the port over INPROC and TCP);
- the reference's FHE server killed at round 1's boundary and rebuilt over
  ``server_journal_dir`` recovers bitwise, but killed after two of round
  1's uploads it ends at a wrong global (the recovered server takes a dead
  server's queued upload, which carries no epoch, before its first dispatch
  and closes round 1 on it alone): the port refuses ``server_journal_dir``
  under FHE, naming that.
"""

import tempfile
import time

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

_DISPATCH = (1, 2)  # INIT, SYNC


def _cfg(pkg, run_id, backend="INPROC", **extra):
    if pkg == "ref":
        from fedml_tpu.arguments import Config
    else:
        from fedml_tpu_torch.arguments import Config
    return Config(training_type="cross_silo", role="server", backend=backend,
                  dataset="synthetic", model="lr", client_num_in_total=4,
                  client_num_per_round=4, comm_round=3, epochs=1, batch_size=16,
                  learning_rate=0.1, synthetic_train_size=256, synthetic_test_size=64,
                  partition_method="homo", frequency_of_the_test=0, compute_dtype="float32",
                  random_seed=0, enable_fhe=True, run_id=run_id, extra=dict(extra))


def _ref_drill(tag, *, kill_server=None, kill_mid=None, kill_client=None,
               server_journal=False, client_journal=False, timeout=30.0):
    """The reference's FHE group with crashes placed by its own messages:
    ``(history, final global leaves, error or None, uploads' (epoch, key))``."""
    import fedml_tpu
    from fedml_tpu.comm.inproc import InProcRouter
    from fedml_tpu.cross_silo import message_define as md
    from fedml_tpu.cross_silo.fhe import build_fhe_client as bc
    from fedml_tpu.cross_silo.fhe import build_fhe_server as bs
    from fedml_tpu.data import loader
    from fedml_tpu.models import model_hub

    d = tempfile.mkdtemp(prefix="ref_fhe_drill_")
    extra = {}
    if server_journal:
        extra["server_journal_dir"] = d + "/s"
    if client_journal:
        extra["client_journal_dir"] = d + "/c"
    cfg = _cfg("ref", f"ref_fhe_drill_{tag}", **extra)
    fedml_tpu.init(cfg)
    ds = loader.load(cfg)
    model = model_hub.create(cfg, ds.class_num)
    InProcRouter.reset(cfg.run_id)
    clients = [bc(cfg, ds, model, rank=r, backend="INPROC") for r in range(1, 5)]
    state = {"killed": False, "uploads": 0, "client_kills": 0, "fields": []}

    def tap(srv):
        send = srv.send_message

        def send_tapped(msg):
            if srv is state["first"] and state["killed"]:
                return
            rnd = msg.get_control(md.MSG_ARG_KEY_ROUND_INDEX)
            if msg.get_type() in _DISPATCH and rnd is not None:
                if srv is state["first"] and kill_server is not None and int(rnd) == kill_server:
                    state["killed"] = True
                    srv.hard_kill()
                    return
                rank = int(msg.get_receiver_id())
                if kill_client and not state["client_kills"] and (rank, int(rnd)) == kill_client:
                    clients[rank - 1].hard_kill()
                    time.sleep(0.2)
                    clients[rank - 1] = bc(cfg, ds, model, rank=rank, backend="INPROC")
                    clients[rank - 1].run_in_thread()
                    state["client_kills"] += 1
            send(msg)

        srv.send_message = send_tapped
        handle = srv.handle_message_receive_model

        def handle_tapped(msg):
            state["fields"].append((msg.get_control(md.MSG_ARG_KEY_SESSION_EPOCH),
                                    msg.get_control(md.MSG_ARG_KEY_UPLOAD_KEY)))
            handle(msg)
            if kill_mid is not None and srv is state["first"] and not state["killed"] and \
                    int(msg.get(md.MSG_ARG_KEY_ROUND_INDEX)) == kill_mid[0]:
                state["uploads"] += 1
                if state["uploads"] == kill_mid[1]:
                    state["killed"] = True
                    srv.hard_kill()

        srv.handle_message_receive_model = handle_tapped

    for c in clients:
        c.run_in_thread()
    srv = bs(cfg, ds, model, backend="INPROC")
    state["first"] = srv
    tap(srv)
    hist, err = [], None
    try:
        srv.run_in_thread()
        srv.start()
        deadline = time.monotonic() + timeout
        while not (state["killed"] or srv.done.is_set()) and time.monotonic() < deadline:
            time.sleep(0.02)
        hist += srv.history
        if state["killed"]:
            time.sleep(0.2)  # the dead loop's poll runs out
            if kill_mid is not None:
                # the round's other uploads reach the dead server's queue
                inbox = InProcRouter.get(cfg.run_id).queues[0]
                t_q = time.monotonic() + 10.0
                while inbox.qsize() < 4 - kill_mid[1] and time.monotonic() < t_q:
                    time.sleep(0.01)
            srv = bs(cfg, ds, model, backend="INPROC")
            tap(srv)
        if not srv.done.is_set():
            hist += srv.run_until_done(timeout=timeout)
    except Exception as e:  # the reference's failure is the finding
        err = e
    finally:
        for c in clients:
            c.finish()
        state["first"].finish()
        srv.finish()
    leaves = [np.asarray(a) for a in
              jax.tree_util.tree_leaves(jax.device_get(srv.aggregator.global_vars))]
    return hist, leaves, err, state["fields"]


def _port_drill(tag, backend="INPROC", client_journal=False, **kills):
    import fedml_tpu_torch
    from fedml_tpu_torch.cross_silo.crash_drill import run_with_crashes
    from fedml_tpu_torch.cross_silo.server import FedMLServerManager
    from fedml_tpu_torch.cross_silo import message_define as md
    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.models import model_hub

    d = tempfile.mkdtemp(prefix="port_fhe_drill_")
    extra = {"tcp_base_port": 0}
    if client_journal:
        extra["client_journal_dir"] = d + "/c"
    cfg = fedml_tpu_torch.init(_cfg("port", f"port_fhe_drill_{tag}_{backend}", backend, **extra))
    ds = loader.load(cfg)
    model = model_hub.create(cfg, ds.class_num, input_shape=ds.train_x.shape[1:])
    fields = []
    handle = FedMLServerManager.handle_message_receive_model

    def handle_tapped(self, msg):
        fields.append((msg.get_control(md.MSG_ARG_KEY_SESSION_EPOCH),
                       msg.get_control(md.MSG_ARG_KEY_UPLOAD_KEY)))
        handle(self, msg)

    mp = pytest.MonkeyPatch()
    mp.setattr(FedMLServerManager, "handle_message_receive_model", handle_tapped)
    try:
        out = run_with_crashes(cfg, ds, model, "cpu", backend=backend, timeout=30.0, **kills)
    finally:
        mp.undo()
    out["fields"] = fields
    return out


def _port_global(server):
    from fedml_tpu_torch.core import pytree as pt

    return [t.clone() for t in pt.tree_leaves(server.aggregator.global_vars)]


def _same(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def test_fhe_client_restart_joins_the_next_round_as_the_reference():
    """A silo killed before round 2 and rebuilt over ``client_journal_dir``
    (which holds nothing: the FHE client does not journal) joins round 2:
    both packages end bitwise at their uninterrupted global, and no FHE
    upload of either carries a session epoch or an upload key."""
    _, base, err, _ = _ref_drill("cj_base")
    assert err is None
    hist, leaves, err, fields = _ref_drill("cj_kill", client_journal=True, kill_client=(2, 2))
    assert err is None and [h["round"] for h in hist] == [0, 1, 2]
    assert all(np.array_equal(a, b) for a, b in zip(base, leaves))
    assert len(fields) == 12 and set(fields) == {(None, None)}
    for backend in ("INPROC", "TCP"):
        plain = _port_drill("cj_base", backend)
        out = _port_drill("cj_kill", backend, client_journal=True, kill_client=(2, 2))
        assert out["client_kills"] == 1 and not out["clients"][1].resumed_from_journal
        assert [h["round"] for h in out["history"]] == [0, 1, 2]
        assert _same(_port_global(plain["server"]), _port_global(out["server"]))
        assert len(out["fields"]) == 12 and set(out["fields"]) == {(None, None)}
        assert all(c.client_journal is not None for c in out["clients"])


def test_fhe_server_journal_refused_where_the_reference_loses_the_round():
    """The reference's FHE server recovers a round-boundary crash bitwise,
    but crashed after two of round 1's uploads its run ends at a wrong
    global.  The port refuses ``server_journal_dir`` under FHE, naming
    that."""
    from fedml_tpu_torch.cross_silo.server import FHE_SERVER_JOURNAL_REFUSAL
    from fedml_tpu_torch.runner import FedMLRunner

    _, base, err, _ = _ref_drill("sj_base")
    assert err is None
    hist, leaves, err, _ = _ref_drill("sj_boundary", server_journal=True, kill_server=1)
    assert err is None and [h["round"] for h in hist] == [0, 1, 2]
    assert all(np.array_equal(a, b) for a, b in zip(base, leaves))
    hist, leaves, err, _ = _ref_drill("sj_mid", server_journal=True, kill_mid=(1, 2))
    assert err is None and [h["round"] for h in hist] == [0, 1, 2]
    assert max(float(np.max(np.abs(a - b))) for a, b in zip(base, leaves)) > 1e-3
    for role in ("server", "client"):
        cfg = _cfg("port", f"fhe_sj_refused_{role}", server_journal_dir="/nonexistent/s")
        cfg.role, cfg.rank = role, 1
        if role == "client":
            cfg.backend = "TCP"
            cfg.extra["tcp_base_port"] = 31000
        with pytest.raises(NotImplementedError) as e:
            FedMLRunner(cfg, device="cpu")
        assert str(e.value) == FHE_SERVER_JOURNAL_REFUSAL
