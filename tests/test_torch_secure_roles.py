"""Port parity: the secure protocols across processes and with journals
(``fedml_tpu_torch/cross_silo/__init__.py`` roles and TCP under Shamir
SecAgg and LightSecAgg, ``cross_silo/crash_drill.py`` on the secure
groups, the journal refusals of ``cross_silo/server.py`` and
``client.py``), against the port's own in-process group and against
``fedml_tpu/cross_silo/`` on the CPU.

- Over TCP (``tcp_base_port: 0``) both protocols end bitwise at the
  in-process group's global: LightSecAgg's masks cancel exactly in the
  field, and Shamir's central-DP draw comes from the same ``noise_sampler``
  (the reference's draws, ``tests/test_torch_secagg.py::JaxNoise``).
- The lone roles: a Shamir server of ``role: server`` and four silos of
  ``role: client`` on fixed ports (threads of this process), and the
  ``cross_silo_lightsecagg_lr`` recipe as one server process and four silo
  processes (each started with ``sys.executable``, none importing ``jax``),
  end bitwise at the in-process group's global and history.
- The journals, as the reference behaves when it is crashed by its
  protocol's own messages (the same drills run on both packages): the
  Shamir server recovers a crash at a round boundary and inside a round
  (with and without ``server_journal_every_folds``, which takes no
  mid-round snapshot under SecAgg) bitwise the uninterrupted run; the
  LightSecAgg client restarted at a round boundary joins the next round's
  mask exchange, bitwise.  Where the reference fails, the port refuses the
  flag and names the failure: the reference's Shamir client restarted over
  its journal re-keys and the run ends at a wrong global; the reference's
  LightSecAgg server crashed inside a round stalls until its timeout.
"""

import json
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from .test_torch_secagg import JaxNoise

torch.set_num_threads(1)

RECIPE = Path(__file__).resolve().parent.parent / "examples" / "cross_silo_lightsecagg_lr" / \
    "fedml_config.yaml"
CUT = dict(comm_round=3, synthetic_train_size=512, synthetic_test_size=128,
           frequency_of_the_test=1)
CHILD_TIMEOUT_S = 120.0
DP = dict(enable_dp=True, dp_solution_type="cdp", epsilon=50.0, delta=1e-5, sensitivity=0.01,
          clipping_norm=1.0)


def _cfg(pkg, method, run_id, rounds=2, backend="INPROC", dp=False, **extra):
    """A 4-silo LR run of ``method`` in ``pkg``'s Config."""
    if pkg == "ref":
        from fedml_tpu.arguments import Config
    else:
        from fedml_tpu_torch.arguments import Config
    ex = {"secagg_method": method, **extra}
    if method == "shamir":
        ex["secagg_stream"] = True
    return Config(training_type="cross_silo", role="server", backend=backend,
                  dataset="synthetic", model="lr", client_num_in_total=4,
                  client_num_per_round=4, comm_round=rounds, epochs=1, batch_size=16,
                  learning_rate=0.1, synthetic_train_size=256, synthetic_test_size=64,
                  partition_method="homo", frequency_of_the_test=1, compute_dtype="float32",
                  random_seed=0, enable_secagg=True, run_id=run_id, extra=ex,
                  **(DP if dp else {}))


def _port_global(server):
    from fedml_tpu_torch.core import pytree as pt

    return [t.clone() for t in pt.tree_leaves(server.aggregator.global_vars)]


def _same(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _strip(hist):
    drop = ("round_time_s", "aggregate_time_s", "finalize_time_s", "fold_time_s")
    return [{k: v for k, v in h.items() if k not in drop} for h in hist]


def _group_run(cfg, noise=False):
    import fedml_tpu_torch
    from fedml_tpu_torch.runner import FedMLRunner

    runner = FedMLRunner(fedml_tpu_torch.init(cfg), device="cpu")
    if noise:
        runner.runner.noise_sampler = JaxNoise(cfg.random_seed)
    hist = runner.run()
    return hist, runner.runner


@pytest.mark.parametrize("method", ["shamir", "lightsecagg"])
def test_secure_group_over_tcp_bitwise_the_inprocess_group(method):
    """The in-process group over loopback TCP (ephemeral ports, many small
    frames: keys, shares, reveals or mask shares; chunk frames on) ends at
    the INPROC group's global and history, bitwise (Shamir with central DP
    at finalize, the reference's draws)."""
    shamir = method == "shamir"
    runs = {}
    for backend in ("INPROC", "TCP"):
        cfg = _cfg("port", method, f"secure_tcp_{method}_{backend}", backend=backend,
                   dp=shamir, tcp_base_port=0, comm_chunk_bytes=512)
        hist, group = _group_run(cfg, noise=shamir)
        runs[backend] = (hist, _port_global(group.server))
        if shamir:
            assert group.server.aggregator.dp_pre_noise is not None
    assert _strip(runs["TCP"][0]) == _strip(runs["INPROC"][0])
    assert _same(runs["TCP"][1], runs["INPROC"][1])


def test_shamir_lone_roles_bitwise_the_group():
    """``role: server`` alone and four ``role: client`` silos (threads of
    this process on the fixed ports ``tcp_base_port + rank``) under Shamir
    SecAgg with central DP: the server's history and global are the
    in-process group's, bitwise."""
    import fedml_tpu_torch
    from fedml_tpu_torch.cross_silo.async_soak import _free_port_block
    from fedml_tpu_torch.runner import FedMLRunner

    want_hist, group = _group_run(_cfg("port", "shamir", "shamir_roles_group", dp=True),
                                  noise=True)
    port = _free_port_block(5)
    silos, errors = [], []

    def silo(rank):
        cfg = _cfg("port", "shamir", "shamir_roles", backend="TCP", dp=True, tcp_base_port=port)
        cfg.role, cfg.rank = "client", rank
        try:
            assert FedMLRunner(fedml_tpu_torch.init(cfg), device="cpu").run() is None
        except BaseException as e:  # reported below
            errors.append(e)

    for r in range(1, 5):
        t = threading.Thread(target=silo, args=(r,), daemon=True)
        t.start()
        silos.append(t)
    cfg = _cfg("port", "shamir", "shamir_roles", backend="TCP", dp=True, tcp_base_port=port)
    runner = FedMLRunner(fedml_tpu_torch.init(cfg), device="cpu")
    runner.runner.noise_sampler = JaxNoise(cfg.random_seed)
    runner.runner.timeout = 60.0
    hist = runner.run()
    for t in silos:
        t.join(timeout=30.0)
    assert not errors and not any(t.is_alive() for t in silos)
    assert runner.runner.clients == [] and type(runner.runner.server).__name__ == \
        "SAServerManager"
    assert _strip(hist) == _strip(want_hist)
    assert _same(_port_global(runner.runner.server), _port_global(group.server))


# A party of the LightSecAgg recipe as a process of its own: init and
# FedMLRunner as a user starts one; the server writes its history and global.
CHILD = r'''
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
import fedml_tpu_torch
from fedml_tpu_torch import weights
from fedml_tpu_torch.runner import FedMLRunner

recipe, role, rank, port, out_path, cut = sys.argv[1:7]
cfg = fedml_tpu_torch.init(argv=["--cf", recipe, "--role", role, "--rank", rank])
for k, v in json.loads(cut).items():
    setattr(cfg, k, v)
cfg.backend = "TCP"
cfg.extra.update(tcp_base_port=int(port), tcp_ip_config={"3": "127.0.0.3"})
runner = FedMLRunner(fedml_tpu_torch.init(cfg), device="cpu")
hist = runner.run()
assert "jax" not in sys.modules
assert not any(m == "fedml_tpu" or m.startswith("fedml_tpu.") for m in sys.modules)
if role == "server":
    flat = weights.flatten_reference(runner.runner.server.aggregator.global_vars)[0].numpy()
    np.save(out_path, flat)
    with open(out_path + ".json", "w") as f:
        json.dump(hist, f)
'''


def _start(role, rank, port, out, log_dir):
    from fedml_tpu_torch.cross_silo.async_soak import soak_worker_env

    with open(log_dir / f"{role}_{rank}.log", "wb") as log:
        return subprocess.Popen(
            [sys.executable, "-c", CHILD, str(RECIPE), role, str(rank), str(port), str(out),
             json.dumps(CUT)],
            stdout=log, stderr=subprocess.STDOUT, env=soak_worker_env(),
            cwd=str(Path(__file__).resolve().parent.parent))


def test_lightsecagg_recipe_as_processes_bitwise_the_group(tmp_path):
    """The ``cross_silo_lightsecagg_lr`` recipe (cut to 3 rounds on 512 / 128
    images) as one server process and four silo processes over TCP on fixed
    ports (silo 3 addressed as 127.0.0.3): the final global and history are
    the in-process group's, bitwise; no child imports ``jax``."""
    import fedml_tpu_torch
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.cross_silo.async_soak import _free_port_block, _tail
    from fedml_tpu_torch.runner import FedMLRunner

    cfg = fedml_tpu_torch.init(argv=["--cf", str(RECIPE)])
    for k, v in CUT.items():
        setattr(cfg, k, v)
    cfg.run_id = "lsa_recipe_group"
    runner = FedMLRunner(cfg, device="cpu")
    group_hist = runner.run()
    want = weights.flatten_reference(runner.runner.server.aggregator.global_vars)[0].numpy()
    port = _free_port_block(cfg.client_num_in_total + 1)
    out = tmp_path / "server_global.npy"
    procs = [_start("client", r, port, out, tmp_path)
             for r in range(1, cfg.client_num_in_total + 1)]
    procs.append(_start("server", 0, port, out, tmp_path))
    try:
        for p in procs:
            rc = p.wait(timeout=CHILD_TIMEOUT_S)
            assert rc == 0, "\n".join(_tail(str(f)) for f in sorted(tmp_path.glob("*.log")))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    got = np.load(out)
    with open(str(out) + ".json") as f:
        proc_hist = json.load(f)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert _strip(proc_hist) == _strip(group_hist)
    assert [h["round"] for h in proc_hist] == [0, 1, 2]


# -- the journals under SecAgg, as the reference behaves ----------------------------

_DISPATCH = (1, 2)  # INIT, SYNC


def _ref_drill(method, tag, *, kill_server=None, kill_mid=None, kill_client=None,
               every_folds=0, server_journal=True, client_journal=False, timeout=30.0):
    """The reference's group of ``method`` with crashes placed by its own
    messages, as ``crash_drill.run_with_crashes`` places them in the port:
    ``(history, final global leaves, error or None)``."""
    import fedml_tpu
    from fedml_tpu.comm.inproc import InProcRouter
    from fedml_tpu.cross_silo import message_define as md
    from fedml_tpu.data import loader
    from fedml_tpu.models import model_hub

    d = tempfile.mkdtemp(prefix="ref_secure_drill_")
    extra = {}
    if server_journal:
        extra["server_journal_dir"] = d + "/s"
    if every_folds:
        extra["server_journal_every_folds"] = every_folds
    if client_journal:
        extra["client_journal_dir"] = d + "/c"
    cfg = _cfg("ref", method, f"ref_drill_{method}_{tag}", rounds=3, **extra)
    cfg.frequency_of_the_test = 0
    fedml_tpu.init(cfg)
    ds = loader.load(cfg)
    model = model_hub.create(cfg, ds.class_num)
    if method == "shamir":
        from fedml_tpu.cross_silo.secagg_shamir import build_sa_client as bc
        from fedml_tpu.cross_silo.secagg_shamir import build_sa_server as bs
    else:
        from fedml_tpu.cross_silo.lightsecagg import build_lsa_client as bc
        from fedml_tpu.cross_silo.lightsecagg import build_lsa_server as bs
    InProcRouter.reset(cfg.run_id)
    clients = [bc(cfg, ds, model, rank=r, backend="INPROC") for r in range(1, 5)]
    state = {"killed": False, "uploads": 0, "client_kills": 0}

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
        if kill_mid is not None:
            handle = srv.handle_message_receive_model

            def handle_tapped(msg):
                handle(msg)
                if srv is state["first"] and int(msg.get(md.MSG_ARG_KEY_ROUND_INDEX)) == \
                        kill_mid[0] and not state["killed"]:
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
                # before the rebuild (what the recovered server then drains)
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
    return hist, leaves, err


def _port_drill(method, tag, backend="INPROC", *, server_journal=True, client_journal=False,
                every_folds=0, **kills):
    import fedml_tpu_torch
    from fedml_tpu_torch.cross_silo.crash_drill import run_with_crashes
    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.models import model_hub

    d = tempfile.mkdtemp(prefix="port_secure_drill_")
    extra = {"tcp_base_port": 0}
    if server_journal:
        extra["server_journal_dir"] = d + "/s"
    if every_folds:
        extra["server_journal_every_folds"] = every_folds
    if client_journal:
        extra["client_journal_dir"] = d + "/c"
    cfg = _cfg("port", method, f"port_drill_{method}_{tag}_{backend}", rounds=3,
               backend=backend, **extra)
    cfg.frequency_of_the_test = 0
    cfg = fedml_tpu_torch.init(cfg)
    ds = loader.load(cfg)
    model = model_hub.create(cfg, ds.class_num, input_shape=ds.train_x.shape[1:])
    return run_with_crashes(cfg, ds, model, "cpu", backend=backend, timeout=30.0, **kills)


SHAMIR_SERVER_CRASHES = {
    "round_boundary": dict(kill_server=1),
    "inside_round": dict(kill_mid=(1, 2)),
    "inside_round_every_folds": dict(kill_mid=(1, 2), every_folds=1),
}


@pytest.mark.parametrize("case", sorted(SHAMIR_SERVER_CRASHES))
def test_shamir_server_journal_recovers_as_the_reference(case):
    """The Shamir server killed before round 1's dispatch, or after two of
    round 1's masked uploads, and rebuilt over its journal: round 1 is
    redone under session epoch 1 and the run ends at the uninterrupted
    global, bitwise (the port over INPROC and TCP).  The reference is held
    to it at the round boundary.  Inside a round its recovered server takes
    the dead server's two queued uploads before its first dispatch, against
    an empty selection (an early reveal phase whose aggregate raises in the
    handler); its run still ended at the uninterrupted global in every drill
    on the CPU, but by the order of its threads, so the test holds the
    reference at the boundary alone.  The port's recovered server drops
    uploads that reach it before its first dispatch (ROADMAP Queue 3)."""
    kw = SHAMIR_SERVER_CRASHES[case]
    if "kill_server" in kw:
        _, ref_base, err = _ref_drill("shamir", f"{case}_base", server_journal=False)
        assert err is None
        ref_hist, ref_leaves, err = _ref_drill("shamir", case, **kw)
        assert err is None and [h["round"] for h in ref_hist] == [0, 1, 2]
        assert all(np.array_equal(a, b) for a, b in zip(ref_base, ref_leaves))
    port_kw = {"every_folds": kw.get("every_folds", 0)}
    if "kill_server" in kw:
        port_kw["kill_server_before_round"] = kw["kill_server"]
    else:
        port_kw["kill_server_after_uploads"] = kw["kill_mid"]
    for backend in ("INPROC", "TCP"):
        base = _port_drill("shamir", f"{case}_base", backend, server_journal=False)
        out = _port_drill("shamir", case, backend, **port_kw)
        assert out["server_kills"] == 1 and [h["round"] for h in out["history"]] == [0, 1, 2]
        assert out["server"].session_epoch == 1 and out["server"].recovered_step == 1
        assert _same(_port_global(base["server"]), _port_global(out["server"]))


def _shamir_server_takes(pkg, tag, senders, recovered=False):
    """An unstarted Shamir server of ``pkg`` (LR, 4 silos, the streaming
    field fold) fed one masked upload from each of ``senders`` through its
    model handler in round 0 (ring vectors drawn from a seed; ``None`` in
    ``senders`` stands for the first dispatch, to all four silos):
    ``(masked field total or None, survivors, phase, the vectors sent,
    modulus)``.
    ``recovered`` marks the port's server as rebuilt from a journal, as
    ``_journal_recover`` does."""
    if pkg == "ref":
        import fedml_tpu as pkg_mod
        from fedml_tpu.comm.inproc import InProcRouter
        from fedml_tpu.comm.message import Message
        from fedml_tpu.cross_silo import message_define as md
        from fedml_tpu.cross_silo import secagg_shamir as sa
        from fedml_tpu.data import loader
        from fedml_tpu.models import model_hub
        from fedml_tpu.trust.secagg.stream import pack_ring
    else:
        import fedml_tpu_torch as pkg_mod
        from fedml_tpu_torch.comm.inproc import InProcRouter
        from fedml_tpu_torch.comm.message import Message
        from fedml_tpu_torch.cross_silo import message_define as md
        from fedml_tpu_torch.cross_silo import secagg_shamir as sa
        from fedml_tpu_torch.data import loader
        from fedml_tpu_torch.models import model_hub
        from fedml_tpu_torch.trust.secagg.stream import pack_ring

    cfg = _cfg(pkg, "shamir", f"shamir_guard_{tag}")
    cfg = pkg_mod.init(cfg) or cfg
    ds = loader.load(cfg)
    InProcRouter.reset(cfg.run_id)
    if pkg == "ref":
        srv = sa.build_sa_server(cfg, ds, model_hub.create(cfg, ds.class_num), backend="INPROC")
    else:
        model = model_hub.create(cfg, ds.class_num, input_shape=ds.train_x.shape[1:])
        srv = sa.build_sa_server(cfg, ds, model, "cpu", backend="INPROC")
        srv.recovered_step = 1 if recovered else None
    agg = srv.aggregator
    rs = np.random.RandomState(5)
    sent = []
    try:
        for sender in senders:
            if sender is None:
                srv.selected = list(srv.client_ids)
                if pkg == "port":
                    srv._init_sent = True
                continue
            vec = rs.randint(0, agg.ring.modulus, size=agg.model_dim).astype(np.int64)
            sent.append(vec)
            m = Message(md.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER, sender, 0)
            m.add_params(md.MSG_ARG_KEY_MODEL_PARAMS, pack_ring(vec, agg.ring.bits))
            m.add_params(sa.MSG_ARG_KEY_SECAGG_META, agg.ring.meta(vec.size))
            m.add_params(md.MSG_ARG_KEY_NUM_SAMPLES, 64)
            m.add_params(md.MSG_ARG_KEY_ROUND_INDEX, 0)
            srv.handle_message_receive_model(m)
        total = None if agg._msum is None else agg._msum.masked_total().copy()
        return total, list(agg.survivor_ids()), srv._phase, sent, agg.ring.modulus
    finally:
        srv.finish()


@pytest.mark.parametrize("case", ["before_dispatch", "second_upload"])
def test_unjournaled_shamir_server_takes_uploads_as_the_reference(case):
    """A Shamir server never rebuilt from a journal takes uploads as the
    reference's does, bit for bit in the masked field total, with the same
    survivors and phase: one that reaches it before its first dispatch
    closes the empty selection (the reveal phase opens and the next upload
    is turned away), and a second upload from the same silo in a round is
    folded again.  A server rebuilt from its journal drops both (ROADMAP
    Queue 3)."""
    senders, want_ids, want_phase, summed = {
        "before_dispatch": ([1, 2], [1], "reveal", [0]),
        "second_upload": ([None, 1, 1, 2], [1, 2], "model", [0, 1, 2]),
    }[case]
    ref_total, ref_ids, ref_phase, sent, q = _shamir_server_takes("ref", f"ref_{case}", senders)
    total, ids, phase, _, _ = _shamir_server_takes("port", f"plain_{case}", senders)
    assert ids == ref_ids == want_ids and phase == ref_phase == want_phase
    assert total.dtype == ref_total.dtype and np.array_equal(total, ref_total)
    assert np.array_equal(ref_total, sum(sent[i] for i in summed) % q)
    total, ids, phase, sent, q = _shamir_server_takes("port", f"recovered_{case}", senders,
                                                      recovered=True)
    if case == "before_dispatch":
        assert total is None and ids == [] and phase == "model"
    else:
        assert ids == [1, 2] and phase == "model"
        assert np.array_equal(total, (sent[0] + sent[2]) % q)


def test_shamir_client_journal_refused_where_the_reference_loses_the_keys():
    """The reference's Shamir silo killed before round 2 and rebuilt over its
    client journal draws new keys: its run completes at a wrong global.  The
    port refuses ``client_journal_dir`` under Shamir SecAgg, naming that."""
    from fedml_tpu_torch.cross_silo.client import SHAMIR_CLIENT_JOURNAL_REFUSAL
    from fedml_tpu_torch.runner import FedMLRunner

    _, base, err = _ref_drill("shamir", "cj_base", server_journal=False)
    assert err is None
    hist, leaves, err = _ref_drill("shamir", "cj_kill", server_journal=False,
                                   client_journal=True, kill_client=(2, 2))
    assert err is None and [h["round"] for h in hist] == [0, 1, 2]
    assert max(float(np.max(np.abs(a - b))) for a, b in zip(base, leaves)) > 1.0
    cfg = _cfg("port", "shamir", "shamir_cj_refused", client_journal_dir="/nonexistent/c")
    with pytest.raises(NotImplementedError) as e:
        FedMLRunner(cfg, device="cpu")
    assert str(e.value) == SHAMIR_CLIENT_JOURNAL_REFUSAL


def test_lightsecagg_server_journal_refused_where_the_reference_stalls():
    """The reference's LightSecAgg server recovers a round-boundary crash,
    but crashed after two of round 1's masked uploads it stalls (the dead
    server's queued uploads meet the new mask exchange) until its timeout.
    The port refuses ``server_journal_dir`` under LightSecAgg, naming that."""
    from fedml_tpu_torch.cross_silo.server import LSA_SERVER_JOURNAL_REFUSAL
    from fedml_tpu_torch.runner import FedMLRunner

    hist, _, err = _ref_drill("lightsecagg", "sj_boundary", kill_server=1)
    assert err is None and [h["round"] for h in hist] == [0, 1, 2]
    _, base, err = _ref_drill("lightsecagg", "sj_base", server_journal=False)
    assert err is None
    hist, leaves, err = _ref_drill("lightsecagg", "sj_mid", kill_mid=(1, 2), timeout=6.0)
    # a stall (TimeoutError, observed) or, with other thread timing, a
    # global that is not the uninterrupted one: never the right end
    assert err is not None or not all(np.array_equal(a, b) for a, b in zip(base, leaves))
    cfg = _cfg("port", "lightsecagg", "lsa_sj_refused", server_journal_dir="/nonexistent/s")
    with pytest.raises(NotImplementedError) as e:
        FedMLRunner(cfg, device="cpu")
    assert str(e.value) == LSA_SERVER_JOURNAL_REFUSAL


def test_lightsecagg_client_restart_joins_the_next_round_as_the_reference():
    """A LightSecAgg silo killed before round 2 and rebuilt over its client
    journal (which, as in the reference, holds nothing: the LightSecAgg
    client does not journal) joins round 2's fresh mask exchange: both
    packages end at their uninterrupted global, bitwise."""
    _, base, err = _ref_drill("lightsecagg", "lcj_base", server_journal=False)
    assert err is None
    hist, leaves, err = _ref_drill("lightsecagg", "lcj_kill", server_journal=False,
                                   client_journal=True, kill_client=(2, 2))
    assert err is None and all(np.array_equal(a, b) for a, b in zip(base, leaves))
    for backend in ("INPROC", "TCP"):
        plain = _port_drill("lightsecagg", "lcj_base", backend, server_journal=False)
        out = _port_drill("lightsecagg", "lcj_kill", backend, server_journal=False,
                          client_journal=True, kill_client=(2, 2))
        assert out["client_kills"] == 1 and not out["clients"][1].resumed_from_journal
        assert _same(_port_global(plain["server"]), _port_global(out["server"]))


REFUSALS = {
    "multiprocess_silo": (dict(role="client", rank=1, backend="TCP",
                               extra={"coordinator_address": "localhost:1", "tcp_base_port": 1}),
                          NotImplementedError, "not wired into the secure-aggregation clients"),
    "tree": (dict(extra={"hier_fanout": 2}), NotImplementedError, "secure-"),
    "fhe_and_secagg": (dict(enable_fhe=True), NotImplementedError, "enable_secagg"),
    "partial": (dict(client_num_per_round=3), ValueError, "full participation"),
    "async": (dict(extra={"async_aggregation": True}), ValueError, "async_aggregation"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
@pytest.mark.parametrize("method", ["shamir", "lightsecagg"])
def test_refusals_that_stay(method, case):
    from fedml_tpu_torch.runner import FedMLRunner

    kw, exc, match = REFUSALS[case]
    kw = dict(kw)
    extra = kw.pop("extra", {})
    cfg = _cfg("port", method, f"secure_refusal_{case}", **extra)
    for k, v in kw.items():
        setattr(cfg, k, v)
    with pytest.raises(exc, match=match):
        FedMLRunner(cfg, device="cpu")
