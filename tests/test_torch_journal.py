"""Port parity: the recovery journals (``fedml_tpu_torch/cross_silo/
journal.py``, ``client_journal.py``), the plain server's session epoch,
upload dedup and mid-round snapshots (``cross_silo/server.py``), the
client's journal and attempt keys (``cross_silo/client.py``) and the crash
drills (``cross_silo/crash_drill.py``), against ``fedml_tpu/cross_silo/`` on
the CPU.

- The sidecars: the port's step file is read by the reference's reader
  and the reference's by the port's, protocol and arrays bitwise; corrupt
  steps fall back alike; ``keep`` prunes alike.
- A server fed the same keyed uploads as the reference's (the reference's
  initial LR weights carried across): the same dedup count, and a
  mid-round journal whose protocol and partial sums are bitwise the
  reference's (``health`` aside: the reference's health ledger is not
  ported, the port journals it empty).
- Recovery on the CPU is bitwise: a mid-round crash resumes the partial
  fold and ends at the uninterrupted run's global; a drill that kills the
  server after its first round and a client before the last one ends at
  the uninterrupted run's global, over the in-process fabric and TCP, and
  a compressed (topk) one-client drill also carries its error-feedback
  residuals bit for bit.
"""

import os
import time

import jax
import numpy as np
import pytest
import torch

from .conftest import tiny_config

torch.set_num_threads(1)


def _pair_cfgs(run_id, **kw):
    import fedml_tpu_torch.arguments as args

    ref_cfg = tiny_config(training_type="cross_silo", run_id=run_id, role="server",
                          backend="INPROC", frequency_of_the_test=0, **kw)
    fields = {k: v for k, v in vars(ref_cfg).items() if k in args.Config.__dataclass_fields__}
    return ref_cfg, args.Config(**{**fields, "extra": dict(ref_cfg.extra)})


# -- ServerJournal ---------------------------------------------------------------

def _journals(tmp_path, keep=3):
    from fedml_tpu.cross_silo.journal import ServerJournal as RefJournal
    from fedml_tpu_torch.cross_silo.journal import ServerJournal

    return ServerJournal(str(tmp_path / "port"), keep=keep), RefJournal(str(tmp_path / "ref"),
                                                                        keep=keep)


def test_sidecars_read_across_packages(tmp_path):
    """Each package reads the other's step file: the same meta (its
    creation time aside) and arrays, bitwise."""
    import shutil

    port, ref = _journals(tmp_path)
    proto = {"session_epoch": 2, "round_idx": 5, "folded_keys": {"1": ["1:4:2:0"]},
             "stream_samples": {"1": 64.0}, "health": {}}
    arrays = {"stream_sum_0": np.arange(6, dtype=np.float32) / 3,
              "stream_sum_1": np.ones((2, 3), np.float32)}
    port.snapshot(5, proto, arrays, model_step=4)
    ref.snapshot(5, proto, arrays, model_step=4)
    shutil.copy(port._step_path(5), ref._step_path(6))
    shutil.copy(ref._step_path(5), port._step_path(6))
    for j in (port, ref):
        metas = [j._load_step(step) for step in (5, 6)]
        for meta, got in metas:
            assert meta["protocol"] == proto and meta["model_step"] == 4
            assert sorted(got) == sorted(arrays)
            for k in arrays:
                assert got[k].dtype == arrays[k].dtype and np.array_equal(got[k], arrays[k])
        (m5, _), (m6, _) = metas
        m5.pop("created_unix")
        m6.pop("created_unix")
        assert m5 == m6


def test_model_snapshot_roundtrip_and_corrupt_fallback(tmp_path):
    port, ref = _journals(tmp_path, keep=5)
    state = {"global_vars": {"params": {"w": torch.arange(6, dtype=torch.float32)}},
             "server_state": ()}
    for step in (1, 2, 3):
        st = {"global_vars": {"params": {"w": state["global_vars"]["params"]["w"] + step}},
              "server_state": ()}
        port.snapshot(step, {"round_idx": step}, {}, model_state=st)
        ref.snapshot(step, {"round_idx": step}, {})
    snap = port.restore()
    assert snap["step"] == 3 and snap["model_step"] == 3
    assert torch.equal(snap["model"]["global_vars"]["params"]["w"],
                       torch.arange(6, dtype=torch.float32) + 3)
    # a truncated newest sidecar, in both: discarded, the previous step served
    for j in (port, ref):
        blob = open(j._step_path(3), "rb").read()
        with open(j._step_path(3), "wb") as f:
            f.write(blob[:len(blob) // 2])
    assert port.restore()["step"] == ref.restore()["step"] == 2
    assert port.steps() == ref.steps() == [1, 2] and port.discarded == 1
    # an intact sidecar whose model checkpoint is damaged: falls back too
    with open(os.path.join(port.directory, "model", "round_2.pt"), "wb") as f:
        f.write(b"PK\x03\x04 not a checkpoint")
    snap = port.restore()
    assert snap["step"] == 1 and torch.equal(
        snap["model"]["global_vars"]["params"]["w"], torch.arange(6, dtype=torch.float32) + 1)
    # garbage and emptiness
    for j in _journals(tmp_path / "g"):
        assert j.restore() is None
        with open(j._step_path(7), "wb") as f:
            f.write(b"not a journal at all")
        assert j.restore() is None and j.steps() == []


def test_keep_prunes_and_midround_overwrites_like_the_reference(tmp_path):
    port, ref = _journals(tmp_path, keep=2)
    for j in (port, ref):
        for step in (1, 2, 3):
            j.snapshot(step, {"server_version": step}, arrays={})
        for folds in (1, 2, 3):
            j.snapshot(3, {"server_version": 3, "stream_folded": folds},
                       arrays={"stream_sum_0": np.ones(4, np.float32) * folds})
    assert port.steps() == ref.steps() == [2, 3]
    got, want = port.restore(), ref.restore()
    assert got["protocol"] == want["protocol"] and got["protocol"]["stream_folded"] == 3
    assert np.array_equal(got["arrays"]["stream_sum_0"], want["arrays"]["stream_sum_0"])


def test_journal_gates(tmp_path):
    import fedml_tpu_torch.arguments as args
    from fedml_tpu_torch.cross_silo.client_journal import client_journal_from_config
    from fedml_tpu_torch.cross_silo.journal import journal_from_config

    assert journal_from_config(args.Config()) is None and journal_from_config(None) is None
    assert client_journal_from_config(args.Config(), rank=1) is None
    j = journal_from_config(args.Config(extra={"server_journal_dir": str(tmp_path / "j")}))
    assert j is not None and j.keep == 3
    cj = client_journal_from_config(
        args.Config(extra={"client_journal_dir": str(tmp_path / "cj")}), rank=2)
    assert cj is not None and cj.rank == 2 and cj.keep == 2
    assert cj.directory == os.path.abspath(str(tmp_path / "cj" / "client_2"))


# -- ClientJournal --------------------------------------------------------------

def test_client_state_packs_like_the_reference(tmp_path):
    from fedml_tpu.cross_silo.client_journal import pack_client_state as ref_pack
    from fedml_tpu_torch.cross_silo.client_journal import (ClientJournal, pack_client_state,
                                                          unpack_client_state)

    res = [None, np.arange(8, dtype=np.float32), None, np.ones(4, np.float32) * 0.5]
    kw = dict(rank=3, round_idx=5, session_epoch=2, rounds_trained=6, server_restarts_seen=1,
              upload_attempts={"5:2": 2})
    proto, arrays = pack_client_state(
        residuals=[None if r is None else torch.from_numpy(r) for r in res], **kw)
    want_proto, want_arrays = ref_pack(residuals=res, **kw)
    assert proto == want_proto
    assert sorted(arrays) == sorted(want_arrays)
    assert all(np.array_equal(arrays[k], want_arrays[k]) for k in arrays)

    j = ClientJournal(str(tmp_path / "cj"), rank=3, keep=2)
    j.snapshot_state(proto, arrays)
    j.snapshot_state(proto, arrays)
    j2 = ClientJournal(str(tmp_path / "cj"), rank=3, keep=2)
    snap = j2.restore_state()
    assert snap["step"] == 2
    state = unpack_client_state(snap)
    assert (state["round_idx"], state["session_epoch"], state["rounds_trained"],
            state["server_restarts_seen"], state["upload_attempts"]) == (5, 2, 6, 1, {"5:2": 2})
    got = state["residuals"]
    assert got[0] is None and got[2] is None
    assert np.array_equal(got[1], res[1]) and np.array_equal(got[3], res[3])
    j2.snapshot_state(proto, arrays)
    assert j2.steps() == [2, 3]  # never rewinds, keep 2


def test_retired_client_dirs_pruned_like_the_reference(tmp_path):
    from fedml_tpu.cross_silo.client_journal import prune_retired_client_dirs as ref_prune
    from fedml_tpu_torch.cross_silo.client_journal import prune_retired_client_dirs

    for root in ("port", "ref"):
        for i, rank in enumerate((1, 2, 5, 6, 7, 9)):
            d = tmp_path / root / f"client_{rank}"
            d.mkdir(parents=True)
            f = d / "step_0000000001.journal"
            f.write_bytes(b"x")
            os.utime(f, (1000 + i, 1000 + i))
        (tmp_path / root / "other").mkdir()
    got = prune_retired_client_dirs(str(tmp_path / "port"), [1, 2], keep=2)
    want = ref_prune(str(tmp_path / "ref"), [1, 2], keep=2)
    assert sorted(got) == sorted(want) == [5, 6]
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "ref"))


# -- the plain server: dedup, epoch fence, mid-round journal ------------------------

def _servers(tmp_path, run_id, journal=True, **extra):
    """The reference's and the port's plain sync servers (LR, 4 clients, 2
    rounds, streaming fold), the port's global the reference's."""
    import fedml_tpu
    import fedml_tpu_torch
    from fedml_tpu.comm.inproc import InProcRouter as RefRouter
    from fedml_tpu.cross_silo import build_server as ref_build
    from fedml_tpu.data import loader as ref_loader
    from fedml_tpu.models import model_hub as ref_hub
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.comm.inproc import InProcRouter
    from fedml_tpu_torch.cross_silo import build_server
    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.models import model_hub

    def cfg_extra(tag):
        out = {"streaming_aggregation": True, **extra}
        if journal:
            out.update(server_journal_dir=str(tmp_path / tag / "j"), server_journal_every_folds=1)
        return out

    ref_cfg, _ = _pair_cfgs(run_id, client_num_in_total=4, client_num_per_round=4,
                            comm_round=2, extra=cfg_extra("ref"))
    _, cfg = _pair_cfgs(run_id, client_num_in_total=4, client_num_per_round=4, comm_round=2,
                        extra=cfg_extra("port"))
    fedml_tpu.init(ref_cfg)
    ds = ref_loader.load(ref_cfg)
    RefRouter.reset(run_id)
    ref = ref_build(ref_cfg, ds, ref_hub.create(ref_cfg, ds.class_num), backend="INPROC")
    base = jax.tree_util.tree_map(np.asarray, jax.device_get(ref.aggregator.global_vars))
    cfg = fedml_tpu_torch.init(cfg)
    pds = loader.load(cfg)
    pmodel = model_hub.create(cfg, pds.class_num, input_shape=pds.train_x.shape[1:])
    InProcRouter.reset(run_id)
    port = build_server(cfg, pds, pmodel, "cpu", backend="INPROC",
                        global_vars=weights.to_torch(weights.flax_to_torch(base)))
    for s in (ref, port):
        s.selected = [1, 2, 3, 4]
        s._init_sent = True
    return ref, port, base, (cfg, pds, pmodel)


def _upload(pkg, rank, params, rnd, key=None, epoch=None):
    if pkg == "ref":
        from fedml_tpu.comm.message import Message
    else:
        from fedml_tpu_torch.comm.message import Message
    m = Message(3, rank, 0)
    m.add_params("model_params", params)
    m.add_params("num_samples", 16.0 * rank)
    m.add_params("round_idx", int(rnd))
    if key is not None:
        m.add_params("upload_key", key)
    if epoch is not None:
        m.add_params("session_epoch", int(epoch))
    return Message.decode(m.encode())


def _scaled(base, cid):
    return jax.tree_util.tree_map(
        lambda a: (a * np.float32(1.0 + 0.01 * cid)).astype(a.dtype) if a.dtype.kind == "f"
        else a, base)


def _sidecar(j, step):
    meta, arrays = j._load_step(step)
    proto = {k: v for k, v in meta["protocol"].items() if k != "health"}
    return proto, arrays


def test_dedup_epoch_fence_and_midround_journal_match_the_reference(tmp_path):
    """The same keyed uploads, duplicates and a stale-epoch reply fed to both
    servers: the same dedup and stale counts, and round 1's mid-round
    sidecar after two folds is the reference's, protocol and partial sums
    bitwise; the port's finished global is the reference's, bitwise."""
    ref, port, base, _ = _servers(tmp_path, "journal_midround")
    for srv, pkg in ((ref, "ref"), (port, "port")):
        for cid in (1, 2, 3, 4):
            srv.handle_message_receive_model(
                _upload(pkg, cid, _scaled(base, cid), 0, key=f"{cid}:0:0:0", epoch=0))
            if cid == 2:  # a chaos duplicate
                srv.handle_message_receive_model(
                    _upload(pkg, cid, _scaled(base, cid), 0, key=f"{cid}:0:0:0", epoch=0))
        srv.selected = [1, 2, 3, 4]
        srv.handle_message_receive_model(_upload(pkg, 3, _scaled(base, 3), 1, epoch=7))
        for cid in (1, 2):
            srv.handle_message_receive_model(
                _upload(pkg, cid, _scaled(base, cid + 4), 1, key=f"{cid}:1:0:0", epoch=0))
    assert (port.deduped_uploads, port.rejected_stale) == (ref.deduped_uploads,
                                                           ref.rejected_stale) == (1, 1)
    assert port.round_idx == ref.round_idx == 1
    got, want = _sidecar(port.journal, 1), _sidecar(ref.journal, 1)
    assert got[0] == want[0] and got[0]["stream_folded"] == 2
    assert sorted(got[1]) == sorted(want[1])
    for k in got[1]:
        assert np.array_equal(got[1][k], want[1][k]), k
    for srv, pkg in ((ref, "ref"), (port, "port")):
        for cid in (3, 4):
            srv.handle_message_receive_model(
                _upload(pkg, cid, _scaled(base, cid + 4), 1, key=f"{cid}:1:0:0", epoch=0))
    assert port.done.is_set() and ref.done.is_set()
    from fedml_tpu_torch import weights

    want_g = jax.tree_util.tree_leaves(jax.device_get(ref.aggregator.global_vars))
    got_g = jax.tree_util.tree_leaves(
        weights.torch_to_flax(weights.to_numpy(port.aggregator.global_vars)))
    for a, b in zip(got_g, want_g):
        assert np.array_equal(a, np.asarray(b))
    ref.finish()
    port.finish()


def test_midround_crash_resumes_the_partial_fold_bitwise(tmp_path):
    """Round 1 killed after 2 of 4 folds (each journaled): the rebuilt
    server resumes mid-round under epoch 1 with the partial fold, does not
    ask the folded clients again, and ends bitwise at the uninterrupted
    run's global."""
    from fedml_tpu_torch.comm.inproc import InProcRouter
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.cross_silo import build_server
    from fedml_tpu_torch.cross_silo import message_define as md

    ref_srv, uninterrupted, base, _ = _servers(tmp_path / "u", "journal_u", journal=False)
    ref_srv.finish()
    ref_srv, srv_a, _, (cfg, ds, model) = _servers(tmp_path / "c", "journal_c")
    ref_srv.finish()
    for r in (0, 1):
        for cid in (1, 2, 3, 4):
            uninterrupted.handle_message_receive_model(
                _upload("port", cid, _scaled(base, cid + 4 * r), r))
            if r == 1 and cid == 2:
                continue
            if r == 0 or cid <= 2:
                srv_a.handle_message_receive_model(
                    _upload("port", cid, _scaled(base, cid + 4 * r), r, epoch=0))
        uninterrupted.selected = srv_a.selected = [1, 2, 3, 4]
    srv_a.handle_message_receive_model(_upload("port", 2, _scaled(base, 6), 1, epoch=0))
    assert srv_a.aggregator._stream_folded == 2
    srv_a.hard_kill()
    srv_b = build_server(cfg, ds, model, "cpu", backend="INPROC")
    assert (srv_b.round_idx, srv_b.session_epoch, srv_b.recovered_step) == (1, 1, 1)
    assert srv_b.aggregator._stream_folded == 2
    assert srv_b.aggregator.has_received(1) and not srv_b.aggregator.has_received(3)
    sent = []
    router = InProcRouter.get(cfg.run_id)
    route = router.route
    router.route = lambda msg, **kw: (sent.append((msg.get_type(), msg.get_receiver_id())),
                                      route(msg, **kw))
    srv_b.send_init_msg()
    assert sorted(r for t, r in sent if t == md.MSG_TYPE_S2C_INIT_CONFIG) == [3, 4]
    for cid in (3, 4):
        srv_b.handle_message_receive_model(_upload("port", cid, _scaled(base, cid + 4), 1,
                                                   epoch=1))
    assert srv_b.done.is_set() and uninterrupted.done.is_set()
    for a, b in zip(pt.tree_leaves(uninterrupted.aggregator.global_vars),
                    pt.tree_leaves(srv_b.aggregator.global_vars)):
        assert torch.equal(a, b)
    for s in (uninterrupted, srv_a, srv_b):
        s.finish()


def test_journals_refused_on_the_secure_servers(tmp_path):
    from fedml_tpu_torch.runner import FedMLRunner

    for method in ("shamir", "lightsecagg"):
        for flag in ("server_journal_dir", "client_journal_dir"):
            _, cfg = _pair_cfgs(f"secure_{flag}", client_num_in_total=4,
                                client_num_per_round=4, enable_secagg=True,
                                extra={"secagg_method": method, flag: str(tmp_path / "j")})
            with pytest.raises(NotImplementedError, match="plain synchronous"):
                FedMLRunner(cfg, device="cpu")


# -- crash drills over the fabric -------------------------------------------------

def _drill_cfg(tmp_path, tag, backend, clients=4, codec=None, rounds=3):
    import fedml_tpu_torch.arguments as args

    extra = {"server_journal_dir": str(tmp_path / tag / "s"), "tcp_base_port": 0,
             "client_journal_dir": str(tmp_path / tag / "c"), "comm_chunk_bytes": 1024}
    dp = dict(enable_dp=True, dp_solution_type="cdp", epsilon=50.0, delta=1e-5,
              sensitivity=0.01, clipping_norm=1.0)
    if codec:
        extra.update(comm_compression=codec, comm_compress_min_size=64)
        dp = {}
    return args.Config(training_type="cross_silo", role="server", backend=backend,
                       dataset="synthetic", model="lr", client_num_in_total=clients,
                       client_num_per_round=clients, comm_round=rounds, batch_size=16,
                       synthetic_train_size=64 * clients, synthetic_test_size=64,
                       random_seed=0, run_id=f"drill_{tag}_{backend}", extra=extra, **dp)


@pytest.mark.parametrize("backend,optimizer", [("INPROC", "FedAvg"), ("TCP", "FedAvg"),
                                               ("INPROC", "FedOpt")])
def test_server_and_client_crash_drill_ends_at_the_uninterrupted_global(tmp_path, backend,
                                                                         optimizer):
    """The server killed at its first dispatch of round 1 and rebuilt over
    its journal, then client 2 killed before round 2 and rebuilt over its
    journal: the same final global as the uninterrupted run, bit for bit
    (buffer-all CDP, chunk frames; FedOpt's server Adam state through the
    journal too)."""
    import fedml_tpu_torch
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.cross_silo.crash_drill import run_with_crashes
    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.models import model_hub

    out = {}
    for tag, kw in (("plain", {}), ("crash", dict(kill_server_before_round=1,
                                                   kill_client=(2, 2)))):
        cfg = _drill_cfg(tmp_path, tag, backend)
        cfg.federated_optimizer, cfg.server_optimizer = optimizer, "adam"
        cfg = fedml_tpu_torch.init(cfg)
        ds = loader.load(cfg)
        model = model_hub.create(cfg, ds.class_num, input_shape=ds.train_x.shape[1:])
        t0 = time.monotonic()
        out[tag] = run_with_crashes(cfg, ds, model, "cpu", backend=backend, timeout=60.0, **kw)
        assert time.monotonic() - t0 < 60.0
    crash = out["crash"]
    assert (crash["server_kills"], crash["client_kills"]) == (1, 1)
    assert [h["round"] for h in crash["history"]] == [0, 1, 2]
    assert crash["server"].session_epoch == 1 and crash["server"].recovered_step == 1
    assert [c.resumed_from_journal for c in crash["clients"]] == [False, True, False, False]
    assert all(c.server_restarts_seen == 1 for c in crash["clients"])
    for a, b in zip(pt.tree_leaves(out["plain"]["server"].aggregator.global_vars),
                    pt.tree_leaves(crash["server"].aggregator.global_vars)):
        assert torch.equal(a, b)
    if optimizer == "FedOpt":
        import jax

        states = [jax.tree_util.tree_leaves(out[t]["server"].aggregator.server_state)
                  for t in ("plain", "crash")]
        assert states[0] and all(torch.equal(a, b) for a, b in zip(*states))


def test_compressed_client_crash_resumes_its_residuals_bitwise(tmp_path):
    """One topk client (so the fold order is fixed), killed before round 2
    and rebuilt over its journal: its error-feedback residuals and the
    final global are bitwise the uncrashed twin's (the reference's
    ``run_client_crash_parity``)."""
    import fedml_tpu_torch
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.cross_silo.crash_drill import run_with_crashes
    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.models import model_hub

    out = {}
    for tag, kw in (("plain", {}), ("crash", dict(kill_client=(1, 2)))):
        cfg = fedml_tpu_torch.init(_drill_cfg(tmp_path, tag, "INPROC", clients=1, codec="topk"))
        ds = loader.load(cfg)
        model = model_hub.create(cfg, ds.class_num, input_shape=ds.train_x.shape[1:])
        out[tag] = run_with_crashes(cfg, ds, model, "cpu", timeout=60.0, **kw)
    plain, crash = out["plain"], out["crash"]
    assert crash["client_kills"] == 1 and crash["clients"][0].resumed_from_journal
    assert crash["server"].aggregator.stream_mode
    res_a, res_b = plain["clients"][0]._comm_residuals, crash["clients"][0]._comm_residuals
    assert sum(r is not None for r in res_a) > 0
    for a, b in zip(res_a, res_b):
        assert (a is None and b is None) or torch.equal(a, b)
    for a, b in zip(pt.tree_leaves(plain["server"].aggregator.global_vars),
                    pt.tree_leaves(crash["server"].aggregator.global_vars)):
        assert torch.equal(a, b)
