"""Port parity: the ledger backends, WEB3 and THETASTORE
(``fedml_tpu_torch/comm/blockchain.py``, ``web3_real.py``), and cross-silo
over them, against ``fedml_tpu/comm/`` on the CPU.

Tolerances:

- the blocks each package's manager appends for the same messages (height,
  sender, recipient, base64 data): bitwise; the web3 mailbox and the Theta
  EdgeStore ledgers against the reference's fakes (``tests/
  test_web3_real.py``): the same rows, transactions and store keys (a
  payload's key is a fresh ``uuid4`` in both and is compared by its form);
- a cross-silo run over each ledger (the LR, 2 silos, 2 rounds, the
  reference's initial weights and permutations): local SGD is not bitwise
  between XLA and PyTorch, so the globals are held to ``RUN_TOL`` = 2e-6 (a
  spread of 1.2e-7, measured on the LR), the test accuracy to 1e-6; the
  port's run over a ledger against its own INPROC run: bitwise.
"""

import base64
import json

import jax
import numpy as np
import pytest
import torch

from .conftest import tiny_config
from .test_web3_real import FakeEdgeStore, FakeWeb3Module, _FakeEth

torch.set_num_threads(1)

RUN_TOL = 2e-6


@pytest.fixture(autouse=True)
def _fresh_chain():
    FakeWeb3Module.last = None
    yield
    FakeWeb3Module.last = None


def _chain(pkg):
    if pkg == "ref":
        from fedml_tpu.comm import blockchain, web3_real
        from fedml_tpu.comm.message import Message
    else:
        from fedml_tpu_torch.comm import blockchain, web3_real
        from fedml_tpu_torch.comm.message import Message
    return blockchain, web3_real, Message


def _message(Message, sender, receiver, n):
    m = Message(3, sender, receiver)
    m.add_params("round_idx", 2)
    m.add_params("model_params", {"w": np.linspace(-1, 1, n, dtype=np.float32)})
    return m


def test_ledger_blocks_bitwise():
    """Three messages through each package's manager on its in-memory
    ledger: the same blocks; each recipient's poll loop hands its own
    messages to its inbox, decoded by the other package too."""
    blocks = {}
    for pkg in ("port", "ref"):
        blockchain, _, Message = _chain(pkg)
        blockchain.InMemoryLedger.reset(f"chain_{pkg}")
        a = blockchain.BlockchainCommManager(f"chain_{pkg}", 0, poll_interval_s=0.01)
        b = blockchain.BlockchainCommManager(f"chain_{pkg}", 1, poll_interval_s=0.01)
        try:
            for sender, receiver, n in ((0, 1, 5), (1, 0, 700), (0, 1, 3)):
                (a if sender == 0 else b).send_message(_message(Message, sender, receiver, n))
            got = [b._inbox.get(timeout=5) for _ in range(2)] + [a._inbox.get(timeout=5)]
        finally:
            a.stop_receive_message()
            b.stop_receive_message()
        chain = blockchain.InMemoryLedger.get(f"chain_{pkg}").read_since(0)
        blocks[pkg] = ([{k: v for k, v in blk.items() if k != "ts"} for blk in chain], got)
    assert blocks["port"][0] == blocks["ref"][0]
    assert [blk["height"] for blk in blocks["port"][0]] == [0, 1, 2]
    assert blocks["port"][1] == blocks["ref"][1]
    from fedml_tpu.comm.message import Message as RefMessage

    for blk in blocks["port"][0]:
        msg = RefMessage.decode(base64.b64decode(blk["data"]))
        assert (msg.get_sender_id(), msg.get_receiver_id()) == (blk["sender"], blk["recipient"])


@pytest.mark.parametrize("signed", [False, True], ids=["unlocked", "signed"])
def test_web3_ledger_like_the_reference(signed):
    """The mailbox contract through the reference's fake web3: the same
    heights, rows and transaction kinds from both packages."""
    out = {}
    for pkg in ("port", "ref"):
        FakeWeb3Module.last = None
        _, web3_real, _ = _chain(pkg)
        led = web3_real.Web3ContractLedger("http://node", "0xABC", account="0xme",
                                           private_key="0xkey" if signed else None,
                                           web3_module=FakeWeb3Module)
        heights = [led.append_tx(1, 2, "payloadA"), led.append_tx(1, 3, "payloadB")]
        out[pkg] = (heights, led.read_since(0), led.read_since(1),
                    list(FakeWeb3Module.last.transactions))
    assert out["port"] == out["ref"]
    assert out["port"][0] == [0, 1]
    assert out["port"][3][0][0] == ("signed" if signed else "unlocked")
    assert _chain("port")[1].MAILBOX_ABI == _chain("ref")[1].MAILBOX_ABI


def test_web3_reverted_tx_and_missing_package(monkeypatch):
    _, web3_real, _ = _chain("port")
    led = web3_real.Web3ContractLedger("http://node", "0xABC", account="0xme",
                                       web3_module=FakeWeb3Module)
    monkeypatch.setattr(_FakeEth, "wait_for_transaction_receipt",
                        lambda self, h: {"status": 0, "hash": h})
    with pytest.raises(RuntimeError, match="reverted"):
        led.append_tx(1, 2, "x")
    monkeypatch.setattr(web3_real, "_web3_module", lambda: None)
    with pytest.raises(ImportError, match="web3"):
        web3_real.Web3ContractLedger("http://node", "0xABC", account="0xme")


def test_theta_ledger_like_the_reference():
    """The EdgeStore ledger on the reference's fake store: the same rows,
    index and key forms from both packages; a client is required."""
    out = {}
    for pkg in ("port", "ref"):
        _, web3_real, _ = _chain(pkg)
        store = FakeEdgeStore()
        led = web3_real.ThetaEdgeStoreLedger("run7", http_client=store)
        heights = [led.append_tx(1, 2, "aaa"), led.append_tx(2, 1, "bbb")]
        index = json.loads(store.blobs["fedml_tpu/run7/ledger_index"].decode())
        for entry in index:
            prefix, tx = entry.pop("key").rsplit("/tx-", 1)
            assert prefix == "fedml_tpu/run7/ledger_index" and len(tx) == 32
        out[pkg] = (heights, [{k: v for k, v in r.items()} for r in led.read_since(0)],
                    led.read_since(1), index)
        with pytest.raises(ImportError):
            web3_real.ThetaEdgeStoreLedger("run7")
    assert out["port"] == out["ref"]
    assert out["port"][0] == [0, 1]


def test_theta_append_retries_on_clobbered_index():
    """A racer overwrites the index between the write and the re-read: the
    retry merges again after the racer's entry, in both packages."""
    out = {}
    for pkg in ("port", "ref"):
        _, web3_real, _ = _chain(pkg)

        class RacyStore(FakeEdgeStore):
            race_once = True

            def put(self, key, data):
                got = super().put(key, data)
                if key.endswith("ledger_index") and self.race_once:
                    self.race_once = False
                    self.blobs[key] = json.dumps([{"height": 0, "sender": 9, "recipient": 9,
                                                   "key": "other/tx"}]).encode()
                    self.blobs["other/tx"] = b"zzz"
                return got

        led = web3_real.ThetaEdgeStoreLedger("runR", http_client=RacyStore())
        out[pkg] = (led.append_tx(1, 2, "mine"),
                    [(r["sender"], r["data"]) for r in led.read_since(0)])
    assert out["port"] == out["ref"] == (1, [(9, "zzz"), (1, "mine")])


def test_manager_rides_the_theta_ledger():
    from fedml_tpu_torch.comm.blockchain import BlockchainCommManager
    from fedml_tpu_torch.comm.message import Message
    from fedml_tpu_torch.comm.web3_real import ThetaEdgeStoreLedger

    store = FakeEdgeStore()
    m1 = BlockchainCommManager("runE", 1, ledger=ThetaEdgeStoreLedger("runE", http_client=store),
                               poll_interval_s=0.02)
    m2 = BlockchainCommManager("runE", 2, ledger=ThetaEdgeStoreLedger("runE", http_client=store),
                               poll_interval_s=0.02)
    try:
        out = Message(3, sender_id=1, receiver_id=2)
        out.add_params("k", 2.5)
        m1.send_message(out)
        got = Message.decode(m2._inbox.get(timeout=5))
        assert got.get_type() == 3 and float(got.get("k")) == 2.5
        assert m1._inbox.empty()
    finally:
        m1.stop_receive_message()
        m2.stop_receive_message()


# -- cross-silo over the ledgers ----------------------------------------------------------

def _cfgs(run_id, **kw):
    import fedml_tpu_torch.arguments as args

    ref = tiny_config(training_type="cross_silo", client_num_in_total=2, client_num_per_round=2,
                      comm_round=2, learning_rate=0.3, frequency_of_the_test=1, run_id=run_id,
                      role="server", **kw)
    fields = {k: v for k, v in vars(ref).items() if k in args.Config.__dataclass_fields__}
    return ref, args.Config(**fields)


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


@pytest.mark.parametrize("backend", ["WEB3", "THETASTORE"])
def test_cross_silo_over_the_ledger_matches_the_reference(backend):
    """The reference's group over the backend (as its
    ``run_in_process_group(..., backend=...)`` builds it) and the port's:
    every message crossed the ledger as a block, the history and the global
    within the module docstring's tolerance, and the port's global bitwise
    its INPROC group's."""
    import fedml_tpu
    from fedml_tpu.comm.blockchain import InMemoryLedger as RefLedger
    from fedml_tpu.cross_silo import build_client, build_server
    from fedml_tpu.data import loader
    from fedml_tpu.models import model_hub
    from fedml_tpu_torch.comm.blockchain import BlockchainCommManager, InMemoryLedger

    ref_cfg, cfg = _cfgs(f"ledger_{backend}")
    fedml_tpu.init(ref_cfg)
    ds = loader.load(ref_cfg)
    model = model_hub.create(ref_cfg, ds.class_num)
    RefLedger.reset(ref_cfg.run_id)
    clients = [build_client(ref_cfg, ds, model, rank=r, backend=backend) for r in (1, 2)]
    for c in clients:
        c.run_in_thread()
    srv = build_server(ref_cfg, ds, model, backend=backend)
    init = jax.tree_util.tree_map(np.asarray, jax.device_get(srv.aggregator.global_vars))
    try:
        ref_hist = srv.run_until_done(timeout=60.0)
    finally:
        for c in clients:
            c.finish()
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(
        jax.device_get(srv.aggregator.global_vars))]
    hist, got, server = _port_group(cfg, backend, init)
    assert isinstance(server.com_manager, BlockchainCommManager)
    assert InMemoryLedger.get(cfg.run_id).read_since(0)
    assert RefLedger.get(ref_cfg.run_id).read_since(0)
    assert [h["round"] for h in hist] == [h["round"] for h in ref_hist] == [0, 1]
    np.testing.assert_allclose([h["test_acc"] for h in hist],
                               [h["test_acc"] for h in ref_hist], atol=1e-6)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=RUN_TOL)
    assert max(float(np.abs(b - s).max())
               for b, s in zip(want, jax.tree_util.tree_leaves(init))) > 1e-2
    _, cfg_in = _cfgs(f"ledger_{backend}_inproc")
    _, plain, _ = _port_group(cfg_in, "INPROC", init)
    assert all(np.array_equal(a, b) for a, b in zip(got, plain))


@pytest.mark.parametrize("backend,extra", [("WEB3", {}), ("THETASTORE", {}), ("MQTT_S3", {})])
@pytest.mark.parametrize("role", ["server", "client"])
def test_lone_role_over_a_one_process_fabric_refused(backend, extra, role):
    """``role: server`` or ``client`` alone over the in-memory ledger or the
    in-memory MQTT broker: the reference's lone server waits for silos that
    cannot reach it until its timeout (here 1 s of its 600), and the port
    raises ``ValueError`` naming that."""
    import fedml_tpu
    from fedml_tpu.cross_silo import build_server as ref_build_server
    from fedml_tpu.data import loader
    from fedml_tpu.models import model_hub
    from fedml_tpu_torch.cross_silo import ONE_PROCESS_FABRIC
    from fedml_tpu_torch.runner import FedMLRunner

    ref_cfg, cfg = _cfgs(f"lone_{backend}_{role}", backend=backend, extra=dict(extra))
    if role == "server":
        fedml_tpu.init(ref_cfg)
        ds = loader.load(ref_cfg)
        srv = ref_build_server(ref_cfg, ds, model_hub.create(ref_cfg, ds.class_num),
                               backend=backend)
        with pytest.raises(TimeoutError):
            srv.run_until_done(timeout=1.0)
    cfg.role, cfg.rank = role, 1
    with pytest.raises(ValueError) as e:
        FedMLRunner(cfg, device="cpu")
    assert ONE_PROCESS_FABRIC.split("{role!r}")[0] in str(e.value)
    assert "600 s timeout" in str(e.value)
