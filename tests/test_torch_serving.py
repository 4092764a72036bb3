"""The port's serving stack on the CPU (``fedml_tpu_torch/serving/``): the
predictor against the plain forward (bitwise), the worker's HTTP routes,
backpressure and streaming, the hot swap under load (a canary promoted, an
injected regression rolled back, no request dropped), the model-serving
platform and the servers' publication (artifacts bitwise the final global),
the deploy scheduler with replica processes on the CPU, the deploy protocol
over INPROC and TCP, and the gateway (two tenants, no bleed, 404, 503,
streaming).  The refusals are the reference's words.  Every wait is on an
event or a state the test can observe, never a sleep to let time pass;
ports are the system's picks and every replica runs on ``device="cpu"``.
"""

import dataclasses
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

FEATURES, CLASSES = 12, 5


def _wait(cond, timeout=60.0, what="condition"):
    """Block until ``cond()`` holds (polled), or fail naming ``what``."""
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.005)


def _lr_artifact(seed=0, nan=False):
    """A logistic regression's variables as an artifact tree (numpy, flax
    layout) from ``seed``."""
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.core import rng
    from fedml_tpu_torch.models import simple

    model = simple.LogisticRegression(num_classes=CLASSES, in_features=FEATURES)
    tree = weights.torch_to_flax(weights.to_numpy(model.init(rng.generator(
        rng.init_key(rng.root_key(seed))))))
    if nan:
        tree["params"]["Dense_0"]["kernel"][:] = np.nan
    return tree


def _post(port, body, headers=None, timeout=30):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json", **(headers or {})})
    return urllib.request.urlopen(req, timeout=timeout)


def _worker(**kw):
    from fedml_tpu_torch.serving.worker import ServingWorker

    kw.setdefault("params", _lr_artifact())
    kw.setdefault("feature_shape", (FEATURES,))
    worker = ServingWorker("lr", CLASSES, device="cpu", **kw)
    worker.start()
    return worker


def test_predictor_pads_matches_the_plain_forward_and_runs_in_any_thread():
    from fedml_tpu_torch.core import rng
    from fedml_tpu_torch.models import resnet
    from fedml_tpu_torch.serving.inference import TorchPredictor

    model = resnet.resnet20(10, torch.float32)
    variables = model.init(rng.generator(rng.init_key(rng.root_key(1))))
    x = np.random.RandomState(0).randn(3, 8, 8, 3).astype(np.float32)
    pred = TorchPredictor(model, variables, max_batch=4, feature_shape=(8, 8, 3), device="cpu")
    padded = torch.from_numpy(np.concatenate([x, np.zeros((1, 8, 8, 3), np.float32)]))
    with torch.no_grad():
        want = model.apply(variables, padded, train=False)[0][:3].numpy()
    np.testing.assert_array_equal(pred.predict_rows(x), want)
    out = {}
    thread = threading.Thread(target=lambda: out.update(rows=pred.predict_rows(x)))
    thread.start()
    thread.join(timeout=60)
    assert not thread.is_alive()
    np.testing.assert_array_equal(out["rows"], want)
    other = model.init(rng.generator(rng.init_key(rng.root_key(2))))
    clone = pred.clone_with(other)
    assert clone.model is pred.model and clone.max_batch == 4
    with torch.no_grad():
        np.testing.assert_array_equal(
            clone.predict_rows(x), model.apply(other, padded, train=False)[0][:3].numpy())
    clone.warm()
    with pytest.raises(ValueError, match="exceeds max_batch"):
        pred.predict_rows(np.zeros((5, 8, 8, 3), np.float32))
    with pytest.raises(NotImplementedError, match="item 10b"):
        TorchPredictor(model, variables, aot_store=object(), device="cpu")
    streamed = list(pred.predict_stream({"inputs": x.tolist()}))
    assert [c["index"] for c in streamed] == [0, 1, 2]


def test_worker_routes_stream_backpressure_and_refusals():
    worker = _worker(max_batch=4, max_queue=2, flush_ms=0.0)
    port = worker.runner.port
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/ready", timeout=30) as r:
            assert json.loads(r.read()) == {"status": "ready"}
        x = np.random.RandomState(3).randn(3, FEATURES).astype(np.float32)
        with _post(port, {"inputs": x.tolist()}) as r:
            body = json.loads(r.read())
        assert body["version"] == 0
        np.testing.assert_allclose(body["outputs"], worker.predictor.predict_rows(x), rtol=1e-6)
        with _post(port, {"inputs": x.tolist(), "stream": True}) as r:
            chunks = [json.loads(line) for line in r.read().decode().splitlines() if line]
        assert [c["index"] for c in chunks] == [0, 1, 2]
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(port, {"inputs": x.tolist()}, headers={"Accept": "image/png"})
        assert err.value.code == 400

        # backpressure: the dispatcher held inside a batch, the queue full
        gate, inside = threading.Event(), threading.Event()
        plain = worker.predictor.predict_rows

        def held(rows):
            inside.set()
            gate.wait(30)
            return plain(rows)

        worker.predictor.predict_rows = held
        codes = []

        def send():
            try:
                with _post(port, {"inputs": x[:1].tolist()}) as r:
                    codes.append(r.status)
            except urllib.error.HTTPError as e:
                codes.append(e.code)

        threads = [threading.Thread(target=send) for _ in range(3)]
        threads[0].start()
        inside.wait(30)
        for t in threads[1:]:
            t.start()
        _wait(lambda: worker.batcher.stats()["queue_depth"] == 2, what="a full queue")
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(port, {"inputs": x[:1].tolist()})
        assert err.value.code == 503 and int(err.value.headers["Retry-After"]) >= 1
        gate.set()
        for t in threads:
            t.join(timeout=30)
        assert codes == [200, 200, 200]
        assert worker.stats()["rejected"] == 1
    finally:
        worker.stop()
    from fedml_tpu_torch.serving.worker import ServingWorker

    for kw in ({"aot_dir": "/nowhere"}, {"flight_dir": "/nowhere"}):
        with pytest.raises(NotImplementedError, match="item 10b"):
            ServingWorker("lr", CLASSES, params=_lr_artifact(), device="cpu", **kw)


def test_hot_swap_under_load_promotes_and_rolls_back_without_dropping(tmp_path):
    from fedml_tpu_torch.serving.publisher import ModelPublisher

    pub = ModelPublisher(str(tmp_path / "pub"), keep=3)
    pub.publish(0, _lr_artifact(0))
    worker = _worker(params=None, publish_dir=str(tmp_path / "pub"), max_batch=4,
                     canary_fraction=0.5, canary_min_batches=2, poll_s=0.01, flush_ms=0.0)
    port, results, stop = worker.runner.port, [], threading.Event()
    x = np.random.RandomState(4).randn(2, FEATURES).astype(np.float32).tolist()

    def load():
        while not stop.is_set():
            try:
                with _post(port, {"inputs": x}) as r:
                    body = json.loads(r.read())
                results.append((r.status, body["version"], bool(np.isfinite(body["outputs"]).all())))
            except urllib.error.HTTPError as e:
                results.append((e.code, None, False))

    threads = [threading.Thread(target=load) for _ in range(3)]
    for t in threads:
        t.start()
    try:
        pub.publish(1, _lr_artifact(1))
        _wait(lambda: worker.swap.stats()["swaps"] == 1, what="the promotion of version 1")
        pub.publish(2, _lr_artifact(2, nan=True))
        _wait(lambda: worker.swap.stats()["rollbacks"] == 1, what="the rollback of version 2")
        n = len(results)
        _wait(lambda: len(results) > n + 3, what="requests after the rollback")
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        worker.stop()
    stats = worker.stats()
    assert stats["served_version"] == 1 and stats["rejected_versions"] == [2]
    assert results and all(code == 200 and finite for code, _v, finite in results)
    assert {v for _c, v, _f in results} <= {0, 1}
    assert sorted(os.listdir(tmp_path / "pub")) == [
        "MANIFEST.json", "params-v00000000.wire", "params-v00000001.wire",
        "params-v00000002.wire"]


def _serving_cfg(tmp_path, run_id, **extra):
    import fedml_tpu_torch
    from fedml_tpu_torch.arguments import Config

    return fedml_tpu_torch.init(Config(
        training_type="model_serving", role="server", backend="INPROC", dataset="synthetic",
        model="lr", client_num_in_total=2, client_num_per_round=2, comm_round=2, batch_size=16,
        synthetic_train_size=128, synthetic_test_size=32, frequency_of_the_test=1,
        compute_dtype="float32", run_id=run_id, data_cache_dir=str(tmp_path),
        extra={"model_publish_dir": str(tmp_path / run_id), **extra}))


def test_model_serving_platform_publishes_the_final_global_bitwise(tmp_path):
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.comm import wire
    from fedml_tpu_torch.runner import FedMLRunner
    from fedml_tpu_torch.serving.publisher import ManifestWatcher

    cfg = _serving_cfg(tmp_path, "serve_sync", model_publish_keep=2)
    runner = FedMLRunner(cfg, device="cpu")
    history = runner.run()
    assert len(history) == 2 and np.isfinite(history[-1]["test_loss"])
    got = ManifestWatcher(str(tmp_path / "serve_sync")).poll()
    assert got is not None and got[0] == 2 and got[2]["model"] == "lr"
    with open(got[1], "rb") as f:
        blob = f.read()
    final = weights.torch_to_flax(weights.to_numpy(runner.runner.server.server.aggregator
                                                   .global_vars))
    assert blob == wire.encode_pytree(final)
    assert sorted(os.listdir(tmp_path / "serve_sync")) == [
        "MANIFEST.json", "params-v00000001.wire", "params-v00000002.wire"]


def test_async_server_publishes_every_virtual_round(tmp_path):
    from fedml_tpu_torch.cross_silo import build_process_group, run_group
    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.models import model_hub
    from fedml_tpu_torch.serving.publisher import ManifestWatcher

    cfg = _serving_cfg(tmp_path, "serve_async", async_aggregation=True, async_buffer_k=1)
    cfg.training_type = "cross_silo"
    ds = loader.load(cfg)
    model = model_hub.create(cfg, ds.class_num, input_shape=ds.train_x.shape[1:])
    server, clients = build_process_group(cfg, ds, model, "cpu")
    history = run_group(server, clients, timeout=120)
    assert len(history) == 2
    got = ManifestWatcher(str(tmp_path / "serve_async")).poll()
    assert got is not None and got[0] == 2
    assert sorted(os.listdir(tmp_path / "serve_async"))[1:] == [
        f"params-v{v:08d}.wire" for v in range(3)]


def test_refusals_are_the_references(tmp_path):
    import fedml_tpu
    from fedml_tpu.runner import FedMLRunner as RefRunner
    from fedml_tpu.serving.federated import FedMLModelServingServer as RefServer
    from fedml_tpu_torch.runner import FedMLRunner

    for flag in ("enable_secagg", "enable_fhe"):
        cfg = _serving_cfg(tmp_path, f"refuse_{flag}")
        setattr(cfg, flag, True)
        ref_cfg = fedml_tpu.arguments.Config(**{
            f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
        with pytest.raises(NotImplementedError) as ref_err:
            RefRunner(ref_cfg)
        with pytest.raises(NotImplementedError) as err:
            FedMLRunner(cfg, device="cpu")
        assert str(err.value) == str(ref_err.value)
    cfg = _serving_cfg(tmp_path, "refuse_opt")
    cfg.federated_optimizer = "FedNova"
    with pytest.raises(ValueError) as ref_err:
        RefServer(cfg, "ep", "m")
    with pytest.raises(ValueError) as err:
        FedMLRunner(cfg, device="cpu")
    assert str(err.value) == str(ref_err.value)
    cfg = _serving_cfg(tmp_path, "refuse_metrics", metrics_port=0)
    with pytest.raises(NotImplementedError, match="item 10b"):
        FedMLRunner(cfg, device="cpu")


def _card(tmp_path, name="lr-card", params_path=None, **kw):
    from fedml_tpu_torch.comm import wire
    from fedml_tpu_torch.serving.deploy import ModelCard

    if params_path is None:
        params_path = str(tmp_path / f"{name}.wire")
        with open(params_path, "wb") as f:
            f.write(wire.encode_pytree(_lr_artifact()))
    return ModelCard(name=name, version="v1", model="lr", classes=CLASSES,
                     params_path=params_path, feature_dim=str(FEATURES), **kw)


def test_deploy_scheduler_runs_replica_processes_on_the_named_device(tmp_path):
    from fedml_tpu_torch.serving.deploy import ModelDeployScheduler

    sched = ModelDeployScheduler(str(tmp_path / "ep.db"), device="cpu")
    try:
        sched.cards.register(_card(tmp_path))
        sched.deploy("demo", "lr-card")
        assert sched.wait_ready("demo", timeout=120)
        x = np.random.RandomState(5).randn(2, FEATURES).tolist()
        out = sched.predict("demo", {"inputs": x})
        assert len(out["outputs"]) == 2 and len(out["outputs"][0]) == CLASSES
        chunks = list(sched.predict_stream("demo", {"inputs": x}))
        assert [c["index"] for c in chunks] == [0, 1]
        np.testing.assert_allclose([c["outputs"] for c in chunks], out["outputs"], rtol=1e-6)
        sched.reconcile_once()
        assert sched.db.endpoint("demo")["status"] == "READY"
        log = open(next(iter(sched.runtime._logs.values()))).read()
        assert "on cpu" in log
        # a replica that exits before it is ready fails the wait with its log
        sched.cards.register(_card(tmp_path, "broken", params_path=str(tmp_path / "none.wire")))
        sched.deploy("broken", "broken")
        with pytest.raises(RuntimeError, match="before it was ready(.|\n)*none.wire"):
            sched.wait_ready("broken", timeout=120)
    finally:
        sched.stop()
    assert sched.db.endpoint("demo")["status"] == "UNDEPLOYED"


class InProcessRuntime:
    """Replicas as in-process serving workers on the CPU (the runtime seam
    of ``ModelDeployScheduler``), so the protocol test starts no process."""

    def __init__(self):
        self.workers = []

    def start(self, card):
        from fedml_tpu_torch.serving.worker import ServingWorker

        worker = ServingWorker(card.model, card.classes, params_path=card.params_path,
                               feature_shape=(FEATURES,), device="cpu")
        worker.start()
        self.workers.append(worker)
        return worker, worker.runner.port

    def stop(self, handle):
        handle.stop()

    def poll(self, handle):
        return None

    def replica_id(self, handle):
        return id(handle) % 100000


@pytest.mark.parametrize("backend", ["INPROC", "TCP"])
def test_deploy_protocol_over_the_comm_plane(tmp_path, backend):
    import fedml_tpu_torch
    from fedml_tpu_torch.arguments import Config
    from fedml_tpu_torch.comm.comm_manager import reset_in_memory_fabric
    from fedml_tpu_torch.comm.tcp_backend import link_ports
    from fedml_tpu_torch.serving.deploy_protocol import DeployMasterManager, DeployWorkerManager

    run_id = f"deploy_{backend}"
    cfg = fedml_tpu_torch.init(Config(run_id=run_id, backend=backend,
                                      extra={"tcp_base_port": 0}))
    reset_in_memory_fabric(run_id)
    master = DeployMasterManager(cfg, backend=backend)
    workers = [DeployWorkerManager(cfg, rank=r, workdir=str(tmp_path), backend=backend,
                                   capacity=2, runtime=InProcessRuntime(), device="cpu")
               for r in (1, 2)]
    link_ports([master, *workers])
    master.run_in_thread()
    for w in workers:
        w.run_in_thread()
        w.start()
    try:
        master.wait_workers(2, timeout=30)
        card = _card(tmp_path)
        assert sum(master.deploy("demo", card, replicas=1).values()) == 1
        assert master.wait_ready("demo", replicas=1, timeout=60)
        placement = master.scale("demo", 3)
        assert sum(placement.values()) == 3 and len(placement) == 2
        assert master.wait_ready("demo", replicas=3, timeout=60)
        out = master.predict("demo", {"inputs": np.zeros((2, FEATURES)).tolist()})
        assert len(out["outputs"]) == 2 and len(out["outputs"][0]) == CLASSES
        with pytest.raises(RuntimeError, match="capacity exhausted"):
            master.deploy("too-big", card, replicas=99)
        master.undeploy("demo")
        _wait(lambda: not any(w.sched.endpoints for w in workers), what="the undeploy")
    finally:
        master.shutdown_workers()
        for w in workers:
            w.stop()
        master.finish()


def test_gateway_routes_two_tenants_without_bleed(tmp_path):
    from fedml_tpu_torch.core.flags import set_cfg_extra
    from fedml_tpu_torch.arguments import Config
    from fedml_tpu_torch.serving.gateway import ServingGateway, gateway_from_config

    wa = _worker(params=_lr_artifact(10))
    wb = _worker(params=_lr_artifact(11))
    gw = ServingGateway(max_batch=4, flush_ms=1.0, max_queue=4)
    port = gw.start()
    try:
        gw.add_tenant("a", port=wa.runner.port, card=_card(tmp_path, publish_dir="/pub/a"))
        gw.add_tenant("b", port=wb.runner.port)
        assert gw.lane_of("a").publish_dir == "/pub/a"
        x = np.random.RandomState(6).randn(3, FEATURES).astype(np.float32)
        outs = {}

        def ask(tenant, rows):
            code, body = gw.handle({"tenant": tenant, "inputs": rows.tolist()})
            outs.setdefault(tenant, []).append((code, body, rows))

        threads = [threading.Thread(target=ask, args=(t, x[i:i + 1]))
                   for t in ("a", "b") for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        for tenant, worker in (("a", wa), ("b", wb)):
            assert len(outs[tenant]) == 3
            for code, body, rows in outs[tenant]:
                assert code == 200 and body["tenant"] == tenant and body["version"] == 0
                np.testing.assert_allclose(body["outputs"], worker.predictor.predict_rows(rows),
                                           rtol=1e-6)
        assert gw.handle({"tenant": "c", "inputs": x.tolist()})[0] == 404
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(port, {"tenant": "c", "inputs": x.tolist()})
        assert err.value.code == 404
        with _post(port, {"tenant": "b", "inputs": x.tolist(), "stream": True}) as r:
            chunks = [json.loads(line) for line in r.read().decode().splitlines() if line]
        assert [(c["tenant"], c["index"]) for c in chunks] == [("b", 0), ("b", 1), ("b", 2)]
        # a full tenant queue: 503 with Retry-After over HTTP
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(port, {"tenant": "a", "inputs": np.zeros((5, FEATURES)).tolist()})
        assert err.value.code == 503 and int(err.value.headers["Retry-After"]) >= 1
    finally:
        gw.stop()
        wa.stop()
        wb.stop()
    cfg = Config()
    set_cfg_extra(cfg, "gateway_max_batch", 16)
    assert gateway_from_config(cfg, flush_ms=0.5).max_batch == 16
