"""Serving across the two packages.

- The reference's cross-silo server publishes (``extra.model_publish_dir``)
  and the port's publishes from the same initial global on the
  ``cross_silo_horizontal_lr`` recipe (f32, 4 silos, 1 round): the
  bootstrap artifacts are bitwise equal, the port's final artifact is
  bitwise the reference's wire encoding of the port's final global, and
  each package's ``ManifestWatcher`` reads the other's directory.
- The port's ``TorchPredictor`` serves the reference's published version
  (and a ResNet-20 artifact of the reference's init): its logits match the
  reference's ``JaxPredictor`` on the same artifact within ``LOGITS_RTOL`` /
  ``LOGITS_ATOL`` (ResNet-20: ``LOGITS_ATOL`` of max |logit|), f32 both:
  XLA's and PyTorch's CPU kernels sum in different orders.  Measured
  before the tolerance was set: 5.96e-07 against a max |logit| of 2.62
  (LR, 2 rounds) and 1.28e-03 against 2,981 (ResNet-20), 2.3e-07 and
  4.3e-07 of it.
- Host decisions are bitwise the reference's for the same observation
  sequence: ``HotSwapController`` routes, promotions and rollbacks,
  ``Autoscaler.desired``, ``EndpointDB`` rows and the batcher's coalescing.

Waits are on observable state; every model runs on the CPU.
"""

import dataclasses
import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

RECIPE = "examples/cross_silo_horizontal_lr/fedml_config.yaml"
ROUNDS = 1
LOGITS_RTOL, LOGITS_ATOL = 1e-5, 1e-5
MIXED_TOL = 1e-6


def _cfgs(run_id, pub_root):
    import fedml_tpu
    import fedml_tpu_torch

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), RECIPE)
    out = []
    for top, tag in ((fedml_tpu, "ref"), (fedml_tpu_torch, "port")):
        cfg = top.init(argv=["--cf", path])
        cfg.comm_round, cfg.compute_dtype, cfg.frequency_of_the_test = ROUNDS, "float32", 1
        cfg.run_id = f"{run_id}_{tag}"
        cfg.extra = dict(cfg.extra or {}, model_publish_dir=str(pub_root / tag))
        out.append(cfg)
    return out


def _runs(tmp_path):
    """The reference's run and the port's (from the reference's initial
    global), each publishing; returns ``(ref init, port final global, port
    dataset)``."""
    from fedml_tpu.comm.inproc import InProcRouter as RefRouter
    from fedml_tpu.cross_silo import build_aggregator, build_client as ref_client
    from fedml_tpu.cross_silo import build_server as ref_server
    from fedml_tpu.data import loader as ref_loader
    from fedml_tpu.models import model_hub as ref_hub
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.cross_silo import build_process_group, run_group
    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.models import model_hub

    from .test_torch_secagg import JaxPerms

    ref_cfg, cfg = _cfgs("serve_mixed", tmp_path)
    ref_ds = ref_loader.load(ref_cfg)
    ref_model = ref_hub.create(ref_cfg, ref_ds.class_num)
    init = jax.tree_util.tree_map(np.asarray, jax.device_get(
        build_aggregator(ref_cfg, ref_ds, ref_model).global_vars))
    RefRouter.reset(ref_cfg.run_id)
    clients = [ref_client(ref_cfg, ref_ds, ref_model, rank=r) for r in range(1, 5)]
    srv = ref_server(ref_cfg, ref_ds, ref_model)
    for c in clients:
        c.run_in_thread()
    try:
        ref_hist = srv.run_until_done(timeout=120.0)
    finally:
        for c in clients:
            c.finish()
        srv.finish()
    assert len(ref_hist) == ROUNDS

    ds = loader.load(cfg)
    model = model_hub.create(cfg, ds.class_num, input_shape=ds.train_x.shape[1:])
    server, port_clients = build_process_group(
        cfg, ds, model, "cpu", global_vars=weights.to_torch(weights.flax_to_torch(init)),
        perms=JaxPerms(cfg.random_seed))
    hist = run_group(server, port_clients, timeout=120.0)
    assert len(hist) == ROUNDS
    final = weights.torch_to_flax(weights.to_numpy(server.aggregator.global_vars))
    return init, final, ds


def test_publications_are_read_across_packages_and_served_alike(tmp_path):
    from fedml_tpu.arguments import Config as RefConfig
    from fedml_tpu.comm import wire as ref_wire
    from fedml_tpu.models import model_hub as ref_hub
    from fedml_tpu.serving.inference import JaxPredictor
    from fedml_tpu.serving.publisher import ManifestWatcher as RefWatcher
    from fedml_tpu_torch.serving.inference import TorchPredictor
    from fedml_tpu_torch.serving.publisher import ManifestWatcher
    from fedml_tpu_torch.serving.worker import build_model, load_params, port_variables

    init, final, ds = _runs(tmp_path)
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    for v in range(ROUNDS + 1):
        assert (ref_dir / f"params-v{v:08d}.wire").exists()
        assert (port_dir / f"params-v{v:08d}.wire").exists()
    # the bootstrap publication of the same global: bitwise the reference's
    v0 = (ref_dir / "params-v00000000.wire").read_bytes()
    assert (port_dir / "params-v00000000.wire").read_bytes() == v0 == ref_wire.encode_pytree(init)

    # the reference's watcher reads the port's directory: the final artifact
    # is the reference's own encoding of the port's final global
    got = RefWatcher(str(port_dir)).poll()
    assert got is not None and got[0] == ROUNDS
    with open(got[1], "rb") as f:
        assert f.read() == ref_wire.encode_pytree(final)
    assert set(got[2]) == set(RefWatcher(str(ref_dir)).read_manifest())

    # the port's watcher and predictor serve the reference's version
    got = ManifestWatcher(str(ref_dir)).poll()
    assert got is not None and got[0] == ROUNDS
    artifact = load_params(got[1])
    for a, b in zip(jax.tree_util.tree_leaves(artifact), jax.tree_util.tree_leaves(final)):
        np.testing.assert_allclose(a, b, rtol=0, atol=MIXED_TOL)
    feat = (int(ds.train_x.shape[1]),)
    x = np.random.RandomState(0).randn(5, *feat).astype(np.float32)
    ref_model = ref_hub.create(RefConfig(model="lr", dataset="synthetic",
                                         compute_dtype="float32"), ds.class_num)
    want = JaxPredictor(ref_model, artifact, max_batch=8, feature_shape=feat).predict_rows(x)
    port = TorchPredictor(build_model("lr", ds.class_num, feat), port_variables(artifact),
                          max_batch=8, feature_shape=feat, device="cpu")
    np.testing.assert_allclose(port.predict_rows(x), np.asarray(want, np.float32),
                               rtol=LOGITS_RTOL, atol=LOGITS_ATOL)


def test_resnet20_artifact_served_alike():
    """A ResNet-20 artifact (the reference's init, f32): the port's
    predictor against the reference's, the conv layouts relaid from the
    artifact's flax layout."""
    import jax.numpy as jnp

    from fedml_tpu.arguments import Config as RefConfig
    from fedml_tpu.models import model_hub as ref_hub
    from fedml_tpu.serving.inference import JaxPredictor
    from fedml_tpu_torch.arguments import Config
    from fedml_tpu_torch.models import model_hub
    from fedml_tpu_torch.serving.inference import TorchPredictor
    from fedml_tpu_torch.serving.worker import port_variables

    ref_model = ref_hub.create(RefConfig(model="resnet20", dataset="synthetic",
                                         compute_dtype="float32"), 10)
    artifact = jax.tree_util.tree_map(np.asarray, ref_model.init(
        {"params": jax.random.PRNGKey(3)}, jnp.zeros((1, 32, 32, 3)), train=True))
    # every leaf moved off its init (the Dense layer starts at zero), the
    # BN variances positive: the eval path's moments matter
    rs = np.random.RandomState(1)
    artifact = jax.tree_util.tree_map_with_path(
        lambda p, a: (a + 0.1 * rs.randn(*a.shape).astype(np.float32)
                      if "var" not in jax.tree_util.keystr(p)
                      else 0.5 + rs.rand(*a.shape).astype(np.float32)), artifact)
    x = rs.randn(4, 32, 32, 3).astype(np.float32)
    want = JaxPredictor(ref_model, artifact, max_batch=4,
                        feature_shape=(32, 32, 3)).predict_rows(x)
    model = model_hub.create(Config(model="resnet20", dataset="synthetic",
                                    compute_dtype="float32"), 10)
    got = TorchPredictor(model, port_variables(artifact), max_batch=4,
                         feature_shape=(32, 32, 3), device="cpu").predict_rows(x)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=LOGITS_RTOL, atol=LOGITS_ATOL * scale)


class _Stub:
    def __init__(self, value, nan=False, fail=False):
        self.value, self.nan, self.fail = value, nan, fail

    def predict_rows(self, x):
        if self.fail:
            raise RuntimeError("injected")
        x = np.asarray(x)
        return np.full((x.shape[0], 3), np.nan if self.nan else self.value, np.float32)


def _controller_trace(mod, seed):
    """One observation sequence through ``mod``'s HotSwapController: the
    routes and the state after each step."""
    rs = np.random.RandomState(seed)
    eval_x = rs.randn(6, 3).astype(np.float32)
    eval_y = rs.randint(0, 3, size=6)
    ctl = mod.HotSwapController(_Stub(0.0), version=0, canary_fraction=0.34,
                                canary_min_batches=3, eval_batch=(eval_x, eval_y))
    trace = []
    for step in range(120):
        if step % 15 == 0:
            version = step // 15 + 1
            pred = _Stub(float(version), nan=rs.rand() < 0.3, fail=rs.rand() < 0.2)
            trace.append(("wants", version, ctl.wants_version(version)))
            ctl.offer(version, pred)
        pred, version, canary = ctl.route()
        ok = not getattr(pred, "fail", False)
        lat = float(rs.choice([0.01, 0.02, 0.2]))
        fallback = canary and (not ok or getattr(pred, "nan", False))
        ctl.observe_batch(version, ok, lat, canary, fallback)
        trace.append((version, canary, json_state(ctl.stats())))
    return trace


def json_state(stats):
    return tuple(sorted((k, tuple(v) if isinstance(v, list) else v) for k, v in stats.items()))


@pytest.mark.parametrize("seed", range(4))
def test_hot_swap_decisions_are_the_references(seed):
    from fedml_tpu.serving import publisher as ref
    from fedml_tpu_torch.serving import publisher as port

    want, got = _controller_trace(ref, seed), _controller_trace(port, seed)
    assert got == want
    assert any(s[2] and dict(s[2])["rollbacks"] for s in got if len(s) == 3 and s[0] != "wants")


def test_autoscaler_and_endpoint_db_are_the_references(tmp_path):
    from fedml_tpu.serving import deploy as ref
    from fedml_tpu_torch.serving import deploy as port

    rs = np.random.RandomState(7)
    seq = [(int(rs.randint(1, 5)), float(rs.exponential(60)), float(rs.randint(0, 20)),
            float(t * 7.0)) for t in range(60)]
    for policy in ("ewm", "concurrency"):
        out = []
        for mod in (ref, port):
            a = mod.Autoscaler(mod.AutoscalePolicy(policy=policy, scaledown_delay_s=20.0))
            out.append([a.desired(c, q, k, now=t) for c, q, k, t in seq])
        assert out[0] == out[1]
    rows = []
    for mod, tag in ((ref, "ref"), (port, "port")):
        db = mod.EndpointDB(str(tmp_path / f"{tag}.db"))
        db.upsert_endpoint("ep", "lr", "v1", 2, "DEPLOYING")
        db.upsert_replica("ep", 0, 100, 5000, "STARTING")
        db.upsert_replica("ep", 1, 101, 5001, "STARTING")
        db.upsert_replica("ep", 0, 102, 5002, "RESTARTING")
        db.set_desired("ep", 3)
        db.upsert_stats("ep", 17, 3.5, 12.25, 2)
        db.delete_replica("ep", 1)
        stats = db.stats("ep")
        stats.pop("updated")
        rows.append((db.endpoint("ep"), db.replicas("ep"), stats, db.endpoint("none")))
    assert rows[0] == rows[1]


def _coalescing(mod, sizes):
    """The batches ``mod``'s MicroBatcher forms from ``sizes`` queued while
    its dispatcher is held inside a first one-row batch."""
    gate, inside, seen = threading.Event(), threading.Event(), []

    class Held:
        max_batch = 8

        def predict_rows(self, x):
            seen.append(int(np.asarray(x).shape[0]))
            inside.set()
            gate.wait(30)
            return np.zeros((np.asarray(x).shape[0], 2), np.float32)

    b = mod.MicroBatcher(Held(), max_batch=8, max_queue=64, flush_ms=0.0)
    try:
        first = b.submit(np.zeros((1, 4)))
        assert inside.wait(30)
        reqs = [b.submit(np.zeros((n, 4))) for n in sizes]
        deadline = time.monotonic() + 30
        while b.stats()["queue_depth"] != len(sizes) and time.monotonic() < deadline:
            time.sleep(0.005)
        gate.set()
        outs = [r.wait(30) for r in [first] + reqs]
    finally:
        gate.set()
        b.stop()
    return seen, [o.shape for o in outs], b.stats()["completed"]


@pytest.mark.parametrize("seed", range(3))
def test_batcher_coalescing_is_the_references(seed):
    from fedml_tpu.serving import batcher as ref
    from fedml_tpu_torch.serving import batcher as port

    sizes = [int(n) for n in np.random.RandomState(seed).randint(1, 9, size=12)]
    assert _coalescing(port, sizes) == _coalescing(ref, sizes)
    hist_ref = ref.REQUEST_TIME
    hist = port.REQUEST_TIME
    assert (hist.name, hist.buckets) == (hist_ref.name, hist_ref.buckets)
    assert port.percentile_from_histogram(hist, 0.5) is not None


def test_model_card_fields_are_the_references():
    from fedml_tpu.serving.deploy import ModelCard as RefCard
    from fedml_tpu_torch.serving.deploy import ModelCard

    assert [f.name for f in dataclasses.fields(ModelCard)] == [
        f.name for f in dataclasses.fields(RefCard)]
