"""Port parity: the cross-silo streaming fold and compressed delta uploads
(``fedml_tpu_torch/parallel/stream_fold.py``, ``cross_silo/server.py``,
``cross_silo/client.py``) against ``fedml_tpu/cross_silo``.

Tolerances:

- the fold: the port's device accumulator (here on the CPU), fed the
  reference's encoded frames (raw full models, qsgd8 and topk deltas), is
  **bitwise** the reference aggregator's ``_aggregate_streaming``; the dense
  delta fallback is bitwise too (the same numpy add).
- end to end (INPROC, the MLP of ``mlp_hidden`` 512, 4 clients, 2 rounds,
  the reference's initial weights, permutations and upload draws handed
  in): local SGD is not bitwise between XLA and PyTorch (the uncompressed
  run's globals differ by at most 7.5e-8, measured; held to ``PLAIN_TOL`` =
  1e-6), so a qsgd8 level near a rounding boundary may move by one.  Round
  0's uploads agree on all but ``MOVED_SHARE`` = 0.5% of their int8 levels,
  none by more than 1 (the reference's interpret kernel adds its one-ulp
  scales, ``tests/test_torch_compression.py``).  Each global element is held
  to one quantisation step of its block a round (the largest of the
  clients' scales for that block; a moved level moves the weighted mean by
  at most that) plus ``PLAIN_TOL``; topk's to twice the k-th magnitude a
  round (an index swapped at the k-th place, and its carried residual) plus
  ``PLAIN_TOL``, with at most 1% of round 0's indices swapped.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from .conftest import tiny_config
from .test_torch_secagg import JaxPerms

torch.set_num_threads(1)

PLAIN_TOL = 1e-6
MOVED_SHARE = 5e-3


def _cfgs(run_id, extra, **kw):
    import fedml_tpu_torch.arguments as args

    ref_cfg = tiny_config(training_type="cross_silo", client_num_in_total=4,
                          client_num_per_round=4, run_id=run_id, role="server",
                          backend="INPROC", **kw)
    ref_cfg.extra = dict(extra)
    fields = {k: v for k, v in vars(ref_cfg).items() if k in args.Config.__dataclass_fields__}
    return ref_cfg, args.Config(**{**fields, "extra": dict(extra)})


def _aggregators(extra):
    """The reference's and the port's aggregators on a fused-free ResNet of
    one block a stage (conv kernels of 2304 elements), the port's global
    the reference's, carried across."""
    from fedml_tpu.cross_silo.server import FedMLAggregator as RefAggregator
    from fedml_tpu.models import resnet as flax_resnet
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.cross_silo.server import FedMLAggregator
    from fedml_tpu_torch.models import resnet

    ref_cfg, cfg = _cfgs("fold", extra)
    test = (np.zeros((32, 32, 32, 3), np.float32), np.zeros(32, np.int32), 32)
    ref = RefAggregator(ref_cfg, flax_resnet.CifarResNet(num_blocks=1),
                        np.zeros((8, 32, 32, 3), np.float32), test)
    base = jax.tree_util.tree_map(np.asarray, jax.device_get(ref.global_vars))
    port = FedMLAggregator(cfg, resnet.CifarResNet(1), test, "cpu",
                           global_vars=weights.to_torch(weights.flax_to_torch(base)))
    return ref, port, base


def _noise_tree(base, seed, scale):
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: (rs.randn(*a.shape) * scale).astype(a.dtype), base)


def _upload(params, n, is_delta, round_idx=0, sender=1):
    from fedml_tpu.comm.message import Message as RefMessage

    m = RefMessage(3, sender, 0)
    m.add_params("model_params", params)
    if is_delta:
        m.add_params("model_is_delta", True)
    m.add_params("num_samples", float(n))
    m.add_params("round_idx", round_idx)
    return m.encode()


def _frames(base, form):
    """``[(client, frame bytes, samples, is_delta)]`` as reference clients
    would send them: ``raw`` full models (v1), or deltas compressed by the
    reference's ``compress_pytree`` (qsgd8 / topk; small leaves raw)."""
    from fedml_tpu.comm import codecs as ref_codecs

    out = []
    for cid in (1, 2, 3, 4):
        n = 32 * cid
        if form == "raw":
            model = jax.tree_util.tree_map(lambda a, d: a + d, base,
                                           _noise_tree(base, cid, 0.05))
            out.append((cid, _upload(model, n, False, sender=cid), n, False))
            continue
        codec = form if form != "mixed" else ("qsgd8", "topk", "qsgd8", None)[cid - 1]
        delta = _noise_tree(base, cid, 0.02)
        if codec is None:  # a full model beside the deltas
            model = jax.tree_util.tree_map(lambda a, d: a + d, base, delta)
            out.append((cid, _upload(model, n, False, sender=cid), n, False))
            continue
        comp, _, _ = ref_codecs.compress_pytree(delta, codec, key=jax.random.PRNGKey(cid),
                                                ratio=0.05)
        out.append((cid, _upload(comp, n, True, sender=cid), n, True))
    return out


def _flax_global(agg):
    from fedml_tpu_torch import weights

    return weights.torch_to_flax(weights.to_numpy(agg.global_vars))


def _assert_trees_bitwise(got, want):
    got_l, want_l = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got_l) == len(want_l)
    for a, b in zip(got_l, want_l):
        assert a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("form", ["raw", "qsgd8", "topk", "mixed"])
def test_device_fold_bitwise_the_reference_fold(form):
    """Four replies (the fourth delivered twice) into both aggregators'
    ``ingest_streaming``, then ``aggregate``: the new global is bitwise the
    reference's; the duplicate is swallowed; at most 2 updates buffered."""
    from fedml_tpu.comm.message import Message as RefMessage
    from fedml_tpu_torch.comm.message import Message

    extra = {"streaming_aggregation": True} if form == "raw" else {"comm_compression": "qsgd8"}
    ref, port, base = _aggregators(extra)
    assert ref.stream_mode and port.stream_mode
    frames = _frames(base, form)
    for cid, data, n, is_delta in frames + frames[-1:]:
        assert ref.ingest_streaming(cid, RefMessage.decode(data), n, is_delta)
        assert port.ingest_streaming(cid, Message.decode(data), n, is_delta)
    assert port._stream_folded == ref._stream_folded == 4
    assert port._stream_w == ref._stream_w and port._stream_w_delta == ref._stream_w_delta
    assert port.peak_buffered_updates == ref.peak_buffered_updates == 2
    ref.aggregate(0)
    port.aggregate(0)
    want = jax.tree_util.tree_map(np.asarray, jax.device_get(ref.global_vars))
    _assert_trees_bitwise(_flax_global(port), want)
    assert not np.array_equal(jax.tree_util.tree_leaves(want)[-1],
                              jax.tree_util.tree_leaves(base)[-1])
    assert port._stream_acc is None and port._stream_tmpl is None
    assert set(port.round_metrics()) == {"fold_time_s", "finalize_time_s"}


def test_mismatched_frame_and_dense_delta_fall_back_as_the_reference(caplog):
    """A reply whose structure or shapes differ from the model's is refused
    by the fold (with a warning) on both sides; a delta on the dense buffer
    is added to the round's global as the reference adds it, bitwise."""
    from fedml_tpu.comm.message import Message as RefMessage
    from fedml_tpu_torch.comm.message import Message

    ref, port, base = _aggregators({"comm_compression": "qsgd8"})
    wrong_shape = jax.tree_util.tree_map(lambda a: a, base)
    wrong_shape["params"]["Dense_0"]["bias"] = np.zeros(11, np.float32)
    extra_leaf = {**base, "extra": {"x": np.zeros(3, np.float32)}}
    for tree in (wrong_shape, extra_leaf):
        data = _upload(tree, 8, False)
        with caplog.at_level(logging.WARNING):
            assert not ref.ingest_streaming(1, RefMessage.decode(data), 8.0, False)
            assert not port.ingest_streaming(1, Message.decode(data), 8.0, False)
    assert "buffering densely" in caplog.text
    assert port._stream_acc is None and not port.flag_client_model_uploaded

    delta = _noise_tree(base, 7, 0.02)
    msg, ref_msg = Message.decode(_upload(delta, 8, True)), RefMessage.decode(_upload(delta, 8, True))
    port.add_local_trained_result(2, msg.get("model_params"), 8.0, is_delta=True)
    ref.add_local_trained_result(2, ref_msg.get("model_params"), 8.0, is_delta=True)
    _assert_trees_bitwise(port.model_dict[2], jax.tree_util.tree_map(np.asarray,
                                                                     ref.model_dict[2]))
    assert port.peak_buffered_updates == ref.peak_buffered_updates == 1


def _capture_uploads(monkeypatch, cls, segments_of):
    """Wraps ``cls.ingest_streaming``: each folded reply's segments, copied,
    by sender in arrival order."""
    seen: dict = {}
    inner = cls.ingest_streaming

    def recording(self, client_idx, msg, sample_num, is_delta):
        folded = inner(self, client_idx, msg, sample_num, is_delta)
        if folded:
            _, segs = segments_of(msg)
            seen.setdefault(client_idx, []).append(
                [(spec, tuple(np.array(s) for s in parts)) for (_, spec, parts) in segs])
        return folded

    monkeypatch.setattr(cls, "ingest_streaming", recording)
    return seen


def _ref_segments(msg):
    from fedml_tpu_torch.comm import wire

    header, offset, blob = msg.tensor_stream()
    return header, wire.iter_leaf_segments(blob, header=header, offset=offset)


class JaxUploadNoise:
    """The reference client's codec draws: leaf ``i`` of rank ``k``'s round
    ``r`` upload from ``fold_in(fold_in(client_key(round_key(root, r), k),
    0x5157), i)``."""

    def __init__(self, seed):
        from fedml_tpu.core import rng

        self.root = rng.root_key(seed)

    def __call__(self, round_idx, rank, i, shape, device):
        from fedml_tpu.core import rng

        key = jax.random.fold_in(rng.client_key(rng.round_key(self.root, round_idx), rank),
                                 0x5157)
        u = jax.random.uniform(jax.random.fold_in(key, i), shape, jnp.float32)
        return torch.from_numpy(np.array(u)).to(device)


def _run_both(monkeypatch, codec, run_id):
    """The reference's INPROC group and the port's ``FedMLRunner`` on the
    same config; returns (ref history, ref global, port history, port
    group, initial global, ref uploads, port uploads)."""
    import fedml_tpu
    import fedml_tpu_torch
    from fedml_tpu.comm.inproc import InProcRouter
    from fedml_tpu.cross_silo import build_client, build_server
    from fedml_tpu.cross_silo import server as ref_server
    from fedml_tpu.data import loader
    from fedml_tpu.models import model_hub
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.cross_silo import server
    from fedml_tpu_torch.runner import FedMLRunner

    extra = {"mlp_hidden": 512, "silo_dp": False}
    if codec:
        extra["comm_compression"] = codec
    ref_cfg, cfg = _cfgs(run_id, extra, model="mlp", comm_round=2, learning_rate=0.3)
    ref_seen = _capture_uploads(monkeypatch, ref_server.FedMLAggregator, _ref_segments)
    seen = _capture_uploads(monkeypatch, server.FedMLAggregator,
                            lambda m: m.tensor_segments())
    fedml_tpu.init(ref_cfg)
    ds = loader.load(ref_cfg)
    model = model_hub.create(ref_cfg, ds.class_num)
    InProcRouter.reset(run_id)
    clients = [build_client(ref_cfg, ds, model, rank=r, backend="INPROC") for r in range(1, 5)]
    for c in clients:
        c.run_in_thread()
    srv = build_server(ref_cfg, ds, model, backend="INPROC")
    init = jax.tree_util.tree_map(np.asarray, jax.device_get(srv.aggregator.global_vars))
    try:
        ref_hist = srv.run_until_done(timeout=120.0)
    finally:
        for c in clients:
            c.finish()
    ref_global = jax.tree_util.tree_map(np.asarray, jax.device_get(srv.aggregator.global_vars))
    assert srv.aggregator.stream_mode == bool(codec)

    cfg = fedml_tpu_torch.init(cfg)
    runner = FedMLRunner(cfg, device="cpu")
    group = runner.runner
    group.global_vars = weights.to_torch(weights.flax_to_torch(init))
    group.perms = JaxPerms(cfg.random_seed)
    group.upload_noise = JaxUploadNoise(cfg.random_seed)
    hist = runner.run()
    return ref_hist, ref_global, hist, group, init, ref_seen, seen


@pytest.mark.parametrize("codec", ["qsgd8", "topk"])
def test_compressed_cross_silo_run_matches_the_reference(monkeypatch, codec):
    """Two INPROC rounds of 4 clients with compressed delta uploads, port
    against reference (module docstring's tolerances): round 0's uploads,
    the globals, test accuracy > 0.3 on both, qsgd8's ratio >= 3.5, peak
    buffered <= 2, the fold on the server."""
    from fedml_tpu_torch.comm import codecs

    before = codecs.payload_counters().get(codec, {"wire_bytes": 0, "raw_bytes": 0})
    ref_hist, ref_global, hist, group, init, ref_seen, seen = _run_both(
        monkeypatch, codec, f"e2e_{codec}")
    agg = group.server.aggregator
    assert agg.stream_mode and agg.peak_buffered_updates <= 2
    assert all(c.rounds_trained == 2 and c.comm_codec == codec for c in group.clients)
    assert [h["round"] for h in hist] == [0, 1] and len(ref_hist) == 2
    assert hist[-1]["test_acc"] > 0.3 and ref_hist[-1]["test_acc"] > 0.3
    after = codecs.payload_counters()[codec]
    wire_b, raw_b = (after["wire_bytes"] - before["wire_bytes"],
                     after["raw_bytes"] - before["raw_bytes"])
    assert wire_b == sum(c.last_upload_stats["wire_bytes"] for c in group.clients) * 2
    if codec == "qsgd8":
        assert raw_b / wire_b >= 3.5

    # round 0: the same global in, uploads nearly the same
    assert sorted(seen) == sorted(ref_seen) == [1, 2, 3, 4]
    moved = total = swapped = picked = 0
    for cid in seen:
        assert len(seen[cid]) == len(ref_seen[cid]) == 2
        for (spec, parts), (ref_spec, ref_parts) in zip(seen[cid][0], ref_seen[cid][0]):
            assert spec == ref_spec
            if spec["codec"] == "qsgd8":
                dv = np.abs(parts[1].astype(np.int16) - ref_parts[1])
                assert dv.max() <= 1
                moved, total = moved + int((dv > 0).sum()), total + dv.size
            elif spec["codec"] == "topk":
                swapped += len(set(ref_parts[0].tolist()) - set(parts[0].tolist()))
                picked += len(parts[0])
    if codec == "qsgd8":
        assert total and moved / total <= MOVED_SHARE, (moved, total)
    else:
        assert picked and swapped / picked <= 1e-2, (swapped, picked)

    # the globals: a step (qsgd8) or twice the k-th magnitude (topk) of
    # each element's block a round, plus the uncompressed tolerance
    from fedml_tpu_torch.comm import wire

    got = jax.tree_util.tree_leaves(_flax_global(agg))
    want = jax.tree_util.tree_leaves(ref_global)
    start = jax.tree_util.tree_leaves(init)
    for i, (a, b, s) in enumerate(zip(got, want, start)):
        assert a.shape == b.shape and a.dtype == b.dtype
        bound = np.full(b.size, PLAIN_TOL)
        for r in (0, 1):
            specs = [ref_seen[cid][r][i] for cid in ref_seen]
            if specs[0][0]["codec"] == "qsgd8":
                step = np.max([parts[0] for _, parts in specs], axis=0)
                bound += np.repeat(step, wire.QSGD8_BLOCK)[:b.size]
            elif specs[0][0]["codec"] == "topk":
                bound += 2 * max(np.abs(parts[1]).min() for _, parts in specs)
        assert (np.abs(a - b).reshape(-1) <= bound).all(), i
    assert max(np.abs(b - s).max() for b, s in zip(want, start)) > 1e-2  # training moved it


def test_compression_off_keeps_v1_uploads_and_the_dense_buffer(monkeypatch):
    """Without a codec the uploads are the trained models on v1 frames
    (no delta flag), the server buffers them (``stream_mode`` off), and the
    run matches the reference's within ``PLAIN_TOL``."""
    from fedml_tpu_torch.comm import message

    frames = []
    encode = message.Message.encode

    def recording(self):
        data = encode(self)
        if self.get_type() == 3:
            frames.append(data)
        return data

    monkeypatch.setattr(message.Message, "encode", recording)
    ref_hist, ref_global, hist, group, init, ref_seen, seen = _run_both(monkeypatch, None,
                                                                        "e2e_off")
    assert not group.server.aggregator.stream_mode and not seen and not ref_seen
    assert len(frames) == 8
    from fedml_tpu_torch.comm import wire

    for data in frames:
        msg = message.Message.decode(data)
        assert msg.get_control("model_is_delta") is None
        blob = data[4 + int.from_bytes(data[:4], "little"):]
        header, _ = wire.decode_header(blob)
        assert header["version"] == 1 and all("codec" not in s for s in header["leaves"])
        # the v1 bytes of the tree the frame carries
        assert bytes(blob) == wire.encode_pytree({"model_params": msg.get("model_params")})
    assert group.server.aggregator.peak_buffered_updates == 4
    for a, b in zip(jax.tree_util.tree_leaves(_flax_global(group.server.aggregator)),
                    jax.tree_util.tree_leaves(ref_global)):
        assert np.abs(a - b).max() <= PLAIN_TOL
    assert [h["test_acc"] for h in hist] == [h["test_acc"] for h in ref_hist]


def test_failing_codec_raises_where_the_reference_uploads_raw(monkeypatch):
    """A quantize kernel that fails fails the port's run, and no model
    reaches the server; the reference's ``_maybe_compress`` catches the same
    failure and returns the raw model (the divergence ROADMAP Queue 3
    states)."""
    import fedml_tpu_torch
    from fedml_tpu.cross_silo.client import ClientMasterManager as RefClient
    from fedml_tpu.ops.pallas import quantize as ref_q
    from fedml_tpu_torch.ops import quantize
    from fedml_tpu_torch.runner import FedMLRunner

    def broken(*args, **kw):
        raise RuntimeError("quantize_int8: CUDA launch failed with error 1")

    _, cfg = _cfgs("codec_fail", {"comm_compression": "qsgd8", "mlp_hidden": 64},
                   model="mlp", comm_round=1)
    monkeypatch.setattr(quantize, "quantize_int8_stochastic", broken)
    runner = FedMLRunner(fedml_tpu_torch.init(cfg), device="cpu")
    runner.runner.setup()
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        runner.run()
    assert runner.runner.server.aggregator.received_count() == 0
    assert runner.runner.server.history == []

    monkeypatch.setattr(ref_q, "quantize_int8_stochastic", broken)
    ref = RefClient.__new__(RefClient)
    ref.comm_codec, ref._comm_residuals, ref.rank = "qsgd8", None, 1
    ref._comm_ratio, ref._comm_min_elems = 0.01, 1024
    from fedml_tpu.core import rng

    ref.seed_key = rng.root_key(0)
    new = {"w": np.ones(2048, np.float32)}
    payload, is_delta = ref._maybe_compress(new, {"w": np.zeros(2048, np.float32)}, 0)
    assert payload is new and is_delta is False
