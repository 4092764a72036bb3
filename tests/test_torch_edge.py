"""Port parity: the hierarchical aggregation tree (``fedml_tpu_torch/
cross_silo/edge.py``, the root's side in ``cross_silo/server.py``, the
client's upload destination, the edges of the in-process group and
``async_soak.run_edge_kill_soak``) against ``fedml_tpu/cross_silo/edge.py``
on the CPU.

Tolerances:

- topology, dispatch plans, validation errors and the fold gate: equal;
- the edge fold: an :class:`EdgePartialFold` fed the reference's encoded
  frames (raw and qsgd8) is bitwise the reference's partial; the full 2x2
  tree on exactly representable payloads and the prefix tree under a fixed
  arrival order fold bitwise the flat fold; the simulator's group sums are
  bitwise the edge fold;
- the edge kill soak: the kill leg bitwise the clean leg, ``unaccounted``
  0, peak buffered <= 2; its flat leg bitwise the reference's (the
  reference's initial weights carried across); the root-ingress ratio >= 4
  at fanout 8 with qsgd8 on both hops;
- tree runs with real clients: within 0.05 test accuracy of the flat run
  (the reference test's bound) and within ``RUN_TOL`` of the reference's
  tree run (local SGD is not bitwise between XLA and PyTorch, and the root
  folds two edges' partials in arrival order).
"""

import jax
import numpy as np
import pytest
import torch

from .conftest import tiny_config
from .test_torch_secagg import JaxPerms

torch.set_num_threads(1)

RUN_TOL = 2e-6


def _pair(run_id, **kw):
    """The reference's and the port's configs of one run."""
    import fedml_tpu_torch.arguments as args

    base = dict(training_type="cross_silo", client_num_in_total=4, client_num_per_round=4,
                comm_round=2, learning_rate=0.3, frequency_of_the_test=1, run_id=run_id,
                role="server", backend="INPROC")
    base.update(kw)
    ref_cfg = tiny_config(**base)
    fields = {k: v for k, v in vars(ref_cfg).items() if k in args.Config.__dataclass_fields__}
    return ref_cfg, args.Config(**{**fields, "extra": dict(ref_cfg.extra)})


def _msg(pkg, rank, params, n, round_idx=0):
    """A model reply encoded by the reference, decoded by ``pkg``'s message
    class (tensors still undecoded): the same bytes for both packages."""
    from fedml_tpu.comm.message import Message as RefMessage

    if pkg == "ref":
        Message = RefMessage
    else:
        from fedml_tpu_torch.comm.message import Message
    m = RefMessage(3, rank, 0)
    m.add_params("model_params", params)
    m.add_params("num_samples", float(n))
    m.add_params("round_idx", round_idx)
    return Message.decode(m.encode())


# -- topology -----------------------------------------------------------------------

TOPOLOGIES = {
    "fanout3_of5": dict(client_num_in_total=5, extra={"hier_fanout": 3}),
    "depth3": dict(client_num_in_total=8, extra={"hier_fanout": 2, "hier_depth": 3}),
    "explicit": dict(client_num_in_total=6, extra={"hier_topology": {
        "edges": [[1, 4], [2, 5, 6], [3]], "regions": [[0, 2], [1]]}}),
    "flat": dict(extra={}),
}


@pytest.mark.parametrize("case", sorted(TOPOLOGIES))
def test_topology_and_dispatch_plan_match_the_reference(case):
    from fedml_tpu.cross_silo.edge import build_topology as ref_build
    from fedml_tpu_torch.cross_silo.edge import build_topology

    ref_cfg, cfg = _pair(f"topo_{case}", **TOPOLOGIES[case])
    ref, port = ref_build(ref_cfg), build_topology(cfg)
    if ref is None:
        assert port is None
        return
    for attr in ("edge_ranks", "region_ranks", "children_of", "parent_of", "aggregator_ranks",
                 "root_children", "depth", "world_size", "n_clients"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    assert np.array_equal(port.group_of, ref.group_of) and port.group_of.dtype == np.int32
    assert port.max_fanout() == ref.max_fanout()
    n = cfg.client_num_in_total
    for rank in range(0, port.world_size + 2):
        assert port.parent(rank) == ref.parent(rank)
    selected = list(range(1, n + 1))
    for skip in ((), (1,), (1, n)):
        assert port.dispatch_plan(selected, skip=skip) == ref.dispatch_plan(selected, skip=skip)


def _cfg_of(mod, **extra):
    """The config of ``mod``'s package (the reference's or the port's)."""
    ref_cfg, cfg = _pair("bad_cfg", extra=extra)
    return cfg if mod.__name__.startswith("fedml_tpu_torch") else ref_cfg


INVALID = {
    "unassigned": lambda m: m.HierTopology(3, [[1, 2]]),
    "twice": lambda m: m.HierTopology(3, [[1, 2], [2, 3]]),
    "empty_edge": lambda m: m.HierTopology(2, [[1, 2], []]),
    "bad_region": lambda m: m.HierTopology(2, [[1], [2]], regions=[[0, 5]]),
    "depth4": lambda m: m.build_topology(_cfg_of(m, hier_fanout=2, hier_depth=4)),
    "hop_codec": lambda m: m.hop_codec_from_config(_cfg_of(m, hier_hop_codec="gzip")),
}


@pytest.mark.parametrize("case", sorted(INVALID))
def test_topology_validation_errors_match_the_reference(case):
    import fedml_tpu.cross_silo.edge as ref_edge
    import fedml_tpu_torch.cross_silo.edge as edge

    with pytest.raises(ValueError) as want:
        INVALID[case](ref_edge)
    with pytest.raises(ValueError) as got:
        INVALID[case](edge)
    assert str(got.value) == str(want.value)


def test_hop_codec_names_match_the_reference():
    from fedml_tpu.cross_silo.edge import hop_codec_from_config as ref_codec
    from fedml_tpu_torch.cross_silo.edge import hop_codec_from_config

    for name in (None, "", "raw", "none", "QSGD8", "topk"):
        ref_cfg, cfg = _pair("hop_names", extra={} if name is None else {"hier_hop_codec": name})
        assert hop_codec_from_config(cfg) == ref_codec(ref_cfg)


def test_hier_secure_and_async_gates(tmp_path):
    """The tree refuses the secure protocols (both packages, "secure-") and
    the async server ("synchronous-only", as the reference's
    ``test_hier_secagg_and_async_gates``); a server or silo process of its
    own refuses it too (the reference starts edges only in its group)."""
    from fedml_tpu.cross_silo.edge import build_topology as ref_build
    from fedml_tpu_torch.cross_silo.edge import build_topology
    from fedml_tpu_torch.runner import FedMLRunner

    for flag in ("enable_secagg", "enable_fhe"):
        ref_cfg, cfg = _pair("hier_secure", extra={"hier_fanout": 2}, **{flag: True})
        with pytest.raises(NotImplementedError, match="secure-"):
            ref_build(ref_cfg)
        with pytest.raises(NotImplementedError, match="secure-"):
            build_topology(cfg)
        with pytest.raises(NotImplementedError, match="secure-"):
            FedMLRunner(cfg, device="cpu")
    _, cfg = _pair("hier_async", extra={"hier_fanout": 2, "async_aggregation": True,
                                        "async_buffer_k": 2})
    with pytest.raises(NotImplementedError, match="synchronous-only"):
        FedMLRunner(cfg, device="cpu")
    import fedml_tpu_torch
    from fedml_tpu_torch.cross_silo import build_server
    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.models import model_hub

    cfg = fedml_tpu_torch.init(cfg)
    ds = loader.load(cfg)
    model = model_hub.create(cfg, ds.class_num, input_shape=ds.train_x.shape[1:])
    with pytest.raises(NotImplementedError, match="synchronous-only"):
        build_server(cfg, ds, model, "cpu", backend="INPROC")
    for role, rank in (("server", 0), ("client", 1)):
        _, cfg = _pair("hier_role", role=role, rank=rank, backend="TCP",
                       extra={"hier_fanout": 2, "tcp_base_port": 39000})
        with pytest.raises(ValueError, match="in-process group alone"):
            FedMLRunner(cfg, device="cpu")


@pytest.mark.parametrize("extra", [{}, {"streaming_aggregation": True},
                                   {"comm_compression": "qsgd8"}, {"comm_compression": "topk"},
                                   {"streaming_aggregation": True, "enable_dp": True}],
                         ids=["none", "streaming", "qsgd8", "topk", "cdp"])
def test_edge_fold_supported_matches_the_reference(extra):
    from fedml_tpu.cross_silo.edge import edge_fold_supported as ref_supported
    from fedml_tpu_torch.cross_silo.edge import edge_fold_supported

    extra = dict(extra)
    kw = {}
    if extra.pop("enable_dp", False):
        kw = dict(enable_dp=True, dp_solution_type="cdp", epsilon=50.0, delta=1e-5,
                  sensitivity=0.01, clipping_norm=1.0)
    ref_cfg, cfg = _pair("fold_gate", extra=extra, **kw)
    assert edge_fold_supported(cfg) == ref_supported(ref_cfg)


# -- the edge fold -------------------------------------------------------------------

def _base_and_aggregators(run_id):
    """The reference's LR aggregator's initial global (flax, numpy) and a
    port aggregator over it, streaming."""
    import fedml_tpu
    import fedml_tpu_torch
    from fedml_tpu.cross_silo import build_aggregator as ref_build
    from fedml_tpu.data import loader as ref_loader
    from fedml_tpu.models import model_hub as ref_hub
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.cross_silo import build_aggregator
    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.models import model_hub

    ref_cfg, cfg = _pair(run_id, extra={"streaming_aggregation": True})
    fedml_tpu.init(ref_cfg)
    rds = ref_loader.load(ref_cfg)
    ref_agg = ref_build(ref_cfg, rds, ref_hub.create(ref_cfg, rds.class_num))
    base = jax.tree_util.tree_map(np.asarray, jax.device_get(ref_agg.global_vars))
    cfg = fedml_tpu_torch.init(cfg)
    ds = loader.load(cfg)
    model = model_hub.create(cfg, ds.class_num, input_shape=ds.train_x.shape[1:])

    def port_agg():
        agg = build_aggregator(cfg, ds, model, "cpu",
                               global_vars=weights.to_torch(weights.flax_to_torch(base)))
        assert agg.stream_mode
        return agg

    return ref_agg, base, port_agg


def _port_leaves(agg):
    from fedml_tpu_torch import weights

    return jax.tree_util.tree_leaves(weights.torch_to_flax(weights.to_numpy(agg.global_vars)))


def test_full_tree_exact_payloads_fold_bitwise_the_flat_fold():
    """Integer payloads and weights keep every product and partial sum
    exact, so the 2x2 tree reproduces the flat fold's bits (the reference's
    ``test_aggregator_pin_full_tree_exact_payloads``)."""
    from fedml_tpu_torch.cross_silo.edge import EdgePartialFold

    _, base, port_agg = _base_and_aggregators("hier_pin_exact")

    def payload(cid):
        return jax.tree_util.tree_map(lambda a: np.full(a.shape, float(cid), np.float32), base)

    weights_ = {1: 2.0, 2: 3.0, 3: 5.0, 4: 7.0}
    flat, tree = port_agg(), port_agg()
    for cid in (1, 2, 3, 4):
        assert flat.ingest_streaming(cid, _msg("port", cid, payload(cid), weights_[cid]),
                                     weights_[cid], False)
    for members in ((1, 2), (3, 4)):
        fold = EdgePartialFold(base)
        for cid in members:
            assert fold.fold_child(cid, _msg("port", cid, payload(cid), weights_[cid]),
                                   weights_[cid], False)
        assert fold.peak_buffered <= 2
        tag = fold.control_tag()
        assert tree.fold_partial(_msg("port", members[0], fold.partial_tree(), fold.w),
                                 tag["sources"], tag["w_delta"])
    for agg in (flat, tree):
        assert agg.check_whether_all_receive(4)
        agg.aggregate(0)
    for a, b in zip(_port_leaves(flat), _port_leaves(tree)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("codec", [None, "qsgd8"])
def test_edge_partial_bitwise_the_reference(codec):
    """Random payloads (raw, or qsgd8 frames encoded by the reference with
    its eager quantizer) folded by both packages' edges in the same order:
    the partial sums, the tag and the journal form are the reference's,
    bitwise; the port restores its own journal form."""
    from fedml_tpu.comm import codecs as ref_codecs
    from fedml_tpu.cross_silo.edge import EdgePartialFold as RefFold
    from fedml_tpu_torch.cross_silo.edge import EdgePartialFold

    _, base, _ = _base_and_aggregators(f"hier_partial_{codec}")
    rs = np.random.RandomState(5)
    ref, port = RefFold(base), EdgePartialFold(base)
    for cid in (1, 2, 3):
        params = jax.tree_util.tree_map(lambda a: rs.randn(*a.shape).astype(a.dtype), base)
        if codec:
            params, _, _ = ref_codecs.compress_pytree(
                params, codec, key=jax.random.PRNGKey(cid),
                min_elems=ref_codecs.LOW_RANK_MIN_COMPRESS_ELEMS)
        n = 8.0 + cid
        assert ref.fold_child(cid, _msg("ref", cid, params, n), n, bool(codec))
        assert port.fold_child(cid, _msg("port", cid, params, n), n, bool(codec))
    for a, b in zip(jax.tree_util.tree_leaves(port.partial_tree()),
                    jax.tree_util.tree_leaves(ref.partial_tree())):
        assert a.dtype == np.float32 and np.array_equal(a, b)
    assert port.control_tag() == ref.control_tag()
    (pp, pa), (rp, ra) = port.export_state(), ref.export_state()
    assert pp == rp and sorted(pa) == sorted(ra)
    assert all(np.array_equal(pa[k], ra[k]) for k in pa)
    back = EdgePartialFold.from_state(pp, pa)
    assert back.control_tag() == port.control_tag() and back.folded == 3
    for a, b in zip(jax.tree_util.tree_leaves(back.partial_tree()),
                    jax.tree_util.tree_leaves(port.partial_tree())):
        assert np.array_equal(a, b)


def test_hop_codec_partial_bytes_the_reference(monkeypatch):
    """The edge's qsgd8 hop (``hier_hop_codec``) through the manager's ship,
    the reference's draws handed in through ``hop_noise`` (leaf ``i`` from
    ``fold_in(PRNGKey(0), i)``, the reference's key): the shipped message is
    byte-identical to the reference's partial re-encoded by its
    ``compress_pytree`` at the low-rank floor, with the reference's
    quantizer as its eager oracle (``tests/test_torch_compression.py``)."""
    import jax.numpy as jnp
    from fedml_tpu.comm import codecs as ref_codecs
    from fedml_tpu.comm.message import Message as RefMessage
    from fedml_tpu.cross_silo import message_define as ref_md
    from fedml_tpu.cross_silo.edge import EdgePartialFold as RefFold
    from fedml_tpu.ops.pallas import quantize as ref_q
    from fedml_tpu_torch.cross_silo.edge import (EdgeAggregatorManager, EdgePartialFold,
                                                 build_topology)

    _, base, _ = _base_and_aggregators("hier_hop_bytes")
    rs = np.random.RandomState(9)
    ref, port = RefFold(base), EdgePartialFold(base)
    for cid in (1, 3):
        params = jax.tree_util.tree_map(lambda a: rs.randn(*a.shape).astype(a.dtype), base)
        ref.fold_child(cid, _msg("ref", cid, params, 8.0), 8.0, False)
        port.fold_child(cid, _msg("port", cid, params, 8.0), 8.0, False)
    _, cfg = _pair("hier_hop_bytes", extra={"hier_fanout": 2, "comm_compression": "qsgd8",
                                            "hier_hop_codec": "qsgd8"})
    topo = build_topology(cfg)
    mgr = EdgeAggregatorManager(cfg, topo, rank=topo.edge_ranks[0], device="cpu",
                                backend="INPROC")
    sent = []
    mgr.send_message = sent.append
    mgr._fold, mgr._round_idx = port, 0

    def hop_noise(r, rank, i, shape, device):
        u = jax.random.uniform(jax.random.fold_in(jax.random.PRNGKey(0), i), shape, jnp.float32)
        return torch.from_numpy(np.array(u)).to(device)

    mgr.hop_noise = hop_noise
    mgr._ship_locked()
    mgr.finish()
    monkeypatch.setattr(ref_q, "quantize_int8_stochastic",
                        lambda vec, key, interpret=False: ref_q.quantize_int8_reference(vec, key))
    tree, _, _ = ref_codecs.compress_pytree(ref.partial_tree(), "qsgd8", ratio=0.01,
                                            min_elems=ref_codecs.LOW_RANK_MIN_COMPRESS_ELEMS)
    want = RefMessage(ref_md.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER, topo.edge_ranks[0], 0)
    want.add_params(ref_md.MSG_ARG_KEY_MODEL_PARAMS, tree)
    want.add_params(ref_md.MSG_ARG_KEY_NUM_SAMPLES, 16.0)
    want.add_params(ref_md.MSG_ARG_KEY_ROUND_INDEX, 0)
    want.add_params(ref_md.MSG_ARG_KEY_HIER_PARTIAL, ref.control_tag())
    assert len(sent) == 1 and mgr.partials_sent == 1
    assert sent[0].encode() == want.encode()


def test_fold_partial_redelivery_and_overlap():
    """A redelivered partial is swallowed (True, nothing counted twice); a
    partial overlapping folded sources in part is refused (False), as the
    reference's root does; both packages' roots agree on the result."""
    from fedml_tpu.cross_silo.edge import EdgePartialFold as RefFold
    from fedml_tpu_torch.cross_silo.edge import EdgePartialFold

    ref_agg, base, port_agg = _base_and_aggregators("hier_partial_sem")
    agg = port_agg()
    for pkg, fold_cls, root in (("ref", RefFold, ref_agg), ("port", EdgePartialFold, agg)):
        fold = fold_cls(base)
        for cid in (1, 2):
            fold.fold_child(cid, _msg(pkg, cid, base, 8.0), 8.0, False)
        tag = fold.control_tag()
        assert root.fold_partial(_msg(pkg, 1, fold.partial_tree(), fold.w), tag["sources"], 0.0)
        w_after = root._stream_w
        assert root.fold_partial(_msg(pkg, 1, fold.partial_tree(), fold.w), tag["sources"], 0.0)
        assert root._stream_w == w_after == 16.0
        fold2 = fold_cls(base)
        for cid in (1, 2, 3):
            fold2.fold_child(cid, _msg(pkg, cid, base, 8.0), 8.0, False)
        assert not root.fold_partial(_msg(pkg, 1, fold2.partial_tree(), fold2.w),
                                     fold2.control_tag()["sources"], 0.0)
    assert agg.received_count() == ref_agg.received_count() == 2


def test_sim_group_sums_bitwise_the_edge_fold():
    """The simulator's group fold (``sim/hierarchical.segment_group_sums``)
    and the protocol's edge fold agree bitwise on one round of group sums,
    each equal to the reference's (the same round-robin map, ascending
    member order)."""
    import jax.numpy as jnp
    from fedml_tpu.sim.hierarchical import segment_group_sums as ref_sums
    from fedml_tpu_torch.cross_silo.edge import EdgePartialFold, round_robin_groups
    from fedml_tpu_torch.sim.hierarchical import segment_group_sums

    n, groups = 8, 3
    rs = np.random.RandomState(7)
    leaf = rs.randn(n, 4, 3).astype(np.float32)
    w = (1.0 + np.arange(n)).astype(np.float32)
    g = round_robin_groups(n, groups)
    sim = segment_group_sums(torch.from_numpy(leaf), torch.from_numpy(w),
                             torch.from_numpy(g).long(), groups).numpy()
    want = np.asarray(ref_sums(jnp.asarray(leaf), jnp.asarray(w), jnp.asarray(g), groups))
    assert np.array_equal(sim, want)
    for grp in range(groups):
        fold = EdgePartialFold({"w": np.zeros((4, 3), np.float32)})
        for i in range(n):
            if g[i] == grp:
                fold.fold_child(i + 1, _msg("port", i + 1, {"w": leaf[i]}, w[i]), float(w[i]),
                                False)
        assert np.array_equal(fold.partial_tree()["w"], sim[grp])
        assert fold.peak_buffered <= 2


# -- the edge kill soak ----------------------------------------------------------------

def _ref_init(seed, n_clients):
    """The reference soak's initial global (its LR, built from ``seed``)."""
    import fedml_tpu
    from fedml_tpu.arguments import Config
    from fedml_tpu.cross_silo import build_aggregator
    from fedml_tpu.data import loader
    from fedml_tpu.models import model_hub

    cfg = Config(training_type="cross_silo", dataset="synthetic", model="lr",
                 client_num_in_total=n_clients, client_num_per_round=n_clients, epochs=1,
                 batch_size=16, learning_rate=0.1, partition_method="homo",
                 synthetic_train_size=64 * n_clients, synthetic_test_size=64,
                 frequency_of_the_test=0, compute_dtype="float32", metrics_jsonl_path="",
                 random_seed=seed, run_id=f"edge_ref_init_{seed}")
    fedml_tpu.init(cfg)
    ds = loader.load(cfg)
    agg = build_aggregator(cfg, ds, model_hub.create(cfg, ds.class_num))
    return jax.tree_util.tree_map(np.asarray, jax.device_get(agg.global_vars))


def _same(a, b):
    return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


def test_prefix_tree_soak_bitwise_the_flat_and_the_reference():
    """The prefix tree (an edge over clients [1, 2], singletons for the
    rest) folds the flat fold's op sequence under the soak's fixed arrival
    order: bitwise the flat leg, and both bitwise the reference's legs; the
    root's ingress drops even on the raw hop."""
    from fedml_tpu.cross_silo.async_soak import run_edge_kill_soak as ref_soak
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.cross_silo.async_soak import run_edge_kill_soak

    init = weights.to_torch(weights.flax_to_torch(_ref_init(0, 4)))
    topo = {"edges": [[1, 2], [3], [4]]}
    flat = run_edge_kill_soak(n_clients=4, fanout=0, rounds=2, kill=None, seed=0, device="cpu",
                              global_vars=init)
    tree = run_edge_kill_soak(n_clients=4, fanout=0, rounds=2, kill=None, seed=0, device="cpu",
                              global_vars=init, topology=topo)
    assert _same(flat["global_leaves"], tree["global_leaves"])
    assert tree["edges"] == 3 and tree["partials_sent"] == 3 * 2
    assert tree["root_ingress_bytes"] < flat["root_ingress_bytes"]
    assert tree["peak_buffered_root"] <= 2 and tree["peak_buffered_edge"] <= 2
    assert tree["unaccounted"] == 0
    ref_tree = ref_soak(n_clients=4, fanout=0, rounds=2, kill=None, seed=0, topology=topo)
    assert _same(tree["global_leaves"], [np.asarray(a) for a in ref_tree["global_leaves"]])
    assert tree["root_ingress_bytes"] == ref_tree["root_ingress_bytes"]


def test_edge_kill_soak_bitwise_the_clean_leg():
    """An edge SIGKILLed after its first child's fold recovers from its
    journal, dedups the re-sent upload, folds the rest and ships: the final
    global is the clean leg's, bitwise, with nothing unaccounted."""
    from fedml_tpu_torch.cross_silo.async_soak import run_edge_kill_soak

    clean = run_edge_kill_soak(n_clients=4, fanout=2, rounds=2, kill=None, seed=3, device="cpu")
    kill = run_edge_kill_soak(n_clients=4, fanout=2, rounds=2, kill=(0, 0, 1), seed=3,
                              device="cpu")
    assert kill["edge_kills"] == 1 and kill["edge_dedups"] >= 1
    assert kill["unaccounted"] == 0 and clean["unaccounted"] == 0
    assert kill["peak_buffered_root"] <= 2 and kill["peak_buffered_edge"] <= 2
    assert _same(clean["global_leaves"], kill["global_leaves"])


def test_root_ingress_ratio_qsgd8_fanout8():
    """Fanout 8 with qsgd8 on both hops: the root's ingress drops >= 4x
    against the flat protocol on the same compressed wire, and the hop
    codec's partials are smaller than raw ones."""
    from fedml_tpu_torch.cross_silo.async_soak import run_edge_kill_soak

    kw = dict(n_clients=16, rounds=2, kill=None, seed=0, device="cpu")
    flat = run_edge_kill_soak(fanout=0, codec="qsgd8", **kw)
    tree = run_edge_kill_soak(fanout=8, codec="qsgd8", hop_codec="qsgd8", **kw)
    raw_tree = run_edge_kill_soak(fanout=8, **kw)
    assert tree["edges"] == 2
    assert flat["root_ingress_bytes"] / tree["root_ingress_bytes"] >= 4.0
    assert tree["root_ingress_bytes"] < raw_tree["root_ingress_bytes"]


# -- tree runs with real clients ---------------------------------------------------------

def _ref_group(ref_cfg):
    import fedml_tpu
    from fedml_tpu.cross_silo import run_in_process_group
    from fedml_tpu.data import loader
    from fedml_tpu.models import model_hub

    fedml_tpu.init(ref_cfg)
    ds = loader.load(ref_cfg)
    model = model_hub.create(ref_cfg, ds.class_num)
    from fedml_tpu.cross_silo import build_aggregator

    init = jax.tree_util.tree_map(np.asarray, jax.device_get(
        build_aggregator(ref_cfg, ds, model).global_vars))
    hist = run_in_process_group(ref_cfg, ds, model, timeout=120.0)
    return hist, init


def _port_group(cfg, init):
    import fedml_tpu_torch
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.runner import FedMLRunner

    runner = FedMLRunner(fedml_tpu_torch.init(cfg), device="cpu")
    runner.runner.global_vars = weights.to_torch(weights.flax_to_torch(init))
    runner.runner.perms = JaxPerms(cfg.random_seed)
    hist = runner.run()
    return hist, runner.runner


@pytest.mark.parametrize("case", ["tree", "relay", "depth3", "tcp"])
def test_tree_run_matches_the_reference_and_the_flat_run(case):
    """Real clients through the port's in-process group with the tree:
    the history's test loss within ``RUN_TOL`` of the reference's tree run
    (its initial weights and permutations handed in), accuracy within 0.05
    of the flat run; relay mode (no fold trigger) relays every upload;
    depth 3 folds partials at the region tier; over TCP with
    ``tcp_base_port: 0`` the edges' ports are linked."""
    n = 8 if case == "depth3" else 4
    extra = {"streaming_aggregation": True, "hier_fanout": 2}
    if case == "relay":
        extra = {"hier_fanout": 2}
    if case == "depth3":
        extra["hier_depth"] = 3
    kw = dict(client_num_in_total=n, client_num_per_round=n)
    if case == "tcp":
        kw["backend"] = "TCP"
        extra["tcp_base_port"] = 0
    ref_cfg, cfg = _pair(f"hier_run_{case}", extra=extra, **kw)
    ref_cfg.backend = "INPROC"
    want, init = _ref_group(ref_cfg)
    got, group = _port_group(cfg, init)
    assert [h["round"] for h in got] == [h["round"] for h in want] == [0, 1]
    for g, w in zip(got, want):
        assert abs(g["test_loss"] - w["test_loss"]) <= RUN_TOL
        assert abs(g["test_acc"] - w["test_acc"]) <= 0.05
    edges = group.server.edges
    assert len(edges) == (6 if case == "depth3" else 2)
    if case == "relay":
        assert all(e.relays == 4 and e.folds == 0 for e in edges)
    else:
        assert all(e.folds == 4 and e.partials_sent == 2 for e in edges)
    assert all(e.done.is_set() for e in edges)
    flat_extra = {k: v for k, v in extra.items() if not k.startswith("hier_")}
    flat_extra["streaming_aggregation"] = True
    _, flat_cfg = _pair(f"hier_run_{case}_flat", extra=flat_extra, **kw)
    flat, _ = _port_group(flat_cfg, init)
    assert abs(flat[-1]["test_acc"] - got[-1]["test_acc"]) <= 0.05
    if case == "tree":
        # the tree thins the root's ingress to the partials
        assert group.server.upload_ingress_bytes < _port_group(flat_cfg, init)[1] \
            .server.upload_ingress_bytes
