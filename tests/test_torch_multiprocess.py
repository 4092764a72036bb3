"""Port parity: multi-process runs over the gloo process group
(``parallel/multihost.py``, ``parallel/mesh.py``), the engine's
MULTIPROCESS round (``sim/engine.py`` ``_run_round_mesh``), the silo that
spans processes (``cross_silo/silo_dist.py``) and the sharded fold flag.

The reference's own two-process runs (``tests/_multihost_worker.py``,
``_silo_dist_worker.py``) hang: its ``cfg_extra(cfg, "process_id")`` reads
``Config.process_id`` (0 by default) before ``extra.process_id``, so both
processes start the ``jax.distributed`` service and wait until their
timeout.  So the port's
ranks are held against the reference's **one-process** runs, which the
reference's tests assert equal to its two-process runs
(``tests/test_multihost.py:79-85``, rel 1e-5; ``tests/test_silo_dist.py``):
the same checksum, L2 norm and test accuracy, and against the port's own
one-process runs leaf by leaf.  Ranks are spawned processes on the CPU
(``tests/_torch_rank_worker.py``), one torch thread each, 60 s at most.
"""

import warnings

import jax
import numpy as np
import pytest
import torch

from ._torch_rank_worker import TablePerms, TableSampler, free_port, spawn_ranks
from .conftest import tiny_config
from .test_torch_mesh import JaxSampler

torch.set_num_threads(1)

#: the reference's two-process-against-one tolerance (tests/test_multihost.py)
REL = 1e-5
RANK_TIMEOUT_S = 60.0


def _fields(ref_cfg) -> dict:
    import fedml_tpu_torch.arguments as args

    return {k: v for k, v in vars(ref_cfg).items() if k in args.Config.__dataclass_fields__}


def _summary(tree):
    flat = np.concatenate([np.asarray(x, np.float64).ravel()
                           for x in jax.tree_util.tree_leaves(tree)])
    return float(flat.sum()), float(np.sqrt((flat ** 2).sum()))


def _assert_summary(got, want, acc_got, acc_want):
    (s, l2), (rs, rl2) = _summary(got), _summary(want)
    assert s == pytest.approx(rs, rel=REL, abs=1e-5)
    assert l2 == pytest.approx(rl2, rel=REL, abs=1e-5)
    assert acc_got == pytest.approx(acc_want, abs=1e-6)


def _untimed(history):
    return [{k: v for k, v in h.items() if not k.endswith("_time_s")} for h in history]


def _multihost_cfg():
    """``tests/_multihost_worker.py``'s configuration, one process."""
    return tiny_config(client_num_per_round=8)


def _reference_engine(ref_cfg):
    """The reference's one-process run on its 8-device mesh (the
    ``_single_process_reference`` of ``tests/test_multihost.py``), its
    initial weights and its draws."""
    import fedml_tpu
    from fedml_tpu.core import rng
    from fedml_tpu.data import loader
    from fedml_tpu.models import model_hub
    from fedml_tpu.sim.engine import MeshSimulator

    fedml_tpu.init(ref_cfg)
    ds = loader.load(ref_cfg)
    sim = MeshSimulator(ref_cfg, ds, model_hub.create(ref_cfg, ds.class_num))
    init = jax.tree_util.tree_map(np.asarray, jax.device_get(sim.global_vars))
    history = sim.run()
    glob = jax.tree_util.tree_map(np.asarray, jax.device_get(sim.global_vars))
    draws = JaxSampler(rng.root_key(ref_cfg.random_seed), ref_cfg.client_num_in_total,
                       ref_cfg.client_num_per_round)
    return init, glob, history, draws


def _table_sampler(draws, rounds, epochs, cap):
    sampled = {r: draws.sample(r) for r in range(rounds)}
    perms = {(r, int(c)): draws.perms(r, int(c), epochs, cap).numpy()
             for r in range(rounds) for c in sampled[r]}
    return TableSampler(sampled, perms)


def test_two_process_engine_matches_the_reference_one_process_mesh(tmp_path):
    """``backend_sim: MULTIPROCESS`` over two ranks (4 lanes each) from the
    reference's initial weights and draws: both ranks hold the same global
    bitwise; it is the reference's one-process 8-device MESH run within
    rel 1e-5 (checksum, L2, test accuracy) and the port's one-process MESH
    run leaf by leaf, as is a MESH run in rank 0 alone while the group is up."""
    import fedml_tpu_torch
    import fedml_tpu_torch.arguments as args
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.models import model_hub
    from fedml_tpu_torch.sim.engine import MeshSimulator

    ref_cfg = _multihost_cfg()
    init, ref_global, ref_hist, draws = _reference_engine(ref_cfg)
    fields = _fields(ref_cfg)
    cfg = fedml_tpu_torch.init(args.Config(**fields))
    ds = loader.load(cfg)
    cap = int(max(len(ix) for ix in ds.client_idx))
    cap = -(-cap // cfg.batch_size) * cfg.batch_size
    sampler = _table_sampler(draws, cfg.comm_round, cfg.epochs, cap)

    one = MeshSimulator(cfg, ds, model_hub.create(cfg, ds.class_num,
                                                  input_shape=ds.train_x.shape[1:]),
                        device="cpu", sampler=sampler)
    one.global_vars = weights.to_torch(weights.flax_to_torch(init))
    one_hist = one.run()
    one_global = weights.torch_to_flax(weights.to_numpy(one.global_vars))

    ranks = spawn_ranks("engine", 2, tmp_path,
                        {"cfg": {**fields, "backend_sim": "MULTIPROCESS"}, "sampler": sampler,
                         "init": init}, timeout=RANK_TIMEOUT_S)
    for a, b in zip(jax.tree_util.tree_leaves(ranks[0]["global"]),
                    jax.tree_util.tree_leaves(ranks[1]["global"])):
        assert np.array_equal(a, b)
    assert _untimed(ranks[0]["history"]) == _untimed(ranks[1]["history"])
    got = ranks[0]["global"]
    _assert_summary(got, ref_global, ranks[0]["history"][-1]["test_acc"],
                    ref_hist[-1]["test_acc"])
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(one_global)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    assert [h["round"] for h in ranks[0]["history"]] == [h["round"] for h in one_hist]
    # a MESH run in rank 0 alone, the group up, stays a one-process run
    for a, b in zip(jax.tree_util.tree_leaves(ranks[0]["one_process"]),
                    jax.tree_util.tree_leaves(one_global)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def _silo_cfgs(model, run_id, **kw):
    base = dict(training_type="cross_silo", client_num_in_total=1, client_num_per_round=1,
                comm_round=2, batch_size=16, synthetic_train_size=256, synthetic_test_size=64,
                frequency_of_the_test=1, run_id=run_id)
    if model != "lr":
        base.update(dataset="cifar10", model=model, batch_size=8, synthetic_train_size=8,
                    synthetic_test_size=32, learning_rate=0.01)
    base.update(kw)
    return tiny_config(**base)


def _reference_silo(ref_cfg):
    """The reference's one-process silo (``tests/test_silo_dist.py``'s
    ``_single_process_silo_reference``): its initial and final global and
    history."""
    import fedml_tpu
    from fedml_tpu.comm.inproc import InProcRouter
    from fedml_tpu.cross_silo import build_client, build_server
    from fedml_tpu.data import loader
    from fedml_tpu.models import model_hub

    fedml_tpu.init(ref_cfg)
    ds = loader.load(ref_cfg)
    model = model_hub.create(ref_cfg, ds.class_num)
    InProcRouter.reset(ref_cfg.run_id)
    client = build_client(ref_cfg, ds, model, rank=1, backend="INPROC")
    client.run_in_thread()
    server = build_server(ref_cfg, ds, model, backend="INPROC")
    init = jax.tree_util.tree_map(np.asarray, jax.device_get(server.aggregator.global_vars))
    try:
        history = server.run_until_done(timeout=60.0)
    finally:
        client.finish()
    glob = jax.tree_util.tree_map(np.asarray, jax.device_get(server.aggregator.global_vars))
    return init, glob, history


SILO_MODELS = {
    # model -> tolerance against the port's one-process silo.  LR: sums in
    # another order, ulps.  ResNet-20 (BatchNorm over the global batch from
    # summed sum x / sum x^2, against one process's mean): flax's fast
    # variance E[x^2] - E[x]^2 is ill-conditioned, so the trajectory carries
    # ulps far.  Measured on the CPU in this setting (one step of batch 8 a
    # round, lr 0.01, 2 rounds), the one-process silo itself moves by
    # 2.7e-5 when one weight of its init moves by one ulp; held to about 4x
    # that (after 4 steps it moves by 1e-3, so the rounds stay short).
    "lr": dict(rtol=1e-6, atol=1e-7),
    "resnet20": dict(rtol=2e-4, atol=1e-4),
}


@pytest.mark.parametrize("model", sorted(SILO_MODELS))
def test_silo_spanning_two_processes_matches_the_one_process_silo(tmp_path, model):
    """One silo of two ranks (rank 0 the master over TCP to this process's
    server, rank 1 a follower in lockstep), each training on its half of
    every minibatch, from the reference's weights and permutations: the
    follower trains every round, and the global is the port's one-process
    silo's (``SILO_MODELS``) and the reference's one-process silo's (LR:
    rel 1e-5 on the checksum and L2, the test accuracy within 1e-6;
    ResNet-20: the update within 1e-2 relative L2)."""
    import threading

    import fedml_tpu_torch
    import fedml_tpu_torch.arguments as args
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.comm.tcp_backend import link_ports
    from fedml_tpu_torch.cross_silo import build_client, build_server, run_group
    from fedml_tpu_torch.cross_silo.async_soak import _free_port_block
    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.models import model_hub

    from .test_torch_secagg import JaxPerms

    ref_cfg = _silo_cfgs(model, f"span_ref_{model}")
    init, ref_global, ref_hist = _reference_silo(ref_cfg)
    fields = _fields(ref_cfg)
    cfg = fedml_tpu_torch.init(args.Config(**fields))
    ds = loader.load(cfg)
    net = model_hub.create(cfg, ds.class_num, input_shape=ds.train_x.shape[1:])
    count = len(ds.client_idx[0])
    cap = -(-count // cfg.batch_size) * cfg.batch_size
    jp = JaxPerms(cfg.random_seed)
    perms = TablePerms({(r, 0): jp(r, 0, cfg.epochs, cap).numpy()
                        for r in range(cfg.comm_round)})
    port_init = weights.to_torch(weights.flax_to_torch(init))

    # the port's one-process silo
    cfg.run_id = f"span_one_{model}"
    server = build_server(cfg, ds, net, "cpu", backend="INPROC", global_vars=port_init)
    client = build_client(cfg, ds, net, 1, "cpu", backend="INPROC", perms=perms)
    one_hist = run_group(server, [client], timeout=60.0)
    one_global = server.aggregator.host_global_flax()

    # the spanning silo: this process's server on fixed TCP ports
    base = _free_port_block(3)
    span = dict(fields, backend="TCP", role="client", rank=1, run_id=f"span_{model}",
                extra={"tcp_base_port": base})
    scfg = args.Config(**{**span, "role": "server", "rank": 0})
    server = build_server(scfg, ds, net, "cpu", backend="TCP", global_vars=port_init)
    link_ports([server])
    box = {}
    t = threading.Thread(target=lambda: box.update(h=server.run_until_done(timeout=55.0)),
                         daemon=True)
    t.start()
    try:
        ranks = spawn_ranks("silo", 2, tmp_path, {"cfg": span, "perms": perms},
                            timeout=RANK_TIMEOUT_S)
    finally:
        t.join(RANK_TIMEOUT_S)
    assert not t.is_alive() and "h" in box
    assert [r["follower"] for r in ranks] == [False, True]
    assert ranks[0]["rounds"] == cfg.comm_round
    got = server.aggregator.host_global_flax()
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(one_global)):
        np.testing.assert_allclose(a, b, **SILO_MODELS[model])
    if model == "lr":
        _assert_summary(got, ref_global, box["h"][-1]["test_acc"], ref_hist[-1]["test_acc"])
    else:
        # against the reference's one-process silo: the update within 1e-2
        # relative L2 (tests/test_torch_sim.py's FedAvg tolerance; the
        # reference's f32 gradients lose accuracy on trained weights)
        def update(tree):
            return np.concatenate([(np.asarray(a, np.float64) - np.asarray(b, np.float64)).ravel()
                                   for a, b in zip(jax.tree_util.tree_leaves(tree),
                                                   jax.tree_util.tree_leaves(init))])

        mine, theirs = update(got), update(ref_global)
        assert np.linalg.norm(mine - theirs) <= 1e-2 * np.linalg.norm(theirs)
    assert [h["round"] for h in box["h"]] == [h["round"] for h in one_hist] == [0, 1]


def _ids(mesh):
    """A reference mesh's device ids, as the port's rank array."""
    return np.vectorize(lambda d: d.id)(mesh.devices)


@pytest.mark.parametrize("case", ["2x4", "4x2", "1x8", "-1", "tile_error", "jobs_error",
                                  "concrete_error"])
def test_carve_submeshes_bitwise_the_reference(eight_devices, case):
    """``carve_submeshes`` over 8 ranks against the reference's over its 8
    CPU devices: the same leases (rank ids for device ids), descriptions
    and ``ValueError`` texts."""
    from fedml_tpu.parallel import mesh as ref_mesh
    from fedml_tpu_torch.parallel import mesh

    args = {"2x4": (("data",), (2,), 4), "4x2": (("silo", "data"), (2, 2), 2),
            "1x8": (("clients",), (1,), 8), "-1": (("data",), (-1,), 2),
            "tile_error": (("data",), (4,), 3), "jobs_error": (("data",), (2,), 0),
            "concrete_error": (("data", "model"), (2, 0), 1)}[case]
    try:
        want = ref_mesh.carve_submeshes(*args, devices=jax.devices())
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            mesh.carve_submeshes(*args, devices=range(8))
        assert str(got.value) == str(e)
        return
    got = mesh.carve_submeshes(*args, devices=range(8))
    assert got.describe() == want.describe() and len(got) == len(want)
    for i in range(len(want) + 1):
        assert np.array_equal(got.lease(i).devices, _ids(want.lease(i)))
        assert got.lease(i).axis_names == want.lease(i).axis_names


@pytest.mark.parametrize("n_target", [3, 8, 13])
def test_pad_leading_axis_np_bitwise_the_reference(n_target):
    from fedml_tpu.parallel import mesh as ref_mesh
    from fedml_tpu_torch.parallel import mesh

    rs = np.random.RandomState(n_target)
    tree = {"a": rs.randn(5, 3).astype(np.float32), "b": {"c": np.arange(8, dtype=np.int32)}}
    got, want = mesh.pad_leading_axis_np(tree, n_target), ref_mesh.pad_leading_axis_np(
        tree, n_target)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert a.dtype == b.dtype and np.array_equal(a, np.asarray(b))
    assert mesh.round_up(n_target, 8) == ref_mesh.round_up(n_target, 8)


@pytest.mark.parametrize("spec", ["clients:8", "silo:2,data:4", "data:2,model:-1", "data:16"])
def test_mesh_from_config_as_the_reference(eight_devices, spec):
    """``parse_mesh_shape`` / ``mesh_from_config`` over 8 ranks: the
    reference's shapes and axis names, or its "needs N devices" error."""
    from fedml_tpu.parallel import mesh as ref_mesh
    from fedml_tpu_torch.parallel import mesh

    assert mesh.parse_mesh_shape(spec) == ref_mesh.parse_mesh_shape(spec)
    cfg = tiny_config(mesh_shape=spec)
    try:
        want = ref_mesh.mesh_from_config(cfg, devices=jax.devices())
    except ValueError as e:
        with pytest.raises(ValueError, match="needs 16 devices, have 8"):
            mesh.mesh_from_config(cfg, devices=range(8))
        assert "needs 16 devices, have 8" in str(e)
        return
    got = mesh.mesh_from_config(cfg, devices=range(8))
    assert got.shape == dict(want.shape) and got.axis_names == want.axis_names
    assert np.array_equal(got.devices, _ids(want))


def test_submesh_plan_from_config_and_its_fallback(eight_devices, caplog):
    from fedml_tpu.parallel import mesh as ref_mesh
    from fedml_tpu_torch.parallel import mesh

    for extra in ({"mt_submesh_shape": "data:2"}, {"mt_submesh_shape": "data:2",
                                                   "mt_submesh_jobs": 3},
                  {"mt_submesh_shape": "data:4", "mt_submesh_jobs": 3}, {}):
        cfg = tiny_config(extra=extra)
        want = ref_mesh.submesh_plan_from_config(cfg, devices=jax.devices())
        got = mesh.submesh_plan_from_config(cfg, devices=range(8))
        assert (got is None) == (want is None)
        if want is not None:
            assert got.describe() == want.describe()
    assert "falling back to the time-sliced round gate" in caplog.text


def test_shard_leading_axis_rows_and_the_reference_warning():
    """A rank's contiguous rows of a divisible leading dim; an undivisible
    one replicated with the reference's warning, once per (dim, size); an
    unknown explicit axis a ``KeyError``."""
    from fedml_tpu_torch.parallel import mesh

    m = mesh.make_mesh((mesh.AXIS_CLIENTS,), (8,), devices=range(8))
    mesh._undivisible_warned.clear()
    x = np.arange(128 * 2).reshape(128, 2)
    assert np.array_equal(mesh.shard_leading_axis(x, m, rank=3), x[48:64])
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got = mesh.shard_leading_axis(torch.zeros(127, 4), m, rank=3)
        mesh.shard_leading_axis(torch.zeros(127, 4), m, rank=3)
    assert got.shape == (127, 4)
    msgs = [str(x.message) for x in w]
    assert len(msgs) == 1 and "127" in msgs[0] and "REPLICATING" in msgs[0], msgs
    with pytest.raises(KeyError, match="mesh has no axis 'seq'"):
        mesh.shard_leading_axis(x, m, axis="seq", rank=0)
    with pytest.raises(ValueError, match="needs 16 devices, have 8"):
        mesh.make_mesh(("data",), (16,), devices=range(8))


def test_multi_process_refusals_and_the_reference_text(tmp_path):
    """Without a coordinator, MULTIPROCESS raises the reference's
    ``ValueError`` text from ``init``, as the reference's ``init`` does; a
    simulator of its own refuses the backend by name; population mode and
    checkpoints are refused under it."""
    import fedml_tpu
    import fedml_tpu_torch
    import fedml_tpu_torch.arguments as args
    from fedml_tpu_torch.parallel import multihost
    from fedml_tpu_torch.runner import FedMLRunner

    ref_cfg = tiny_config(backend_sim="MULTIPROCESS")
    with pytest.raises(ValueError) as want:
        fedml_tpu.init(ref_cfg)
    with pytest.raises(ValueError) as got:
        fedml_tpu_torch.init(args.Config(**_fields(ref_cfg)))
    assert str(got.value) == str(want.value) == multihost.MULTIPROCESS_REFUSAL
    assert not multihost.is_initialized() and not multihost.ensure_initialized(None)
    cfg = args.Config(**{**_fields(tiny_config()), "backend_sim": "MPI",
                         "federated_optimizer": "HierarchicalFL"})
    with pytest.raises(NotImplementedError, match="runs in one process"):
        FedMLRunner(cfg, device="cpu")
    port = free_port()
    ranks = spawn_ranks("engine_refusals", 1, tmp_path, {
        "cfg": {**_fields(tiny_config()), "backend_sim": "MULTIPROCESS"},
        "tmp": str(tmp_path)}, timeout=RANK_TIMEOUT_S, port=port)
    assert ranks[0] == {"population_store": "population mode",
                        "checkpoint_dir": "every rank would write",
                        "second_init": True}


def test_server_shard_fold_bitwise_the_reference_sharded_fold(eight_devices):
    """``extra.server_shard_fold``: the reference folds into its
    ``ShardedStreamAccumulator`` over its 8-device mesh; the port's one
    shard owner is its device, so its fold is the device fold; four replies
    and the new global bitwise the reference's."""
    from fedml_tpu.comm.message import Message as RefMessage
    from fedml_tpu_torch.comm.message import Message

    from .test_torch_stream_fold import (_aggregators, _assert_trees_bitwise, _flax_global,
                                         _frames)

    ref, port, base = _aggregators({"streaming_aggregation": True, "server_shard_fold": True})
    assert ref._shard_fold and port.stream_mode
    for cid, data, n, is_delta in _frames(base, "raw"):
        assert ref.ingest_streaming(cid, RefMessage.decode(data), n, is_delta)
        assert port.ingest_streaming(cid, Message.decode(data), n, is_delta)
    assert type(ref._stream_acc).__name__ == "ShardedStreamAccumulator"
    ref.aggregate(0)
    port.aggregate(0)
    _assert_trees_bitwise(_flax_global(port),
                          jax.tree_util.tree_map(np.asarray, jax.device_get(ref.global_vars)))
