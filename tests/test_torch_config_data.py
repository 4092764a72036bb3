"""Port parity, host side: config, RNG helpers, trees and the data layer.

The same recipe / seed goes through ``fedml_tpu`` and ``fedml_tpu_torch``;
everything here is numpy or pure Python, so it must match bitwise.
"""

import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = sorted(REPO.glob("examples/*/fedml_config.yaml"))


def test_examples_gallery_has_nine_recipes():
    assert len(EXAMPLES) == 9


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.parent.name)
def test_config_loads_equal(path):
    """(a) every example recipe loads to an equal Config in both packages."""
    from fedml_tpu.arguments import add_args as jax_add_args
    from fedml_tpu_torch.arguments import add_args

    ref = jax_add_args(["--cf", str(path), "--rank", "2"])
    got = add_args(["--cf", str(path), "--rank", "2"])
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def test_cfg_extra_registry_matches():
    from fedml_tpu.core import flags as ref_flags
    from fedml_tpu_torch.core import flags

    assert {k: (v.type, v.default) for k, v in flags.FLAGS.items()} == {
        k: (v.type, v.default) for k, v in ref_flags.FLAGS.items()}
    from fedml_tpu_torch.arguments import Config

    cfg = Config(extra={"fused_blocks": True})
    assert flags.cfg_extra(cfg, "fused_blocks") is True
    with pytest.raises(KeyError):
        flags.cfg_extra(cfg, "not_a_flag")


def _labels(n=2000, classes=10, seed=3):
    return np.random.RandomState(seed).randint(0, classes, size=n).astype(np.int32)


@pytest.mark.parametrize("alpha,n_clients", [(0.5, 16), (0.1, 8), (5.0, 32)])
def test_partition_hetero_dirichlet_bitwise(alpha, n_clients):
    """(b) the Dirichlet partitioner is the same function of (labels, n,
    alpha, seed) in both packages."""
    from fedml_tpu.data import partition as ref
    from fedml_tpu_torch.data import partition

    labels = _labels()
    a = ref.partition_hetero_dirichlet(labels, n_clients, alpha, seed=7)
    b = partition.partition_hetero_dirichlet(labels, n_clients, alpha, seed=7)
    assert len(a) == len(b) == n_clients
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_partition_homo_bitwise():
    from fedml_tpu.data import partition as ref
    from fedml_tpu_torch.data import partition

    for a, b in zip(ref.partition_homo(1001, 7, seed=4), partition.partition_homo(1001, 7, seed=4)):
        np.testing.assert_array_equal(a, b)


def _cfg(pkg, **kw):
    base = dict(dataset="cifar10", model="resnet20", client_num_in_total=6,
                client_num_per_round=3, batch_size=8, synthetic_train_size=300,
                synthetic_test_size=70, partition_method="hetero", partition_alpha=0.5,
                random_seed=5)
    base.update(kw)
    return pkg.Config(**base)


def test_synthetic_cifar10_load_bitwise(tmp_path):
    """(b) the synthetic CIFAR-10 stand-in and its partition are bitwise the
    reference's (real files absent: data_cache_dir points at an empty dir)."""
    import fedml_tpu.arguments as ref_args
    import fedml_tpu_torch.arguments as args
    from fedml_tpu.data import loader as ref_loader
    from fedml_tpu_torch.data import loader

    ref = ref_loader.load(_cfg(ref_args, data_cache_dir=str(tmp_path)))
    got = loader.load(_cfg(args, data_cache_dir=str(tmp_path)))
    for f in ("train_x", "train_y", "test_x", "test_y"):
        a, b = getattr(ref, f), getattr(got, f)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert got.train_x.shape == (300, 32, 32, 3) and got.class_num == ref.class_num == 10
    for a, b in zip(ref.client_idx, got.client_idx):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("train,test", [(None, None), (500, 120)])
def test_synthetic_features_load_bitwise(tmp_path, train, test):
    """The ``synthetic`` dataset (60 features, 10 classes, 20,000 / 4,000 by
    default) and its Dirichlet partition are bitwise the reference's."""
    import fedml_tpu.arguments as ref_args
    import fedml_tpu_torch.arguments as args
    from fedml_tpu.data import loader as ref_loader
    from fedml_tpu_torch.data import loader

    kw = dict(dataset="synthetic", client_num_in_total=16, partition_alpha=0.3,
              synthetic_train_size=train, synthetic_test_size=test,
              data_cache_dir=str(tmp_path))
    ref, got = ref_loader.load(_cfg(ref_args, **kw)), loader.load(_cfg(args, **kw))
    for f in ("train_x", "train_y", "test_x", "test_y"):
        a, b = getattr(ref, f), getattr(got, f)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert got.train_x.shape == ((train or 20000), 60) and got.test_x.shape[0] == (test or 4000)
    assert got.class_num == ref.class_num == 10
    for a, b in zip(ref.client_idx, got.client_idx, strict=True):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_logistic_regression_matches_flax(dtype):
    """``lr``: the flax ``LogisticRegression``'s weights carried over
    (``weights.flax_to_torch`` turns the Dense kernel ``(in, out)`` into
    ``(out, in)`` and back), the same logits within f32 rounding, for f32
    input and for the bf16 input local training gives it (the flax Dense has
    no dtype: it widens the input to f32)."""
    import jax.numpy as jnp
    from fedml_tpu.models import simple as flax_simple
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.arguments import Config
    from fedml_tpu_torch.models import model_hub, simple

    model = model_hub.create(Config(model="lr"), 10, in_features=60)
    assert model == simple.LogisticRegression(10, 60)
    rs = np.random.RandomState(0)
    x = rs.randn(13, 60).astype(np.float32)
    ref_model = flax_simple.LogisticRegression(10)
    ref_vars = jax.tree_util.tree_map(np.asarray, ref_model.init(jax.random.PRNGKey(0), x))
    ref_vars["params"]["Dense_0"]["bias"] = rs.randn(10).astype(np.float32)
    port_vars = weights.flax_to_torch(ref_vars)
    assert port_vars["params"]["Dense_0"]["kernel"].shape == (10, 60)
    back = weights.torch_to_flax(port_vars)
    np.testing.assert_array_equal(back["params"]["Dense_0"]["kernel"],
                                  ref_vars["params"]["Dense_0"]["kernel"])
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if dtype == "bfloat16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    want = np.asarray(ref_model.apply(ref_vars, jx))
    got, stats = model.apply(weights.to_torch(port_vars), tx)
    assert stats == {} and got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_logistic_regression_lane_form_is_each_lane_alone():
    """The lane form (lane-stacked variables, ``(L, N, ...)`` input) is
    decided from the kernel's leading lane axis, not from the input's rank:
    each lane's logits bitwise the lane run alone, for feature vectors and
    for image-shaped input (flattened), and a single batch of images of one
    more rank stays a single batch."""
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.models import simple

    for shape in ((5, 60), (5, 4, 5, 3)):
        n_in = int(np.prod(shape[1:]))
        model = simple.LogisticRegression(10, n_in)
        lanes = [model.init(torch.Generator().manual_seed(k)) for k in range(3)]
        for v in lanes:
            v["params"]["Dense_0"]["bias"] += torch.randn(10, generator=torch.Generator())
        stacked = pt.tree_stack(lanes)
        x = torch.from_numpy(np.random.RandomState(1).randn(3, *shape).astype(np.float32))
        logits, _ = model.apply(stacked, x)
        assert logits.shape == (3, 5, 10)
        for lane, v in enumerate(lanes):
            alone, _ = model.apply(v, x[lane])
            assert torch.equal(logits[lane], alone)
    single = simple.LogisticRegression(10, 5 * 4 * 5 * 3)
    v = single.init(torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 5, 4, 5, 3).astype(np.float32))
    logits, _ = single.apply(v, x)  # 2 samples of rank 4, as flax flattens them: not 2 lanes
    assert logits.shape == (2, 10) and torch.equal(logits, single.apply(v, x.reshape(2, -1))[0])


def test_real_cifar_batches_read_equal(tmp_path):
    """The CIFAR python-batch reader (the path taken when real files exist)
    gives the reference's arrays."""
    import pickle

    import fedml_tpu.arguments as ref_args
    import fedml_tpu_torch.arguments as args
    from fedml_tpu.data import loader as ref_loader
    from fedml_tpu_torch.data import loader

    d = tmp_path / "cifar-10-batches-py"
    d.mkdir()
    rs = np.random.RandomState(0)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        batch = {b"data": rs.randint(0, 256, size=(12, 3072), dtype=np.uint8),
                 b"labels": rs.randint(0, 10, size=12).tolist()}
        with open(d / name, "wb") as f:
            pickle.dump(batch, f)
    ref = ref_loader.load(_cfg(ref_args, data_cache_dir=str(tmp_path), client_num_in_total=3))
    got = loader.load(_cfg(args, data_cache_dir=str(tmp_path), client_num_in_total=3))
    assert got.train_x.shape == (60, 32, 32, 3)
    for f in ("train_x", "train_y", "test_x", "test_y"):
        np.testing.assert_array_equal(getattr(ref, f), getattr(got, f))


def _assert_fets_equal(got, want):
    """Every array of two ``fets2021`` loads equal, masks and partition
    included."""
    for f in ("train_x", "train_y", "test_x", "test_y", "masks", "test_masks"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.class_num == want.class_num and got.name == want.name == "fets2021"
    assert len(got.client_idx) == len(want.client_idx)
    for a, b in zip(got.client_idx, want.client_idx):
        np.testing.assert_array_equal(a, b)


def test_other_datasets_raise_not_implemented(tmp_path):
    """``fets2021``, the last dataset to be ported (FedSeg's), loads its
    stand-in bitwise the reference's: the volumes, the per-pixel masks, the
    dominant-class labels and their Dirichlet partition.  No dataset name
    raises ``NotImplementedError`` any more; an unknown name is a
    ``ValueError``, as in the reference."""
    import fedml_tpu.arguments as ref_args
    import fedml_tpu_torch.arguments as args
    from fedml_tpu.data import loader as ref_loader
    from fedml_tpu_torch.data import loader

    kw = dict(dataset="fets2021", data_cache_dir=str(tmp_path), client_num_in_total=3,
              synthetic_train_size=60, synthetic_test_size=6, partition_alpha=1.0)
    got = loader.load(_cfg(args, **kw))
    _assert_fets_equal(got, ref_loader.load(_cfg(ref_args, **kw)))
    assert got.train_x.shape == (60, 64, 64, 4) and got.masks.shape == (60, 64, 64)
    dominant = [np.bincount(m[m > 0]).argmax() if (m > 0).any() else 0 for m in got.masks]
    np.testing.assert_array_equal(got.train_y, dominant)
    with pytest.raises(ValueError, match="unknown dataset"):
        loader.load(args.Config(dataset="no_such_set"))


def test_stack_clients_and_pad_eval_bitwise(tmp_path):
    """(b) client stacking (cyclic padding to a batch multiple) and eval-set
    tiling are bitwise the reference's."""
    import fedml_tpu.arguments as ref_args
    from fedml_tpu.data import dataset as ref_ds
    from fedml_tpu.data import loader as ref_loader
    from fedml_tpu_torch.data import dataset

    ref = ref_loader.load(_cfg(ref_args, data_cache_dir=str(tmp_path)))
    port = dataset.FederatedDataset(ref.train_x, ref.train_y, ref.test_x, ref.test_y,
                                    ref.client_idx, ref.class_num)
    for mult in (1, 8, 64):
        a = ref_ds.stack_clients(ref, multiple_of=mult)
        b = dataset.stack_clients(port, multiple_of=mult)
        assert b.capacity == a.capacity
        for f in ("x", "y", "counts"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    for bs in (32, 64, 256):
        ax, ay, an = ref_ds.pad_eval_set(ref.test_x, ref.test_y, bs)
        bx, by, bn = dataset.pad_eval_set(ref.test_x, ref.test_y, bs)
        assert an == bn
        np.testing.assert_array_equal(ax, bx)
        np.testing.assert_array_equal(ay, by)


def test_sample_clients_semantics():
    """The port's sampler keeps the reference's semantics (not its bits):
    everyone when all fit, else a fresh m-subset without replacement per
    round, deterministic in (seed, round)."""
    from fedml_tpu.core import rng as ref_rng
    from fedml_tpu_torch.core import rng

    k = rng.root_key(0)
    np.testing.assert_array_equal(rng.sample_clients(k, 3, 5, 8), np.arange(5))
    np.testing.assert_array_equal(
        np.asarray(ref_rng.sample_clients(ref_rng.root_key(0), 3, 5, 8)), np.arange(5))
    draws = [rng.sample_clients(k, r, 20, 6) for r in range(8)]
    for d in draws:
        assert len(set(d.tolist())) == 6 and d.min() >= 0 and d.max() < 20
    assert len({tuple(d) for d in draws}) > 1
    np.testing.assert_array_equal(draws[2], rng.sample_clients(k, 2, 20, 6))
    assert not np.array_equal(rng.sample_clients(rng.root_key(1), 2, 20, 6), draws[2])


def test_client_and_round_streams_disjoint():
    from fedml_tpu_torch.core import rng

    k = rng.root_key(0)
    a = rng.permutation(rng.client_key(rng.round_key(k, 1), 2), 50)
    b = rng.permutation(rng.round_key(rng.round_key(k, 1), 2), 50)
    c = rng.permutation(rng.client_key(rng.round_key(k, 1), 2), 50)
    assert torch.equal(a, c) and not torch.equal(a, b)


def _nested(seed=0):
    rs = np.random.RandomState(seed)
    return {"params": {"b": {"kernel": rs.randn(3, 2).astype(np.float32),
                             "bias": rs.randn(2).astype(np.float32)},
                       "a": {"scale": rs.randn(4).astype(np.float32)}},
            "batch_stats": {"a": {"mean": rs.randn(4).astype(np.float32),
                                  "var": rs.rand(4).astype(np.float32)}}}


def test_tree_flatten_to_vector_in_jax_order():
    """Flattening follows JAX's leaf order (sorted keys at every level)."""
    from fedml_tpu.core import pytree as ref_pt
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.weights import to_torch

    tree = _nested()
    ref, _ = ref_pt.tree_flatten_to_vector(jax.tree_util.tree_map(np.asarray, tree))
    got, unravel = pt.tree_flatten_to_vector(to_torch(tree))
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())
    back = unravel(got)
    for a, b in zip(pt.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a.numpy(), b)


def test_tree_weighted_mean_and_stack():
    """Sample-weighted mean over a stacked leading axis, f32 sums (order of
    the sum differs from XLA's: rtol 1e-6)."""
    from fedml_tpu.core import pytree as ref_pt
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.weights import to_torch

    trees = [_nested(s) for s in range(5)]
    w = np.array([3, 1, 4, 1, 5], np.float32)
    ref = ref_pt.tree_weighted_mean(ref_pt.tree_stack(
        [jax.tree_util.tree_map(np.asarray, t) for t in trees]), w)
    got = pt.tree_weighted_mean(pt.tree_stack([to_torch(t) for t in trees]), torch.from_numpy(w))
    for a, b in zip(jax.tree_util.tree_leaves(ref), pt.tree_leaves(got)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-7)
