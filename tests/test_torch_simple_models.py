"""Port parity: the small models of ``fedml_tpu_torch/models/simple.py``
(``FedAvgCNN``, ``CifarCNN``, ``MLP``), their hub entries and the dropout
channel of local training (``fl/local_sgd.py``), against the flax models
of ``fedml_tpu/models/simple.py``.

The flax weights are carried across with ``weights.flax_to_torch`` (HWIO
-> OIHW, ``(in, out)`` -> ``(out, in)``), so neither side draws its own.
Forward passes in f32 eval mode within 1e-5.  One local SGD step of the
FedAvg CNN through both packages' ``make_local_train_fn``, the port given
the reference's permutation and the keep-mask of the reference's dropout
draw (read from ``capture_intermediates``: ``Dropout_0``'s output is
non-zero exactly where the mask keeps a non-zero input; where the input is
zero the mask cannot matter), in f32 and under the recipe's bf16 input,
within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _flax_vars(model, x, seed=0):
    variables = model.init({"params": jax.random.PRNGKey(seed),
                            "dropout": jax.random.PRNGKey(seed + 1)}, jnp.asarray(x), train=False)
    rs = np.random.RandomState(seed)
    # non-zero biases, so a bias in the wrong place shows
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (0.1 * rs.randn(*a.shape).astype(np.float32)
                                   if a.ndim == 1 else 0), variables)


def _port(variables):
    from fedml_tpu_torch import weights

    return weights.to_torch(weights.flax_to_torch(variables))


def _pairs():
    from fedml_tpu.models import simple as flax_simple
    from fedml_tpu_torch.models import simple

    return {
        "cnn": (flax_simple.FedAvgCNN(num_classes=10), simple.FedAvgCNN(10, False, (16, 16, 3)),
                (6, 16, 16, 3)),
        "cnn_digits": (flax_simple.FedAvgCNN(num_classes=62, only_digits=True),
                       simple.FedAvgCNN(62, True, (12, 12)), (5, 12, 12)),
        "cifar_cnn": (flax_simple.CifarCNN(num_classes=10), simple.CifarCNN(10, (16, 16, 3)),
                      (6, 16, 16, 3)),
        "mlp": (flax_simple.MLP(hidden=16, num_classes=6), simple.MLP(16, 6, 64), (7, 64)),
    }


@pytest.mark.parametrize("name", ["cnn", "cnn_digits", "cifar_cnn", "mlp"])
def test_forward_matches_flax(name):
    """Eval-mode logits in f32 within 1e-5, the flax tree's shapes in torch
    layouts, and the lane form: two models stacked on a lane axis give each
    model's own logits."""
    from fedml_tpu_torch.core import pytree as pt

    ref_model, model, shape = _pairs()[name]
    rs = np.random.RandomState(1)
    x = rs.randn(*shape).astype(np.float32)
    ref_vars = _flax_vars(ref_model, x)
    want = np.asarray(ref_model.apply(ref_vars, jnp.asarray(x), train=False))
    port_vars = _port(ref_vars)
    init = model.init(torch.Generator().manual_seed(0))
    assert ([tuple(t.shape) for t in pt.tree_leaves(init)]
            == [tuple(t.shape) for t in pt.tree_leaves(port_vars)])
    got, stats = model.apply(port_vars, torch.from_numpy(x), train=False)
    assert stats == {} and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)

    other = _port(_flax_vars(ref_model, x, seed=7))
    x2 = rs.randn(*shape).astype(np.float32)
    lanes = pt.tree_map(lambda a, b: torch.stack([a, b]), port_vars, other)
    both, _ = model.apply(lanes, torch.from_numpy(np.stack([x, x2])), train=False)
    alone, _ = model.apply(other, torch.from_numpy(x2), train=False)
    np.testing.assert_allclose(both[0].numpy(), got.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(both[1].numpy(), alone.numpy(), rtol=1e-6, atol=1e-6)


def test_bf16_input_is_widened_as_flax_does():
    """The reference's layers have no dtype: a bf16 input computes in f32."""
    ref_model, model, shape = _pairs()["cnn"]
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    ref_vars = _flax_vars(ref_model, x)
    want = np.asarray(ref_model.apply(ref_vars, jnp.asarray(x, jnp.bfloat16), train=False))
    got, _ = model.apply(_port(ref_vars), torch.from_numpy(x).to(torch.bfloat16), train=False)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _reference_dropout_mask(ref_model, variables, bx, dkey) -> np.ndarray:
    """The keep-mask of the reference's dropout draw ``dkey`` on batch
    ``bx``: where ``Dropout_0``'s output is non-zero."""
    _, inter = ref_model.apply(variables, bx, train=True, rngs={"dropout": dkey},
                               capture_intermediates=True, mutable=["intermediates"])
    return np.asarray(inter["intermediates"]["Dropout_0"]["__call__"][0]) != 0


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_one_dropout_step_matches_the_reference(compute_dtype):
    """One step of ``make_local_train_fn`` on the FedAvg CNN: the reference
    with its own keys, the port with the reference's permutation and
    keep-mask.  Without the mask the port refuses to train (it draws no
    dropout of its own)."""
    from fedml_tpu.fl.local_sgd import make_local_train_fn as ref_train_fn
    from fedml_tpu.fl.types import HParams as RefHParams
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.fl.local_sgd import make_local_train_fn
    from fedml_tpu_torch.fl.types import HParams

    ref_model, model, _ = _pairs()["cnn"]
    bsz, cap = 4, 8
    rs = np.random.RandomState(3)
    x = rs.randn(cap, 16, 16, 3).astype(np.float32)
    y = rs.randint(0, 10, size=cap).astype(np.int32)
    ref_vars = _flax_vars(ref_model, x[:bsz])
    hp = dict(epochs=1, batch_size=bsz, learning_rate=0.1, steps_per_epoch=2,
              compute_dtype=compute_dtype)
    key = jax.random.PRNGKey(5)
    ref_out, _ = ref_train_fn(ref_model, RefHParams(**hp))(
        ref_vars, jnp.asarray(x), jnp.asarray(y), jnp.int32(bsz), key)

    perm = np.asarray(jax.random.permutation(
        jax.random.fold_in(jax.random.fold_in(key, 0), 1), cap))
    dkey = jax.random.fold_in(jax.random.fold_in(key, 0), 2)
    cdt = jnp.bfloat16 if compute_dtype == "bfloat16" else jnp.float32
    mask = _reference_dropout_mask(ref_model, ref_vars,
                                   jnp.asarray(x[perm[:bsz]]).astype(cdt), dkey)
    assert mask.shape == model.dropout_shape(bsz) and 0 < mask.mean() < 1
    train = make_local_train_fn(model, HParams(**hp))
    got, metrics = train(_port(ref_vars), torch.from_numpy(x), torch.from_numpy(y).long(), bsz,
                         (0,), perms=torch.from_numpy(np.array(perm[None])),
                         dropout=torch.from_numpy(mask[None]))
    assert float(metrics["num_steps"]) == 1.0
    want = _port(jax.tree_util.tree_map(np.asarray, ref_out))
    start = _port(ref_vars)
    for a, b, s in zip(pt.tree_leaves(got), pt.tree_leaves(want), pt.tree_leaves(start)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-4)
        assert np.abs(b.numpy() - s.numpy()).max() > 0
    with pytest.raises(ValueError, match="keep-mask"):
        model.apply(_port(ref_vars), torch.from_numpy(x), train=True)


def test_dropout_draws_follow_the_client_key():
    """Without a table the single-lane train draws each step's mask from
    the client key (one stream a client), the same as the simulator's
    sampler gives; the batched train takes the lanes' tables (a lane's
    result is what it trains alone) and refuses to run without them."""
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.core import rng
    from fedml_tpu_torch.fl.local_sgd import (dropout_masks, lane_dropout_table,
                                              make_batched_local_train_fn, make_local_train_fn)
    from fedml_tpu_torch.fl.types import HParams
    from fedml_tpu_torch.sim.engine import ClientSampler

    _, model, _ = _pairs()["cnn"]
    hp = HParams(epochs=1, batch_size=4, learning_rate=0.1, steps_per_epoch=2,
                 compute_dtype="float32")
    variables = model.init(torch.Generator().manual_seed(0))
    x = torch.randn(2, 8, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    y = torch.randint(0, 10, (2, 8), generator=torch.Generator().manual_seed(2))
    sampler = ClientSampler(0, 2, 2)
    key = rng.client_key(rng.round_key(sampler.root, 0), 1)
    table = sampler.dropout(0, 1, 2, model.dropout_shape(4), model.keep_prob, "cpu")
    assert table.shape == (2, 4, 512) and table.dtype == torch.bool
    assert torch.equal(table, dropout_masks(key, 2, (4, 512), 0.5, "cpu"))
    perms = torch.stack([torch.randperm(8, generator=torch.Generator().manual_seed(3))])
    train = make_local_train_fn(model, hp)
    a, _ = train(variables, x[1], y[1], 8, key, perms=perms)
    b, _ = train(variables, x[1], y[1], 8, key, perms=perms, dropout=table)
    assert all(torch.equal(u, v) for u, v in zip(pt.tree_leaves(a), pt.tree_leaves(b)))
    batched = make_batched_local_train_fn(model, hp)
    lanes = pt.tree_map(lambda t: t.unsqueeze(0).repeat((2,) + (1,) * t.ndim), variables)
    with pytest.raises(ValueError, match="keep-masks"):
        batched(lanes, x, y, torch.tensor([0, 1]), [8, 4], perms.repeat(2, 1, 1))
    short = sampler.dropout(0, 0, 1, (4, 512), 0.5, "cpu")
    got, _ = batched(lanes, x, y, torch.tensor([0, 1]), [4, 8], perms.repeat(2, 1, 1),
                     dropout=lane_dropout_table([short, table]))
    one, _ = train(variables, x[1], y[1], 8, key, perms=perms, dropout=table)
    np.testing.assert_allclose(got["params"]["Dense_1"]["kernel"][1].numpy(),
                               one["params"]["Dense_1"]["kernel"].numpy(), rtol=1e-5, atol=1e-6)


def test_hub_creates_the_small_models():
    """``cnn`` / ``cnn_dropout`` (10 outputs on mnist / fashionmnist),
    ``simple-cnn`` / ``cifar_cnn`` / ``cnn_web`` and ``mlp`` with
    ``extra.mlp_hidden``, each with the reference's leaves."""
    from fedml_tpu.arguments import Config as RefConfig
    from fedml_tpu.models import model_hub as ref_hub
    from fedml_tpu_torch.arguments import Config
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.models import model_hub, simple

    cases = [("cnn", "mnist", (28, 28, 1)), ("cnn_dropout", "fashionmnist", (28, 28, 1)),
             ("cnn", "cifar10", (32, 32, 3)), ("simple-cnn", "cifar10", (32, 32, 3)),
             ("cifar_cnn", "cifar100", (32, 32, 3)), ("cnn_web", "cifar10", (32, 32, 3)),
             ("mlp", "synthetic_condshift", (64,))]
    for name, ds, shape in cases:
        kw = dict(model=name, dataset=ds, extra={"mlp_hidden": 24})
        ref = ref_hub.create(RefConfig(**kw), 62 if "mnist" in ds else 10)
        port = model_hub.create(Config(**kw), 62 if "mnist" in ds else 10, input_shape=shape)
        ref_vars = ref.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                            jnp.zeros((2,) + shape), train=False)
        want = [tuple(t.shape) for t in pt.tree_leaves(_port(
            jax.tree_util.tree_map(np.asarray, ref_vars)))]
        got = [tuple(t.shape) for t in pt.tree_leaves(
            port.init(torch.Generator().manual_seed(0)))]
        assert got == want, (name, ds)
    assert model_hub.create(Config(model="cnn", dataset="mnist"), 62, input_shape=(28, 28, 1)
                            ) == simple.FedAvgCNN(62, True, (28, 28, 1))
    assert model_hub.create(Config(model="mlp", extra={"mlp_hidden": 24}), 6,
                            in_features=64) == simple.MLP(24, 6, 64)


def test_engine_mesh_and_sp_draw_the_same_dropout(tmp_path):
    """FedAvg with the FedAvg CNN through the engine: the MESH round (the
    lanes' keep-mask tables stacked, each lane at its own budget) and the
    sp round (a table a client) take the same draws from the sampler, so
    one f32 round agrees within the reference's MESH-vs-SP tolerance (rtol
    2e-4, atol 2e-5)."""
    import dataclasses

    import fedml_tpu_torch
    from fedml_tpu_torch.arguments import Config
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.models import simple
    from fedml_tpu_torch.sim.engine import MeshSimulator

    # 4 of 5 clients with budgets of 3, 4, 3 and 5 steps: the lanes run in
    # another order than the clients'
    cfg = Config(dataset="cifar10", model="cnn", client_num_in_total=5, client_num_per_round=4,
                 comm_round=1, epochs=1, batch_size=4, learning_rate=0.05,
                 synthetic_train_size=64, synthetic_test_size=16, partition_method="hetero",
                 partition_alpha=0.5, frequency_of_the_test=0, compute_dtype="float32",
                 random_seed=0, data_cache_dir=str(tmp_path))
    fedml_tpu_torch.init(cfg)
    ds = loader.load(cfg)
    model = simple.FedAvgCNN(10, False, (32, 32, 3))
    sims = [MeshSimulator(dataclasses.replace(cfg, backend_sim=b), ds, model, device="cpu")
            for b in ("MESH", "sp")]
    sims[1].global_vars = pt.tree_map(torch.clone, sims[0].global_vars)
    start = [t.clone() for t in pt.tree_leaves(sims[0].global_vars)]
    losses = [sim.run_round()["train_loss"] for sim in sims]
    np.testing.assert_allclose(losses[0], losses[1], rtol=2e-4)
    for a, b, s in zip(*(pt.tree_leaves(sim.global_vars) for sim in sims), start):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=2e-5)
        assert not torch.equal(a, s)
