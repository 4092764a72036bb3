"""Port parity: one client's local training (``fl/local_sgd.py``).

The same shard, global weights (flax init, converted) and per-epoch
permutation table (drawn by the JAX package from the client key and
injected into the port) go through ``fedml_tpu.fl.local_sgd`` and the port.
f32, fused ResNet (one block per stage).  Tolerance after all steps: params
and batch_stats rtol 2e-3 / atol 2e-5, train loss rtol 1e-4 (eager f32 vs
XLA's fused f32 differ in rounding, which compounds over the steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _setup(momentum, weight_decay, count, step_mode="match"):
    from fedml_tpu.fl.types import HParams as JHParams
    from fedml_tpu.models import resnet as flax_resnet
    from fedml_tpu_torch.fl.types import HParams

    cap, bsz, epochs = 24, 8, 2
    kw = dict(epochs=epochs, batch_size=bsz, learning_rate=0.05, momentum=momentum,
              weight_decay=weight_decay, steps_per_epoch=cap // bsz, step_mode=step_mode,
              compute_dtype="float32", fused_blocks=True)
    rs = np.random.RandomState(11)
    x = rs.randn(cap, 8, 8, 3).astype(np.float32)
    y = rs.randint(0, 10, size=cap).astype(np.int32)
    m = flax_resnet.CifarResNet(num_blocks=1, fused=True)
    k = jax.random.PRNGKey(0)
    v = jax.tree_util.tree_map(np.asarray, m.init({"params": k, "dropout": k}, x[:bsz], train=True))
    key = jax.random.PRNGKey(42)
    perms = np.stack([np.asarray(jax.random.permutation(
        jax.random.fold_in(jax.random.fold_in(key, e), 1), cap)) for e in range(epochs)])
    return JHParams(**kw), HParams(**kw), m, v, x, y, key, perms, count


@pytest.mark.parametrize("momentum,weight_decay,count,step_mode", [
    (0.0, 0.0, 19, "match"),   # the flagship's stateless SGD; count < cap
    (0.9, 5e-4, 13, "match"),  # momentum + add_decayed_weights
    (0.0, 0.0, 9, "fixed"),    # every step runs
])
def test_local_train_matches_reference(momentum, weight_decay, count, step_mode):
    """(e) local_train with injected permutations == make_local_train_fn."""
    from fedml_tpu.fl.local_sgd import make_local_train_fn as jax_make
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.fl.local_sgd import make_local_train_fn
    from fedml_tpu_torch.models import resnet

    jhp, hp, m, v, x, y, key, perms, count = _setup(momentum, weight_decay, count, step_mode)
    ref_vars, ref_metrics = jax.jit(jax_make(m, jhp))(v, x, y, jnp.int32(count), key)
    ref_vars = weights.flax_to_torch(jax.tree_util.tree_map(np.asarray, ref_vars))

    train = make_local_train_fn(resnet.CifarResNet(1, fused=True), hp)
    new_vars, metrics = train(weights.to_torch(weights.flax_to_torch(v)), torch.from_numpy(x),
                              torch.from_numpy(y).long(), count, key=None,
                              perms=torch.from_numpy(perms))
    for a, b in zip(pt.tree_leaves(new_vars), jax.tree_util.tree_leaves(ref_vars)):
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-3, atol=2e-5)
    assert metrics["num_steps"] == float(ref_metrics["num_steps"])
    assert metrics["num_samples"] == float(ref_metrics["num_samples"]) == count
    np.testing.assert_allclose(float(metrics["train_loss"]), float(ref_metrics["train_loss"]),
                               rtol=1e-4)
    # the weights moved: the comparison is not vacuous
    moved = [float((a - b).abs().max()) for a, b in zip(
        pt.tree_leaves(new_vars["params"]),
        pt.tree_leaves(weights.to_torch(weights.flax_to_torch(v))["params"]))]
    assert max(moved) > 1e-3


def test_match_mode_steps_and_perm_slices():
    """Step budget and batch slicing: own_steps = epochs * ceil(count/bsz),
    slices start at min(step_in_epoch * bsz, cap - bsz) of each epoch's row."""
    from fedml_tpu_torch.fl.local_sgd import make_local_train_fn
    from fedml_tpu_torch.fl.types import HParams

    seen = []

    class Probe:
        def apply(self, variables, x, train=True):
            seen.append(x[:, 0].clone())
            w = variables["params"]["w"]
            return x.reshape(x.shape[0], -1)[:, :3] * w, variables["batch_stats"]

    cap, bsz = 10, 4
    hp = HParams(epochs=2, batch_size=bsz, learning_rate=0.1, steps_per_epoch=3,
                 compute_dtype="float32")
    x = torch.arange(cap, dtype=torch.float32).reshape(cap, 1).repeat(1, 3)
    y = torch.zeros(cap, dtype=torch.long)
    perms = torch.stack([torch.arange(cap), torch.arange(cap).flip(0)])
    train = make_local_train_fn(Probe(), hp)
    v = {"params": {"w": torch.ones(3)}, "batch_stats": {}}
    _, metrics = train(v, x, y, 5, key=None, perms=perms)
    assert metrics["num_steps"] == 4.0  # 2 epochs * ceil(5/4)
    # steps 0-2 are epoch 0 (starts 0, 4, min(8, 6) = 6); step 3 is epoch 1 start 0
    assert [s.tolist() for s in seen] == [[0, 1, 2, 3], [4, 5, 6, 7], [6, 7, 8, 9], [9, 8, 7, 6]]


def test_eval_fn_matches_reference():
    """make_eval_fn: masked loss/accuracy over a padded test set."""
    from fedml_tpu.data.dataset import pad_eval_set
    from fedml_tpu.fl.local_sgd import make_eval_fn as jax_make_eval
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.fl.local_sgd import make_eval_fn
    from fedml_tpu_torch.models import resnet

    jhp, hp, m, v, *_ = _setup(0.0, 0.0, 8)
    rs = np.random.RandomState(3)
    tx, ty, n = pad_eval_set(rs.randn(37, 8, 8, 3).astype(np.float32),
                             rs.randint(0, 10, 37).astype(np.int32), 16)
    ref = jax.jit(jax_make_eval(m, jhp, batch_size=16))(v, tx, ty, jnp.int32(n))
    got = make_eval_fn(resnet.CifarResNet(1, fused=True), hp, batch_size=16)(
        weights.to_torch(weights.flax_to_torch(v)), torch.from_numpy(tx),
        torch.from_numpy(ty).long(), n)
    np.testing.assert_allclose(float(got["test_loss"]), float(ref["test_loss"]), rtol=1e-4)
    assert float(got["test_acc"]) == pytest.approx(float(ref["test_acc"]), abs=1e-6)


def test_optimizer_refusals():
    """The client ``adam`` is built as optax's ``adamw(lr,
    weight_decay=wd)`` with its defaults (its numerics:
    ``tests/test_torch_algorithms.py``); an unknown name is refused."""
    from fedml_tpu_torch.fl.local_sgd import make_optimizer
    from fedml_tpu_torch.fl.optim import Adam
    from fedml_tpu_torch.fl.types import HParams

    opt = make_optimizer(HParams(client_optimizer="adam", learning_rate=0.01, weight_decay=0.1))
    assert type(opt) is Adam
    assert (opt.lr, opt.b1, opt.b2, opt.eps, opt.weight_decay) == (0.01, 0.9, 0.999, 1e-8, 0.1)
    with pytest.raises(ValueError):
        make_optimizer(HParams(client_optimizer="rmsprop"))
