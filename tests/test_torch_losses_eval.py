"""Port parity: the losses (``fedml_tpu_torch/fl/losses.py``) and the
evaluation's three branches (``fl/local_sgd.make_eval_fn``) against
``fedml_tpu/fl/losses.py`` and ``fedml_tpu/fl/local_sgd.make_eval_fn``.

f32 on the same numpy inputs.  Cross-entropy, binary cross-entropy and MSE
within rtol 1e-6 (measured up to 1.2e-7: torch's and XLA's reductions sum
in other orders), accuracy counts exactly; each lane form equal to the
single form on each lane's slice (rtol 1e-6).  The evaluation on a padded
set with a validity mask: classification (a logistic regression), a
sequence task (a tiny CharLSTM) and multi-hot targets (a logistic
regression scored by binary cross-entropy), loss within rtol 1e-5 and
accuracy within 1e-6 of the reference's jitted eval.  Local training with
``HParams(loss="mse")`` and sequence labels runs through both local-train
forms.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _inputs(kind, rs, lanes=None):
    lead = (lanes,) if lanes else ()
    if kind == "class":
        return rs.randn(*lead, 6, 5).astype(np.float32), rs.randint(0, 5, lead + (6,))
    if kind == "seq":
        return rs.randn(*lead, 4, 7, 9).astype(np.float32), rs.randint(0, 9, lead + (4, 7))
    return (rs.randn(*lead, 6, 5).astype(np.float32) * 3,
            (rs.rand(*lead, 6, 5) < 0.3).astype(np.float32))


@pytest.mark.parametrize("kind", ["class", "seq", "multi_hot"])
def test_cross_entropy_and_lanes_match_reference(kind):
    from fedml_tpu.fl import losses as ref
    from fedml_tpu_torch.fl import losses

    rs = np.random.RandomState(0)
    logits, labels = _inputs(kind, rs)
    want = float(ref.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    got = losses.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    if kind == "multi_hot":  # optax's formula, written out
        elem = losses.sigmoid_binary_cross_entropy(torch.from_numpy(logits),
                                                   torch.from_numpy(labels))
        import optax

        np.testing.assert_allclose(elem.numpy(), np.asarray(optax.sigmoid_binary_cross_entropy(
            jnp.asarray(logits), jnp.asarray(labels))), rtol=1e-6, atol=1e-7)
    ll, lb = _inputs(kind, rs, lanes=3)
    per = losses.get_lane_loss_fn("cross_entropy")(torch.from_numpy(ll), torch.from_numpy(lb))
    assert per.shape == (3,)
    for lane in range(3):
        one = losses.get_loss_fn("cross_entropy")(torch.from_numpy(ll[lane]),
                                                  torch.from_numpy(lb[lane]))
        np.testing.assert_allclose(float(per[lane]), float(one), rtol=1e-6)
        np.testing.assert_allclose(float(per[lane]), float(ref.cross_entropy(
            jnp.asarray(ll[lane]), jnp.asarray(lb[lane]))), rtol=1e-6)


def test_mse_and_accuracy_count_match_reference():
    from fedml_tpu.fl import losses as ref
    from fedml_tpu_torch.fl import losses

    rs = np.random.RandomState(1)
    pred, target = rs.randn(3, 6, 4).astype(np.float32), rs.randn(3, 6, 4).astype(np.float32)
    got = losses.get_loss_fn("mse")(torch.from_numpy(pred[0]), torch.from_numpy(target[0]))
    np.testing.assert_allclose(float(got), float(ref.mse(jnp.asarray(pred[0]),
                                                          jnp.asarray(target[0]))), rtol=1e-6)
    per = losses.get_lane_loss_fn("mse")(torch.from_numpy(pred), torch.from_numpy(target))
    for lane in range(3):
        np.testing.assert_allclose(float(per[lane]), float(ref.mse(
            jnp.asarray(pred[lane]), jnp.asarray(target[lane]))), rtol=1e-6)
    for kind in ("class", "seq"):
        logits, labels = _inputs(kind, rs)
        assert int(losses.accuracy_count(torch.from_numpy(logits), torch.from_numpy(labels))) \
            == int(ref.accuracy_count(jnp.asarray(logits), jnp.asarray(labels)))
    with pytest.raises(ValueError, match="unknown loss"):
        losses.get_loss_fn("hinge")
    with pytest.raises(ValueError, match="unknown loss"):
        losses.get_lane_loss_fn("hinge")


def _eval_case(kind):
    """(flax model, port model, x, y) of one eval branch; the port's
    variables carried from flax's."""
    from fedml_tpu.models import rnn as fr
    from fedml_tpu.models import simple as fs
    from fedml_tpu_torch.models import rnn, simple

    rs = np.random.RandomState(2)
    if kind == "seq":
        x = rs.randint(0, 11, (37, 6)).astype(np.int32)
        y = rs.randint(0, 11, (37, 6)).astype(np.int32)
        return fr.CharLSTM(11, 3, 5), rnn.CharLSTM(11, 3, 5), x, y
    x = rs.randn(37, 12).astype(np.float32)
    if kind == "class":
        y = rs.randint(0, 5, 37).astype(np.int32)
    else:
        y = (rs.rand(37, 5) < 0.3).astype(np.float32)
    return fs.LogisticRegression(num_classes=5), simple.LogisticRegression(5, 12), x, y


@pytest.mark.parametrize("kind", ["class", "seq", "multi_hot"])
def test_eval_branches_match_reference(kind):
    """The padded eval (37 samples tiled to 48, batch 16, the last 11
    masked) against the reference's for each branch."""
    from fedml_tpu.fl.local_sgd import make_eval_fn as ref_make
    from fedml_tpu.fl.types import HParams as RefHParams
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.data.dataset import pad_eval_set
    from fedml_tpu_torch.fl.local_sgd import make_eval_fn
    from fedml_tpu_torch.fl.types import HParams

    ref_model, model, x, y = _eval_case(kind)
    fv = jax.tree_util.tree_map(np.asarray, ref_model.init(jax.random.PRNGKey(0),
                                                           jnp.asarray(x[:2])))
    fv = jax.tree_util.tree_map(lambda a: a + 0.3 * np.random.RandomState(3).randn(*a.shape)
                                .astype(np.float32), fv)
    px, py, n = pad_eval_set(x, y, 16)
    assert px.shape[0] == 48 and n == 37
    want = jax.jit(ref_make(ref_model, RefHParams(), batch_size=16))(
        fv, jnp.asarray(px), jnp.asarray(py), jnp.int32(n))
    pv = weights.to_torch(weights.flax_to_torch(fv))
    got = make_eval_fn(model, HParams(), batch_size=16)(pv, torch.from_numpy(px),
                                                        torch.from_numpy(py), n)
    np.testing.assert_allclose(float(got["test_loss"]), float(want["test_loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(got["test_acc"]), float(want["test_acc"]), atol=1e-6)
    assert 0.0 < float(got["test_acc"]) < 1.0


@pytest.mark.parametrize("loss,kind", [("cross_entropy", "seq"), ("mse", "class")])
def test_local_train_takes_the_other_losses(loss, kind):
    """Both local-train forms with ``HParams(loss=...)``: sequence labels
    through the lane gather, MSE on a regression target; the lanes equal
    each client trained alone."""
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.fl.local_sgd import make_batched_local_train_fn, make_local_train_fn
    from fedml_tpu_torch.fl.types import HParams
    from fedml_tpu_torch.models import rnn, simple

    g = torch.Generator().manual_seed(0)
    if kind == "seq":
        model = rnn.CharLSTM(11, 3, 5)
        x = torch.randint(0, 11, (2, 8, 6), generator=g, dtype=torch.int32)
        y = torch.randint(0, 11, (2, 8, 6), generator=g)
    else:
        model = simple.MLP(8, 4, 6)
        x = torch.randn(2, 8, 6, generator=g)
        y = torch.randn(2, 8, 4, generator=g)
    hp = HParams(epochs=1, batch_size=4, learning_rate=0.1, steps_per_epoch=2, loss=loss,
                 compute_dtype="float32")
    variables = model.init(torch.Generator().manual_seed(1))
    perms = torch.stack([torch.randperm(8, generator=g) for _ in range(2)])[:, None]
    alone = [make_local_train_fn(model, hp)(variables, x[i], y[i], 8, (0,), perms=perms[i])
             for i in range(2)]
    lanes = pt.tree_map(lambda t: t.unsqueeze(0).repeat((2,) + (1,) * t.ndim), variables)
    both, metrics = make_batched_local_train_fn(model, hp)(lanes, x, y, torch.tensor([0, 1]),
                                                            [8, 8], perms)
    for i in range(2):
        np.testing.assert_allclose(float(metrics["train_loss"][i]),
                                   float(alone[i][1]["train_loss"]), rtol=1e-5)
        for a, b in zip(pt.tree_leaves(both), pt.tree_leaves(alone[i][0])):
            np.testing.assert_allclose(a[i].numpy(), b.numpy(), rtol=1e-5, atol=1e-6)
    assert float(alone[0][1]["train_loss"]) > 0
