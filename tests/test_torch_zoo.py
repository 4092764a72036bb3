"""Port parity: the CNN zoo (``fedml_tpu_torch/models/cnn_zoo.py``) and
the GroupNorm ResNet (``models/resnet.py``, ``norm="group"``) against
``fedml_tpu/models/cnn_zoo.py`` and ``fedml_tpu/models/resnet.py``.

The port draws the weights (every 1-D leaf moved off its init, so a scale
or bias in the wrong place shows) and carries them to flax with
``weights.torch_to_flax``; the flax tree's names and shapes come from
``jax.eval_shape`` of the reference's init.  f32, train mode, on each
model's fixed channel plan at 8x8 inputs (VGG at 32x32: its five pools need
it) and a batch of 8, the flax side jitted.

Tolerances, measured on the CPU:
- logits within 1e-3 of their largest magnitude (measured up to 1.4e-4,
  MobileNetV1 with BatchNorm: its last stages are 1x1, so BN normalizes 8
  values and amplifies an ulp), new BN statistics within 1e-4 (measured
  4.7e-5);
- gradients, GroupNorm: each leaf within 1e-4 of its largest entry
  (measured 1.3e-5).  BatchNorm: in f32 the gradient is ill-conditioned
  (a ReLU after a BN over 8 values flips where two f32 forwards differ in
  the last bits): on this input the reference's own f32 gradient of
  MobileNetV1 is 2.3e-2 (relative L2) from its f64 one, the port's 2.2e-4,
  although each block's forward and backward given the same input agree
  to 1e-6.  So here BN models compare the gradient in f64 on both sides
  (the norms compute in at least f32, as flax's do; the last Dense stays
  f32 on both), the whole gradient within a relative L2 of 1e-6 (measured
  1.0e-7); ``tests/test_torch_zoo_f32.py`` holds the f32 gradients against
  each other over several seeds at 32x32;
- lanes: two models on a lane axis, each lane against the model alone:
  bitwise, except MobileNetV3 (its 5x5 depthwise convs over 72 and 120
  channels run another CPU kernel path at twice the channels; measured
  2.7e-6), held to 1e-5.

bf16: ``tests/test_torch_zoo_group.py::test_bf16_stage_matches_flax``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

torch.set_num_threads(1)


def _cases():
    from fedml_tpu.models import cnn_zoo as fz
    from fedml_tpu.models import resnet as fr
    from fedml_tpu_torch.models import cnn_zoo as tz
    from fedml_tpu_torch.models import resnet as tr

    return {
        "mobilenet-batch": (fz.MobileNetV1(10), tz.MobileNetV1(10), 8, True),
        "mobilenet-group": (fz.MobileNetV1(10, norm="group"), tz.MobileNetV1(10, norm="group"),
                            8, True),
        "mobilenet_v3-batch": (fz.MobileNetV3Small(10), tz.MobileNetV3Small(10), 8, False),
        "efficientnet-batch": (fz.EfficientNetB0(10), tz.EfficientNetB0(10), 8, True),
        "vgg11-batch": (fz.VGG(10, 11), tz.VGG(10, depth=11), 32, True),
        "vgg16-group": (fz.VGG(10, 16, norm="group"), tz.VGG(10, norm="group", depth=16), 32,
                        True),
        "resnet20-group": (fr.resnet20(10, "group"), tr.resnet20(10, norm="group"), 8, True),
    }


def _port_init(model, seed=0):
    from fedml_tpu_torch.core import pytree as pt

    g = torch.Generator().manual_seed(seed + 100)
    return pt.tree_map(lambda a: a + (0.1 * torch.randn(a.shape, generator=g)
                                      if a.ndim == 1 else 0), model.init(
                                          torch.Generator().manual_seed(seed)))


def _flax(tree):
    from fedml_tpu_torch import weights

    return weights.torch_to_flax(weights.to_numpy(tree))


def _assert_flax_layout(ref_model, x, variables):
    """The port's tree, carried to flax, has the reference init's names and
    shapes."""
    want = jax.eval_shape(lambda: ref_model.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                                 train=False))
    got = _flax(variables)
    assert jax.tree_util.tree_structure(want) == jax.tree_util.tree_structure(got)
    assert ([a.shape for a in jax.tree_util.tree_leaves(want)]
            == [a.shape for a in jax.tree_util.tree_leaves(got)])


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


BATCH_NORM_CASES = ("efficientnet-batch", "mobilenet-batch", "mobilenet_v3-batch", "vgg11-batch")
GROUP_NORM_CASES = ("mobilenet-group", "resnet20-group", "vgg16-group")


@pytest.mark.parametrize("case", BATCH_NORM_CASES)
def test_zoo_f32_matches_flax(case):
    """Train-mode logits, new BN statistics and the CE gradient against the
    jitted flax model, the tree against flax's, and the lane form
    (the GroupNorm cases: ``tests/test_torch_zoo_group.py``)."""
    check_case(case)


def check_case(case):
    """The body of :func:`test_zoo_f32_matches_flax` for one case."""
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.core import pytree as pt

    ref_model, model, hw, bitwise = _cases()[case]
    rs = np.random.RandomState(0)
    x = rs.randn(8, hw, hw, 3).astype(np.float32)
    y = rs.randint(0, 10, 8).astype(np.int32)
    variables = _port_init(model)
    _assert_flax_layout(ref_model, x[:1], variables)
    fv = _flax(variables)
    rest = {k: v for k, v in fv.items() if k != "params"}

    def loss(p, rest, x, y, m=ref_model):
        if rest:
            logits, st = m.apply({"params": p, **rest}, x, train=True, mutable=list(rest))
        else:
            logits, st = m.apply({"params": p}, x, train=True), {}
        return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean(), (logits, st)

    if rest:  # the f32 forward only: BN models take the gradient in f64 below
        want, want_st = jax.jit(lambda p, r, x: loss(p, r, x, y)[1])(fv["params"], rest, x)
    else:
        (_, (want, want_st)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            fv["params"], rest, x, y)
    leaves = [t.clone().requires_grad_(True) for t in pt.tree_leaves(variables["params"])]
    p = pt.tree_unflatten_like(variables["params"], leaves)
    logits, new_st = model.apply({**variables, "params": p}, torch.from_numpy(x), True)
    assert logits.dtype == torch.float32 and logits.shape == (8, 10)
    want = np.asarray(want)
    np.testing.assert_allclose(logits.detach().numpy(), want, atol=1e-3 * np.abs(want).max(),
                               rtol=0)
    want_st = weights.flax_to_torch(jax.tree_util.tree_map(np.asarray, dict(want_st)))
    assert sorted(new_st) == sorted(want_st.get("batch_stats", {}))
    for a, b in zip(pt.tree_leaves(new_st), jax.tree_util.tree_leaves(want_st)):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-4, rtol=0)
    if rest:  # BatchNorm: the gradient in f64 (module docstring)
        model64 = dataclasses.replace(model, dtype=torch.float64)
        ref64 = ref_model.clone(dtype=jnp.float64)
        with jax.enable_x64():
            f64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), fv)
            (_, (_, _)), grads = jax.jit(jax.value_and_grad(
                lambda p, r, x, y: loss(p, r, x, y, ref64), has_aux=True))(
                f64["params"], {k: f64[k] for k in rest}, jnp.asarray(x, jnp.float64), y)
            want_g = jax.tree_util.tree_leaves(weights.flax_to_torch(
                jax.tree_util.tree_map(np.asarray, {"params": grads}))["params"])
        v64 = pt.tree_map(lambda t: t.double(), variables)
        leaves = [t.clone().requires_grad_(True) for t in pt.tree_leaves(v64["params"])]
        p = pt.tree_unflatten_like(v64["params"], leaves)
        logits, _ = model64.apply({**v64, "params": p}, torch.from_numpy(x).double(), True)
        got_g = torch.autograd.grad(torch.nn.functional.cross_entropy(
            logits.double(), torch.from_numpy(y).long()), leaves)
        got_flat = np.concatenate([g.numpy().ravel() for g in got_g])
        assert _rel_l2(got_flat, np.concatenate([g.ravel() for g in want_g])) < 1e-6
    else:
        got_g = torch.autograd.grad(torch.nn.functional.cross_entropy(
            logits, torch.from_numpy(y).long()), leaves)
        want_g = jax.tree_util.tree_leaves(weights.flax_to_torch(
            jax.tree_util.tree_map(np.asarray, {"params": grads}))["params"])
        for a, b in zip(got_g, want_g):
            np.testing.assert_allclose(a.numpy(), b, atol=1e-4 * np.abs(b).max() + 1e-9, rtol=0)

    other = _port_init(model, seed=1)
    x2 = torch.from_numpy(rs.randn(8, hw, hw, 3).astype(np.float32))
    lanes = pt.tree_map(lambda a, b: torch.stack([a, b]), variables, other)
    both, both_st = model.apply(lanes, torch.stack([torch.from_numpy(x), x2]), True)
    alone, alone_st = model.apply(other, x2, True)
    first, _ = model.apply(variables, torch.from_numpy(x), True)
    for got, want_lane in ((both[0], first), (both[1], alone)):
        if bitwise:
            assert torch.equal(got, want_lane)
        else:
            np.testing.assert_allclose(got.numpy(), want_lane.numpy(), atol=1e-5, rtol=0)
    for a, b in zip(pt.tree_leaves(both_st), pt.tree_leaves(alone_st)):
        np.testing.assert_allclose(a[1].numpy(), b.numpy(), atol=1e-6, rtol=0)
