"""Port parity: DLG, the gradient-inversion attack and label revelation
(``fedml_tpu_torch/trust/attack/dlg.py``) and the client-side Soteria
sensitivity and mask (``fedml_tpu_torch/trust/defense/soteria.py``) against
``fedml_tpu/trust/`` on the CPU, and the second-order decision of the fused
blocks.

- Second order through the fused blocks: the reference's
  ``invert_gradient_attack`` through a ResNet-20 with ``extra.fused_blocks``
  (its Pallas kernels in interpret mode) fails with JAX's "Linearization
  failed" ``ValueError``; the port raises a ``RuntimeError`` that names it.
  Without the fused blocks both compute.
- DLG and the inversion on the LR model (60 features, 10 classes) from the
  reference's ``jax.random`` starts: the reconstruction within rtol 1e-4 /
  atol 1e-5 and the final loss within rtol 1e-4 after 25 Adam steps (the
  gradients of gradients sum in another order; the inversion's sign step
  is exact while no component is near zero).
- Label revelation: bitwise (a sign).
- Soteria's sensitivity within rtol 1e-5 / atol 1e-7 and its mask equal,
  pruning exactly the features below its percentile.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from .conftest import tiny_config

torch.set_num_threads(1)

STEPS = 25
RTOL, ATOL = 1e-4, 1e-5


def _lr_models(n_classes=10):
    import fedml_tpu
    import fedml_tpu_torch
    import fedml_tpu_torch.arguments as args
    from fedml_tpu.models import model_hub as ref_hub
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.models import model_hub

    cfg = tiny_config()
    fedml_tpu.init(cfg)
    ref_model = ref_hub.create(cfg, n_classes)
    x_true = jax.random.normal(jax.random.PRNGKey(0), (2, 60))
    ref_vars = ref_model.init({"params": jax.random.PRNGKey(1)}, x_true, train=True)
    pcfg = args.Config(**{k: getattr(cfg, k) for k in ("model", "dataset")})
    fedml_tpu_torch.init(pcfg)
    model = model_hub.create(pcfg, n_classes, input_shape=(60,))
    variables = weights.to_torch(weights.flax_to_torch(jax.device_get(ref_vars)), "cpu")
    return ref_model, ref_vars, model, variables, np.array(x_true)


def _ref_loss(model):
    def loss(v, x, y_onehot):
        logits = model.apply(v, x, train=False)
        return -jnp.mean(jnp.sum(jax.nn.log_softmax(logits) * y_onehot, axis=-1))

    return loss


def _port_grad_fn(model, variables):
    params = variables["params"]

    def loss(p, x, y_onehot):
        logits, _ = model.apply({"params": p}, x, train=False)
        return -torch.mean(torch.sum(torch.log_softmax(logits, -1) * y_onehot, dim=-1))

    def grad_fn(x, y_onehot):
        from fedml_tpu_torch.core import pytree as pt

        p = pt.tree_map(lambda t: t.detach().requires_grad_(True), params)
        flat = pt.tree_leaves(p)
        return list(torch.autograd.grad(loss(p, x, y_onehot), flat, create_graph=True))

    return loss, grad_fn


def test_revealing_labels_bitwise():
    from fedml_tpu.trust.attack.dlg import revealing_labels_from_gradients as ref_reveal
    from fedml_tpu_torch.trust.attack.dlg import revealing_labels_from_gradients

    ref_model, ref_vars, model, variables, x = _lr_models()
    y = np.array([3, 7])
    rg = jax.grad(_ref_loss(ref_model))(ref_vars, jnp.asarray(x), jax.nn.one_hot(y, 10))
    _, grad_fn = _port_grad_fn(model, variables)
    pg = grad_fn(torch.from_numpy(x), torch.nn.functional.one_hot(torch.from_numpy(y), 10).float())
    want = np.asarray(ref_reveal(rg["params"]["Dense_0"]["bias"]))
    got = revealing_labels_from_gradients(pg[0].detach()).numpy()
    assert np.array_equal(got, want) and got[3] and got[7]


def test_dlg_matches_the_reference_on_lr():
    from fedml_tpu.trust.attack.dlg import dlg_attack as ref_dlg
    from fedml_tpu_torch.trust.attack.dlg import dlg_attack

    ref_model, ref_vars, model, variables, x = _lr_models()
    y = np.array([3, 7])
    ref_loss = _ref_loss(ref_model)
    victim = jax.grad(ref_loss)(ref_vars, jnp.asarray(x), jax.nn.one_hot(y, 10))

    def ref_grad_fn(xx, y_soft):
        return jax.grad(ref_loss)(ref_vars, xx, y_soft)

    key = jax.random.PRNGKey(5)
    want_x, want_y, want_loss = ref_dlg(ref_grad_fn, victim, x.shape, 10, key, steps=STEPS,
                                        lr=0.1)
    # the reference's starts (its L50-51)
    kx, ky = jax.random.split(key)
    x0 = np.array(jax.random.normal(kx, x.shape) * 0.1)
    y0 = np.array(jax.random.normal(ky, (x.shape[0], 10)) * 0.1)
    _, grad_fn = _port_grad_fn(model, variables)
    pvictim = grad_fn(torch.from_numpy(x), torch.nn.functional.one_hot(
        torch.from_numpy(y), 10).float())
    got_x, got_y, got_loss = dlg_attack(grad_fn, [g.detach() for g in pvictim], x.shape, 10,
                                        x0=torch.from_numpy(x0), y0=torch.from_numpy(y0),
                                        steps=STEPS, lr=0.1)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=RTOL, atol=1e-7)


def test_invert_gradient_attack_matches_the_reference_and_reconstructs():
    """The inversion from the reference's start, step for step; run long
    (400 steps, lr 0.05, as ``tests/test_obs.py`` runs it) the port's
    reconstruction beats its random start by the reference's 0.6 factor."""
    from fedml_tpu.trust.attack.dlg import invert_gradient_attack as ref_invert
    from fedml_tpu_torch.trust.attack.dlg import invert_gradient_attack

    ref_model, ref_vars, model, variables, x = _lr_models()
    y = np.array([3, 7])
    ref_loss = _ref_loss(ref_model)
    victim = jax.grad(ref_loss)(ref_vars, jnp.asarray(x), jax.nn.one_hot(y, 10))

    def ref_grad_fn(xx, y_onehot):
        return jax.grad(ref_loss)(ref_vars, xx, y_onehot)

    key = jax.random.PRNGKey(2)
    want_x, want_loss = ref_invert(ref_grad_fn, victim, x.shape, jnp.asarray(y), key,
                                   steps=STEPS, lr=0.05)
    x0 = np.array(jax.random.normal(key, x.shape) * 0.1)  # its L113
    _, grad_fn = _port_grad_fn(model, variables)
    pvictim = [g.detach() for g in grad_fn(torch.from_numpy(x), torch.nn.functional.one_hot(
        torch.from_numpy(y), 10).float())]
    got_x, got_loss = invert_gradient_attack(grad_fn, pvictim, x.shape, torch.from_numpy(y),
                                             x0=torch.from_numpy(x0), steps=STEPS, lr=0.05)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=RTOL, atol=1e-6)
    long_x, final = invert_gradient_attack(grad_fn, pvictim, x.shape, torch.from_numpy(y),
                                           x0=torch.from_numpy(x0), steps=400, lr=0.05)
    err = float(np.abs(long_x.numpy() - x).mean())
    base = float(np.abs(x0 - x).mean())
    assert np.isfinite(float(final)) and err < 0.6 * base, (err, base)


def _resnet20(fused, pkg):
    if pkg == "ref":
        import fedml_tpu
        from fedml_tpu.models import model_hub

        cfg = tiny_config(model="resnet20", dataset="cifar10", extra={"fused_blocks": fused})
        fedml_tpu.init(cfg)
        return model_hub.create(cfg, 10)
    import fedml_tpu_torch
    import fedml_tpu_torch.arguments as args
    from fedml_tpu_torch.models import model_hub

    cfg = args.Config(model="resnet20", dataset="cifar10", compute_dtype="float32",
                      extra={"fused_blocks": fused})
    fedml_tpu_torch.init(cfg)
    return model_hub.create(cfg, 10)


def test_second_order_through_fused_blocks_fails_in_both_packages():
    """The step-1 decision: both packages refuse a gradient of a gradient
    through the fused blocks (the reference with JAX's linearization
    error, the port with a RuntimeError naming it); the unfused port
    ResNet-20 computes the same attack."""
    from fedml_tpu.trust.attack.dlg import invert_gradient_attack as ref_invert
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.core import rng
    from fedml_tpu_torch.ops.fused_block import SECOND_ORDER_REFUSAL
    from fedml_tpu_torch.trust.attack.dlg import invert_gradient_attack

    ref_model = _resnet20(True, "ref")
    x_true = jax.random.normal(jax.random.PRNGKey(0), (1, 32, 32, 3))
    ref_vars = ref_model.init({"params": jax.random.PRNGKey(1)}, x_true, train=True)
    ref_loss = _ref_loss(ref_model)
    victim = jax.grad(ref_loss)(ref_vars, x_true, jax.nn.one_hot(jnp.array([3]), 10))
    with pytest.raises(ValueError, match="Linearization failed"):
        ref_invert(lambda xx, yo: jax.grad(ref_loss)(ref_vars, xx, yo), victim, x_true.shape,
                   jnp.array([3]), jax.random.PRNGKey(2), steps=1)

    x = torch.from_numpy(np.asarray(x_true))
    y = torch.nn.functional.one_hot(torch.tensor([3]), 10).float()
    for fused in (True, False):
        model = _resnet20(fused, "port")
        variables = model.init(rng.generator(rng.root_key(0)), "cpu")

        def grad_fn(xx, yo, variables=variables, model=model, create_graph=True):
            p = pt.tree_map(lambda t: t.detach().requires_grad_(True), variables["params"])
            logits, _ = model.apply({**variables, "params": p}, xx, train=False)
            loss = -torch.mean(torch.sum(torch.log_softmax(logits, -1) * yo, dim=-1))
            return list(torch.autograd.grad(loss, pt.tree_leaves(p), create_graph=create_graph))

        # the victim's gradient is first order: it runs through the kernels
        pvictim = grad_fn(x, y, create_graph=False)
        if fused:
            with pytest.raises(RuntimeError) as info:
                invert_gradient_attack(grad_fn, pvictim, tuple(x.shape), torch.tensor([3]),
                                       steps=1)
            assert str(info.value) == SECOND_ORDER_REFUSAL
            assert "Linearization failed" in SECOND_ORDER_REFUSAL
        else:
            _, loss = invert_gradient_attack(grad_fn, pvictim, tuple(x.shape),
                                             torch.tensor([3]), steps=1)
            assert np.isfinite(float(loss))


@pytest.mark.parametrize("percentile", [1.0, 25.0])
def test_soteria_sensitivity_and_mask_match_the_reference(percentile):
    from fedml_tpu.trust.defense.soteria import soteria_mask as ref_mask
    from fedml_tpu_torch.trust.defense import soteria_mask, soteria_sensitivity

    ref_model, ref_vars, model, variables, x = _lr_models(n_classes=40)
    want_mask, want_sens = ref_mask(ref_model, ref_vars, jnp.asarray(x[0]), percentile)
    sens = soteria_sensitivity(model, variables, torch.from_numpy(x[0]))
    np.testing.assert_allclose(sens.numpy(), np.asarray(want_sens), rtol=1e-5, atol=1e-7)
    mask, _ = soteria_mask(model, variables, torch.from_numpy(x[0]), percentile)
    assert np.array_equal(mask.numpy(), np.asarray(want_mask))
    # it prunes exactly the features under its percentile
    thresh = np.percentile(sens.numpy(), percentile)
    assert int((mask == 0).sum()) == int((sens.numpy() < thresh).sum()) >= 1
