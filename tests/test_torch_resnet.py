"""Port parity: CIFAR ResNets (``models/resnet.py``) and ``weights.py``.

flax variables drawn by the JAX package are converted into the port's
layout, so both sides start from the same weights; inputs come from numpy.
f32 throughout; tolerances: logits rtol/atol 1e-4, grads rtol 1e-3 / atol
1e-5 (the fused and unfused JAX models themselves agree only to that in
``tests/test_pallas.py``), batch stats rtol 1e-4 / atol 1e-6.  JAX runs
eagerly (no jit) to keep the file's compile time small.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

X_SHAPE = (4, 8, 8, 3)  # three stages still downsample: 8 -> 4 -> 2


def _flax_model(num_blocks, fused):
    from fedml_tpu.models import resnet

    return resnet.CifarResNet(num_blocks=num_blocks, fused=fused)


def _flax_vars(num_blocks, x):
    m = _flax_model(num_blocks, False)
    k = jax.random.PRNGKey(num_blocks)
    return jax.tree_util.tree_map(np.asarray, m.init({"params": k, "dropout": k}, x, train=True))


def _x(seed=0):
    return np.random.RandomState(seed).randn(*X_SHAPE).astype(np.float32)


def test_weights_round_trip_and_layouts():
    from fedml_tpu_torch import weights

    v = _flax_vars(1, _x())
    t = weights.flax_to_torch(v)
    assert t["params"]["Conv_0"]["kernel"].shape == (16, 3, 3, 3)
    assert v["params"]["Dense_0"]["kernel"].shape == (64, 10)
    assert t["params"]["Dense_0"]["kernel"].shape == (10, 64)
    back = weights.torch_to_flax(t)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(v)
    for a, b in zip(jax.tree_util.tree_leaves(v), jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    tt = weights.to_numpy(weights.to_torch(t))
    for a, b in zip(jax.tree_util.tree_leaves(t), jax.tree_util.tree_leaves(tt)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("num_blocks", [1, 3])
def test_port_tree_matches_flax_and_fused_equals_unfused(num_blocks):
    """The port's variable tree has the flax keys and (converted) shapes; the
    fused and unfused models draw identical trees."""
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.models import resnet

    flax_v = weights.flax_to_torch(_flax_vars(num_blocks, _x()))
    gens = [torch.Generator().manual_seed(3) for _ in range(2)]
    unfused = resnet.CifarResNet(num_blocks).init(gens[0])
    fused = resnet.CifarResNet(num_blocks, fused=True).init(gens[1])
    port = weights.to_numpy(unfused)
    assert jax.tree_util.tree_structure(port) == jax.tree_util.tree_structure(flax_v)
    for a, b in zip(jax.tree_util.tree_leaves(port), jax.tree_util.tree_leaves(flax_v)):
        assert a.shape == b.shape and a.dtype == b.dtype
    for a, b in zip(jax.tree_util.tree_leaves(weights.to_numpy(fused)), jax.tree_util.tree_leaves(port)):
        np.testing.assert_array_equal(a, b)


def test_init_follows_lecun_normal():
    """Conv/Dense kernels: truncated normal in +-2 std scaled to std
    sqrt(1/fan_in), as flax's lecun_normal; BN and bias start at 1/0/0/1."""
    from fedml_tpu_torch.models import resnet

    v = resnet.resnet20().init(torch.Generator().manual_seed(0))
    w = v["params"]["BasicBlock_8"]["Conv_1"]["kernel"]  # 64x64x3x3
    fan_in = 64 * 9
    assert abs(float(w.std()) * np.sqrt(fan_in) - 1.0) < 0.03
    std = np.sqrt(1.0 / fan_in) / 0.87962566103423978
    assert float(w.abs().max()) <= 2 * std + 1e-7
    assert torch.equal(v["params"]["Dense_0"]["bias"], torch.zeros(10))
    bn = v["params"]["BasicBlock_0"]["BatchNorm_1"]
    st = v["batch_stats"]["BasicBlock_0"]["BatchNorm_1"]
    assert torch.equal(bn["scale"], torch.ones(16)) and torch.equal(bn["bias"], torch.zeros(16))
    assert torch.equal(st["mean"], torch.zeros(16)) and torch.equal(st["var"], torch.ones(16))


def _loss_jax(m, params, stats, x):
    logits, new = m.apply({"params": params, "batch_stats": stats}, x, train=True,
                          mutable=["batch_stats"])
    return jnp.mean((logits.astype(jnp.float32) - 1.0) ** 2), (logits, new["batch_stats"])


@pytest.mark.parametrize("num_blocks", [1, 3], ids=["blocks1", "resnet20"])
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_resnet_matches_flax_f32(num_blocks, fused):
    """(d) logits, grads and updated batch_stats in train mode, and logits in
    eval mode (with non-trivial running stats), from transferred weights."""
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.models import resnet

    x = _x(1)
    v = _flax_vars(num_blocks, x)
    m = _flax_model(num_blocks, fused)
    (_, (logits, new_stats)), grads = jax.value_and_grad(
        lambda p: _loss_jax(m, p, v["batch_stats"], x), has_aux=True)(v["params"])

    model = resnet.CifarResNet(num_blocks, fused=fused)
    tv = weights.to_torch(weights.flax_to_torch(v))
    leaves = [t.requires_grad_(True) for t in pt.tree_leaves(tv["params"])]
    params = pt.tree_unflatten_like(tv["params"], leaves)
    t_logits, t_stats = model.apply({"params": params, "batch_stats": tv["batch_stats"]},
                                    torch.from_numpy(x), train=True)
    loss = (t_logits.float() - 1.0).square().mean()
    t_grads = torch.autograd.grad(loss, leaves)

    np.testing.assert_allclose(t_logits.detach().numpy(), np.asarray(logits), rtol=1e-4, atol=1e-4)
    ref_grads = weights.flax_to_torch({"params": jax.tree_util.tree_map(np.asarray, grads)})["params"]
    for a, b in zip(t_grads, jax.tree_util.tree_leaves(ref_grads)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-3, atol=1e-5)
    ref_stats = jax.tree_util.tree_map(np.asarray, new_stats)
    for a, b in zip(pt.tree_leaves(t_stats), jax.tree_util.tree_leaves(ref_stats)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-6)

    eval_vars = {"params": v["params"], "batch_stats": ref_stats}
    e_logits = m.apply(eval_vars, x, train=False)
    te, te_stats = model.apply(weights.to_torch(weights.flax_to_torch(eval_vars)),
                               torch.from_numpy(x), train=False)
    np.testing.assert_allclose(te.numpy(), np.asarray(e_logits), rtol=1e-4, atol=1e-4)
    for a, b in zip(pt.tree_leaves(te_stats), jax.tree_util.tree_leaves(ref_stats)):
        np.testing.assert_array_equal(a.numpy(), b)


def test_bf16_compute_close_to_flax():
    """bf16 compute (input and kernels cast per conv/dense, BN in f32):
    logits within 5e-2 of flax's bf16 model on the same weights."""
    from fedml_tpu.models import resnet as flax_resnet
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.models import resnet

    x = _x(2)
    v = _flax_vars(1, x)
    for fused in (False, True):
        m = flax_resnet.CifarResNet(num_blocks=1, dtype=jnp.bfloat16, fused=fused)
        ref, _ = m.apply(v, x, train=True, mutable=["batch_stats"])
        assert ref.dtype == jnp.bfloat16
        model = resnet.CifarResNet(1, dtype=torch.bfloat16, fused=fused)
        got, _ = model.apply(weights.to_torch(weights.flax_to_torch(v)), torch.from_numpy(x), True)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                                   rtol=5e-2, atol=5e-2)


def test_same_padding_stride2_is_flax_asymmetric():
    """flax SAME with stride 2 pads (0, 1); a symmetric torch padding=1 reads
    other positions.  The port's conv equals lax.conv_general_dilated."""
    from fedml_tpu_torch.models.resnet import conv2d_nhwc

    rs = np.random.RandomState(5)
    x = rs.randn(2, 8, 8, 4).astype(np.float32)
    k = rs.randn(3, 3, 4, 6).astype(np.float32)  # HWIO
    ref = jax.lax.conv_general_dilated(x, k, (2, 2), "SAME",
                                       dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = conv2d_nhwc(torch.from_numpy(x), torch.from_numpy(k.transpose(3, 2, 0, 1).copy()), 2,
                      torch.float32)
    assert got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    sym = torch.nn.functional.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                                     torch.from_numpy(k.transpose(3, 2, 0, 1).copy()),
                                     stride=2, padding=1).permute(0, 2, 3, 1)
    assert not np.allclose(sym.numpy(), np.asarray(ref), atol=1e-3)


def test_model_hub_creates_resnets_and_refuses_others():
    from fedml_tpu_torch.arguments import Config
    from fedml_tpu_torch.models import model_hub

    m = model_hub.create(Config(model="resnet56", compute_dtype="bfloat16",
                                extra={"fused_blocks": True}), 10)
    assert (m.num_blocks, m.dtype, m.fused) == (9, torch.bfloat16, True)
    assert model_hub.create(Config(model="resnet32", compute_dtype="float32"), 100).num_classes == 100
    gn = model_hub.create(Config(model="resnet20", norm="group",
                                 extra={"fused_blocks": True}), 10)
    assert (gn.norm, gn.fused_path) == ("group", False)  # GroupNorm ignores fused_blocks
    with pytest.raises(ValueError, match="unknown model"):
        model_hub.create(Config(model="no_such_model"), 10)
