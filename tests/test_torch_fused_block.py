"""Port parity: the fused BasicBlock epilogue (``ops/fused_block.py``).

On the CPU the port's wrappers run the kernels' plain PyTorch versions; the
JAX side runs the Pallas kernels in interpret mode, as
``tests/test_pallas.py`` does.  C = 24 is in every sweep: it does not
divide 128, so the JAX wrapper takes its jnp reference there while the
port's kernel takes any C.

Tolerances:
- forward f32: bitwise.  XLA:CPU contracts the kernel's ``y * s + b`` into
  one FMA (one rounding where the plain version rounds twice), so the
  bitwise comparison with the interpret kernel uses power-of-two scales,
  whose products are exact and make both forms round once; with general
  scales the port is bitwise the JAX reference evaluated op by op and
  within 1 ulp (rtol 2**-23) of the contracted kernel;
- grads: dy / dr to rtol 1e-6, d_scale / d_shift to rtol/atol 1e-5 (f32
  sums in another order);
- bf16: within 1e-2 of each other and of the f32 ground truth, as in
  ``tests/test_pallas.py``.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

SHAPES = [(3, 7, 9, 16), (2, 5, 5, 24), (4, 8, 8, 16)]


def _inputs(shape, seed=0, pow2_scale=False):
    rs = np.random.RandomState(seed)
    y = rs.randn(*shape).astype(np.float32)
    r = rs.randn(*shape).astype(np.float32)
    g = rs.randn(*shape).astype(np.float32)
    c = shape[-1]
    if pow2_scale:
        s = (rs.choice([-1.0, 1.0], c) * 2.0 ** rs.randint(-3, 4, c)).astype(np.float32)
    else:
        s = rs.randn(c).astype(np.float32)
    b = rs.randn(c).astype(np.float32)
    return y, r, g, s, b


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_bitwise_vs_interpret_kernel(shape):
    """(c) forward: the port equals fused_bn_relu / fused_bn_residual_relu
    (interpret=True) bitwise in f32."""
    from fedml_tpu.ops.pallas import fused_bn_relu as jax_relu
    from fedml_tpu.ops.pallas import fused_bn_residual_relu as jax_res
    from fedml_tpu_torch.ops import fused_block as fb

    y, r, _, s, b = _inputs(shape, pow2_scale=True)
    ref = np.asarray(jax.jit(partial(jax_res, interpret=True))(y, s, b, r))
    ref2 = np.asarray(jax.jit(partial(jax_relu, interpret=True))(y, s, b))
    ty, tr, ts, tb = _t(y, r, s, b)
    np.testing.assert_array_equal(fb.fused_bn_residual_relu(ty, ts, tb, tr).numpy(), ref)
    np.testing.assert_array_equal(fb.fused_bn_relu(ty, ts, tb).numpy(), ref2)
    np.testing.assert_array_equal(fb.fused_block_reference(ty, ts, tb, tr).numpy(), ref)


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_general_scales(shape):
    """General scales: bitwise the JAX reference op by op, 1 ulp of the
    FMA-contracted interpret kernel."""
    from fedml_tpu.ops.pallas import fused_block_reference as jax_ref
    from fedml_tpu.ops.pallas import fused_bn_residual_relu as jax_res
    from fedml_tpu_torch.ops import fused_block as fb

    y, r, _, s, b = _inputs(shape, seed=1)
    ty, tr, ts, tb = _t(y, r, s, b)
    got = fb.fused_bn_residual_relu(ty, ts, tb, tr).numpy()
    with jax.disable_jit():
        eager = np.asarray(jax_ref(y, s, b, r))
    np.testing.assert_array_equal(got, eager)
    kern = np.asarray(jax.jit(partial(jax_res, interpret=True))(y, s, b, r))
    np.testing.assert_allclose(got, kern, rtol=2.0 ** -23, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("residual", [False, True])
def test_grads_match_jax(shape, residual):
    """(c) gradients through the autograd.Function vs jax.grad of the
    interpret kernel's custom_vjp."""
    from fedml_tpu.ops.pallas import fused_bn_relu as jax_relu
    from fedml_tpu.ops.pallas import fused_bn_residual_relu as jax_res
    from fedml_tpu_torch.ops import fused_block as fb

    y, r, g, s, b = _inputs(shape, seed=2, pow2_scale=True)
    if residual:
        loss = lambda y, s, b, r: jnp.sum(jax_res(y, s, b, r, interpret=True) * g)  # noqa: E731
        ref = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(y, s, b, r)
    else:
        loss = lambda y, s, b: jnp.sum(jax_relu(y, s, b, interpret=True) * g)  # noqa: E731
        ref = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(y, s, b)
    leaves = [t.requires_grad_(True) for t in _t(y, s, b, r)[: 4 if residual else 3]]
    out = fb.fused_bn_residual_relu(*leaves) if residual else fb.fused_bn_relu(*leaves)
    got = torch.autograd.grad((out * torch.from_numpy(g)).sum(), leaves)
    names = ["dy", "d_scale", "d_shift", "dr"]
    for name, a, e in zip(names, got, ref):
        e = np.asarray(e)
        assert a.dtype == torch.float32 and tuple(a.shape) == e.shape, name
        if name in ("d_scale", "d_shift"):
            np.testing.assert_allclose(a.numpy(), e, rtol=1e-5, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_allclose(a.numpy(), e, rtol=1e-6, atol=0, err_msg=name)


def test_bwd_reference_matches_autograd_of_forward():
    """The explicit-mask backward equals autograd through the plain forward
    (the inputs have no exact zeros of the pre-activation)."""
    from fedml_tpu_torch.ops import fused_block as fb

    y, r, g, s, b = _t(*_inputs((2, 5, 5, 24), seed=3))
    leaves = [t.clone().requires_grad_(True) for t in (y, s, b, r)]
    out = fb.fused_block_reference(*leaves)
    ref = torch.autograd.grad((out * g).sum(), leaves)
    dy, ds, db, dr = fb.fused_block_bwd_reference(g, y, s, out.detach(), True)
    torch.testing.assert_close(dy, ref[0], rtol=0, atol=0)
    torch.testing.assert_close(dr, ref[3], rtol=0, atol=0)
    torch.testing.assert_close(ds, ref[1], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(db, ref[2], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(4, 8, 8, 16), (2, 5, 5, 24)])
def test_bf16_tolerance(shape):
    """(c) bf16 activations, f32 math inside, one cast at the end."""
    from fedml_tpu.ops.pallas import fused_bn_residual_relu as jax_res
    from fedml_tpu_torch.ops import fused_block as fb

    y, r, g, s, b = _inputs(shape, seed=4)
    y16, r16 = jnp.asarray(y, jnp.bfloat16), jnp.asarray(r, jnp.bfloat16)
    ref = np.asarray(jax.jit(partial(jax_res, interpret=True))(y16, s, b, r16), np.float32)
    ty = torch.from_numpy(np.array(y16.astype(jnp.float32))).to(torch.bfloat16)
    tr = torch.from_numpy(np.array(r16.astype(jnp.float32))).to(torch.bfloat16)
    ts, tb = _t(s, b)
    out = fb.fused_bn_residual_relu(ty, ts, tb, tr)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=1e-2, atol=1e-2)
    truth = fb.fused_block_reference(ty.float(), ts, tb, tr.float()).numpy()
    np.testing.assert_allclose(out.float().numpy(), truth, rtol=1e-2, atol=1e-2)
    ty.requires_grad_(True)
    dy, = torch.autograd.grad(fb.fused_bn_residual_relu(ty, ts, tb, tr).float().sum(), [ty])
    assert dy.dtype == torch.bfloat16 and bool(torch.isfinite(dy.float()).all())


def test_cpu_path_launches_no_kernel_and_other_devices_raise():
    """On a CPU tensor the wrapper takes the plain version (no launch is
    counted); a device without a kernel raises instead of falling back."""
    from fedml_tpu_torch.ops import fused_block as fb

    fb.reset_launch_counts()
    y, r, g, s, b = _t(*_inputs((2, 4, 4, 16), seed=5))
    fb.fused_bn_residual_relu(y, s, b, r)
    assert set(fb.launch_counts()) == {k.name for k in fb.KERNELS}
    assert all(v == 0 for v in fb.launch_counts().values())
    with pytest.raises(RuntimeError, match="no kernel"):
        fb.fused_block_forward(y.to("meta"), s.to("meta"), b.to("meta"))
    with pytest.raises(RuntimeError, match="no kernel"):
        fb.fused_block_backward(g.to("meta"), y.to("meta"), s.to("meta"), y.to("meta"), False)


def test_kernel_operand_checks():
    """The kernel wrapper takes only a contiguous NHWC f32/bf16 tensor with
    matching f32 per-channel vectors, and raises on anything else."""
    from fedml_tpu_torch.ops import fused_block as fb

    y, r, _, s, b = _t(*_inputs((2, 4, 4, 16), seed=6))
    fb._check(y, (s, b), (r,))
    with pytest.raises(ValueError, match="contiguous NHWC"):
        fb._check(y.permute(0, 3, 1, 2), (s, b), ())
    with pytest.raises(ValueError, match="contiguous NHWC"):
        fb._check(y.reshape(-1, 16), (s, b), ())
    with pytest.raises(TypeError):
        fb._check(y.double(), (s, b), ())
    with pytest.raises(ValueError, match="per-channel"):
        fb._check(y, (s[:8], b), ())
    with pytest.raises(ValueError, match="per-channel"):
        fb._check(y, (s.to(torch.bfloat16), b), ())
    with pytest.raises(ValueError, match="match"):
        fb._check(y, (s, b), (r.to(torch.bfloat16),))
