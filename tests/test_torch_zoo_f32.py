"""Port parity, third part: the BatchNorm zoo's f32 gradient against
flax's f32 gradient (``tests/test_torch_zoo.py`` compares it in f64).

At 32x32 inputs (EfficientNet-B0 at 16x16, for time) and a batch of 16
(BatchNorm's last reductions span 16 values or more), three seeds a
model, the weights drawn as in ``test_torch_zoo.py``.  The f32 gradient of
these nets is ill-conditioned: a ReLU after a BN flips where two f32
forwards differ in the last bits, so on some seeds either side's f32
gradient lies far from the f64 one.  Measured on the CPU (relative L2,
seeds 0 / 1 / 2), flax's own f32 gradient against its f64 one:
EfficientNet-B0 2.3e-5 / 2.8e-5 / 3.6e-5, MobileNetV1 2.3e-2 / 2.6e-2 /
3.2e-2, MobileNetV3 7.1e-6 / 7.8e-4 / 7.6e-6, VGG-11 8.3e-6 / 3.8e-3 /
6.7e-6; the port's: 1.7e-5 / 1.8e-5 / 1.7e-5, 2.2e-3 / 6.3e-3 / 1.3e-2,
2.4e-6 / 2.3e-6 / 2.4e-6, 1.9e-4 / 3.7e-6 / 3.6e-6.  So a model is held
over its seeds, each seed scaled by flax's own f32 error on it:

- the port's f32 gradient against flax's f32 gradient (relative L2): the
  median over the seeds of its ratio to flax's f32 error at most 4
  (measured at most 1.13);
- the port's f32 error against flax's f64 gradient: the median ratio to
  flax's at most 3 (measured at most 0.63).

A flip is an event of one seed on one side; a fault of the port's f32
path (a cast, a reduction in another dtype) moves every seed.
"""

import numpy as np
import pytest
import torch

from .test_torch_zoo import _cases, _flax, _port_init, _rel_l2

torch.set_num_threads(1)

SEEDS = (0, 1, 2)
BATCH, SIZE = 16, 32


def _flat(grads):
    from fedml_tpu_torch import weights

    import jax

    return np.concatenate([np.asarray(a, np.float64).ravel() for a in jax.tree_util.tree_leaves(
        weights.flax_to_torch(jax.tree_util.tree_map(np.asarray, {"params": grads}))["params"])])


@pytest.mark.parametrize("case", ["efficientnet-batch", "mobilenet-batch", "mobilenet_v3-batch",
                                  "vgg11-batch"])
def test_bn_zoo_f32_gradient_matches_flax_f32(case):
    import jax
    import jax.numpy as jnp
    import optax

    from fedml_tpu_torch.core import pytree as pt

    ref_model, model, _, _ = _cases()[case]
    ref64 = ref_model.clone(dtype=jnp.float64)

    def loss(p, rest, x, y, m):
        logits, _ = m.apply({"params": p, **rest}, x, train=True, mutable=list(rest))
        return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()

    grad32 = jax.jit(jax.grad(lambda p, r, x, y: loss(p, r, x, y, ref_model)))
    grad64 = jax.jit(jax.grad(lambda p, r, x, y: loss(p, r, x, y, ref64)))
    direct, port_err, ref_err = [], [], []
    for seed in SEEDS:
        rs = np.random.RandomState(seed)
        size = 16 if case.startswith("efficientnet") else SIZE
        x = rs.randn(BATCH, size, size, 3).astype(np.float32)
        y = rs.randint(0, 10, BATCH).astype(np.int32)
        variables = _port_init(model, seed)
        fv = _flax(variables)
        rest = {k: v for k, v in fv.items() if k != "params"}
        want32 = _flat(grad32(fv["params"], rest, x, y))
        with jax.enable_x64():
            f64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), fv)
            want64 = _flat(grad64(f64["params"], {k: f64[k] for k in rest},
                                  jnp.asarray(x, jnp.float64), y))
        leaves = [t.clone().requires_grad_(True) for t in pt.tree_leaves(variables["params"])]
        p = pt.tree_unflatten_like(variables["params"], leaves)
        logits, _ = model.apply({**variables, "params": p}, torch.from_numpy(x), True)
        assert logits.dtype == torch.float32
        got = torch.autograd.grad(torch.nn.functional.cross_entropy(
            logits, torch.from_numpy(y).long()), leaves)
        assert all(g.dtype == torch.float32 for g in got)
        got = np.concatenate([g.double().numpy().ravel() for g in got])
        direct.append(_rel_l2(got, want32))
        port_err.append(_rel_l2(got, want64))
        ref_err.append(_rel_l2(want32, want64))
    readings = f"f32 vs f32 {direct}, port vs f64 {port_err}, flax f32 vs f64 {ref_err}"
    ref_err = np.asarray(ref_err)
    assert np.median(np.asarray(direct) / ref_err) <= 4, readings
    assert np.median(np.asarray(port_err) / ref_err) <= 3, readings
