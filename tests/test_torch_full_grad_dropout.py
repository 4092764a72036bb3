"""Port parity: dropout in the full-gradient pass (``fl/local_sgd.py``
``make_full_grad_fn`` / ``make_batched_full_grad_fn``) and FedSGD and Mime
with the FedAvg CNN (``model: cnn``, ``Dropout(0.5)``) against
``fedml_tpu``.

The reference draws batch ``i``'s dropout from ``fold_in(key, i)`` (Mime:
from its full-gradient key ``fold_in(key, 0x6D696D65)``), a local step's
from ``fold_in(fold_in(key, epoch), 2 + step)``.  The port takes every
mask as data; the tests copy the reference's in.  A mask depends only on
the key and the module, so it is read from ``Dropout_0``'s output on a
variable tree whose ``Dense_0`` kernel is zero and bias one (every input
to the dropout is 1: the output is non-zero exactly where it keeps).

f32, FEMNIST's 28x28x1 images and 62 classes.  Tolerances: one client's
full gradient within 1e-5 of each leaf's largest entry (measured 2.6e-7);
two rounds of each simulator, the port on MESH and sp against the JAX
package's MESH on one device, ``tests/test_torch_sim.py``'s tolerance for
trained ReLU networks: the global update within a relative L2 of 1e-2 and
each leaf within 5e-2 of its own update's largest entry (measured 2.7e-7 /
4.0e-7 for FedSGD, 1.2e-4 / 1.8e-3 for Mime on both backends: Mime's
server momentum carries the first round's last-bit differences into every
local step of the second; at a local lr of 0.05 instead of 0.01 that
reached 2.3e-3 / 1.8e-2 on MESH), round metrics within rtol 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from .test_torch_mesh import JaxSampler, _cfgs, _jax_sim, _port_vars

torch.set_num_threads(1)

MIME_GRAD_TAG = 0x6D696D65


def _mask_vars(ref_model, batch, shape):
    """The reference CNN's variables with every dropout input 1."""
    v = jax.tree_util.tree_map(np.asarray, ref_model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((batch,) + shape), train=False))
    v["params"]["Dense_0"]["kernel"] = np.zeros_like(v["params"]["Dense_0"]["kernel"])
    v["params"]["Dense_0"]["bias"] = np.ones_like(v["params"]["Dense_0"]["bias"])
    return v


def reference_mask(ref_model, mask_vars, dkey, batch, shape) -> np.ndarray:
    """The keep-mask the reference draws from ``dkey``."""
    _, inter = ref_model.apply(mask_vars, jnp.zeros((batch,) + shape), train=True,
                               rngs={"dropout": dkey}, capture_intermediates=True,
                               mutable=["intermediates"])
    return np.asarray(inter["intermediates"]["Dropout_0"]["__call__"][0]) != 0


class JaxDropoutSampler(JaxSampler):
    """:class:`JaxSampler` plus the reference's keep-masks: each local
    step's and each full-gradient batch's."""

    def __init__(self, root_key, n_total, per_round, ref_model, batch, shape, spe,
                 grad_tag=None):
        super().__init__(root_key, n_total, per_round)
        self.ref_model, self.batch, self.shape, self.spe = ref_model, batch, shape, spe
        self.grad_tag = grad_tag
        self.mask_vars = _mask_vars(ref_model, batch, shape)

    def _key(self, r, client):
        from fedml_tpu.core import rng

        return rng.client_key(rng.round_key(self.root, r), client)

    def _mask(self, dkey):
        return reference_mask(self.ref_model, self.mask_vars, dkey, self.batch, self.shape)

    def dropout(self, r, client, n_steps, shape, keep_prob, device):
        key = self._key(r, client)
        masks = [self._mask(jax.random.fold_in(jax.random.fold_in(key, s // self.spe),
                                               2 + s % self.spe)) for s in range(n_steps)]
        return torch.from_numpy(np.stack(masks)).to(device)

    def grad_dropout(self, r, client, n_batches, shape, keep_prob, device):
        key = self._key(r, client)
        if self.grad_tag is not None:
            key = jax.random.fold_in(key, self.grad_tag)
        masks = [self._mask(jax.random.fold_in(key, i)) for i in range(n_batches)]
        return torch.from_numpy(np.stack(masks)).to(device)


def test_full_grad_with_dropout_matches_reference():
    """One client's full-shard gradient (4 batches) given the reference's
    masks; the batched form's lanes equal it; a model with dropout without
    masks is refused."""
    from fedml_tpu.fl.local_sgd import make_full_grad_fn as ref_make
    from fedml_tpu.fl.types import HParams as RefHParams
    from fedml_tpu.models import simple as flax_simple
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.fl.local_sgd import make_batched_full_grad_fn, make_full_grad_fn
    from fedml_tpu_torch.fl.types import HParams
    from fedml_tpu_torch.models import simple

    ref_model, model = flax_simple.FedAvgCNN(num_classes=62), simple.FedAvgCNN(62)
    bsz, cap, shape = 4, 16, (28, 28, 1)
    rs = np.random.RandomState(0)
    x = rs.randn(cap, *shape).astype(np.float32)
    y = rs.randint(0, 62, cap).astype(np.int32)
    v = jax.tree_util.tree_map(np.asarray, ref_model.init(
        {"params": jax.random.PRNGKey(2), "dropout": jax.random.PRNGKey(3)}, x[:bsz],
        train=False))
    key = jax.random.PRNGKey(7)
    want = jax.jit(ref_make(ref_model, RefHParams(batch_size=bsz, steps_per_epoch=4)))(
        v, x, y, jnp.int32(cap), key)
    mv = _mask_vars(ref_model, bsz, shape)
    masks = torch.from_numpy(np.stack([reference_mask(ref_model, mv, jax.random.fold_in(key, i),
                                                      bsz, shape) for i in range(4)]))
    assert masks.shape == (4, bsz, 512) and 0.3 < float(masks.float().mean()) < 0.7
    hp = HParams(batch_size=bsz, steps_per_epoch=4, compute_dtype="float32")
    pv = _port_vars(v)
    got = make_full_grad_fn(model, hp)(pv, torch.from_numpy(x), torch.from_numpy(y).long(), masks)
    want = _port_vars({"params": want})["params"]
    for a, b in zip(pt.tree_leaves(got), pt.tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5 * float(b.abs().max()), rtol=0)
    with pytest.raises(ValueError, match="keep-mask"):
        make_full_grad_fn(model, hp)(pv, torch.from_numpy(x), torch.from_numpy(y).long())

    xs = torch.from_numpy(np.stack([x, x[::-1].copy()]))
    ys = torch.from_numpy(np.stack([y, y[::-1].copy()])).long()
    other = masks.flip(0)
    lanes = make_batched_full_grad_fn(model, hp)(pv, xs, ys, torch.tensor([1, 0]),
                                                 torch.stack([other, masks]))
    alone = make_full_grad_fn(model, hp)(pv, xs[1], ys[1], other)
    for a, b, c in zip(pt.tree_leaves(lanes), pt.tree_leaves(alone), pt.tree_leaves(got)):
        np.testing.assert_allclose(a[0].numpy(), b.numpy(), atol=1e-6 * float(b.abs().max()),
                                   rtol=0)
        np.testing.assert_allclose(a[1].numpy(), c.numpy(), atol=1e-6 * float(c.abs().max()),
                                   rtol=0)


@pytest.mark.parametrize("optimizer,backend", [("FedSGD", "MESH"), ("FedSGD", "sp"),
                                               ("Mime", "MESH"), ("Mime", "sp")])
def test_rounds_with_dropout_match_reference(tmp_path, optimizer, backend):
    """Two rounds of FedSGD / Mime on ``femnist`` with ``model: cnn``
    (module docstring)."""
    import fedml_tpu_torch
    from fedml_tpu.models import simple as flax_simple
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.models import model_hub
    from fedml_tpu_torch.sim.engine import MeshSimulator

    kw = dict(dataset="femnist", model="cnn", federated_optimizer=optimizer,
              synthetic_train_size=96, synthetic_test_size=40, learning_rate=0.01,
              partition_alpha=1.0, server_lr=0.5)
    ref_cfg, _ = _cfgs(tmp_path, **kw)
    _, cfg = _cfgs(tmp_path, backend_sim=backend, **kw)
    ref_model = flax_simple.FedAvgCNN(num_classes=62)
    ref_sim = _jax_sim(ref_cfg, ref_model)
    fedml_tpu_torch.init(cfg)
    ds = loader.load(cfg)
    model = model_hub.create(cfg, ds.class_num, input_shape=ds.train_x.shape[1:])
    assert model.dropout_shape(8) == (8, 512)
    sampler = JaxDropoutSampler(ref_sim.root_key, ds.n_clients, cfg.client_num_per_round,
                                ref_model, cfg.batch_size, (28, 28, 1),
                                ref_sim.hp.steps_per_epoch,
                                MIME_GRAD_TAG if optimizer == "Mime" else None)
    sim = MeshSimulator(cfg, ds, model, device="cpu", sampler=sampler)
    start = _port_vars(ref_sim.global_vars)
    sim.global_vars = pt.tree_map(torch.clone, start)
    ref_hist, hist = ref_sim.run(), sim.run()
    for a, b in zip(hist, ref_hist):
        for k in ("train_loss", "num_steps", "num_samples"):
            np.testing.assert_allclose(a[k], b[k], rtol=2e-4, atol=1e-7, err_msg=k)
    want = _port_vars(ref_sim.global_vars)
    got_u = [a - s for a, s in zip(pt.tree_leaves(sim.global_vars), pt.tree_leaves(start))]
    want_u = [b - s for b, s in zip(pt.tree_leaves(want), pt.tree_leaves(start))]
    flat_got, flat_want = torch.cat([u.reshape(-1) for u in got_u]), torch.cat(
        [u.reshape(-1) for u in want_u])
    assert float(flat_want.abs().max()) > 1e-3  # the rounds trained
    rel = float((flat_got - flat_want).norm() / flat_want.norm())
    assert rel < 1e-2, rel
    for a, b in zip(got_u, want_u):
        assert float((a - b).abs().max()) <= 5e-2 * float(b.abs().max()) + 1e-7
