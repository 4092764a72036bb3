"""Port parity: the LSTMs (``fedml_tpu_torch/models/rnn.py``) against
``fedml_tpu/models/rnn.py``, and FedAvg on Shakespeare with the character
LSTM through both simulators.

The models at tiny widths built directly (the published widths only for
the parameter counts): the port draws the weights and carries them to flax
(``weights.torch_to_flax``: the gate kernels transposed as Dense kernels,
``Embed_0/embedding`` as it is), the flax tree's names and shapes from
``jax.eval_shape`` of the reference's init.  f32 (the reference's LSTMs
take no dtype), the flax side jitted: logits and the sequence CE gradient
within 1e-5 of their scale (measured 5e-8 and 6e-8 after 7 steps; torch's
and XLA's sum orders differ only in the last bits), the lane form
bitwise each model alone.

FedAvg (``test_fedavg_shakespeare_matches_reference``): two rounds of 3 of
4 clients on the synthetic Shakespeare stream (80 characters a sequence,
vocab 90), a CharLSTM of hidden 16, the JAX package's MESH simulator on one
device against the port's MESH and sp, the port given the reference's
initial weights, sampled ids and permutations (``tests/test_torch_mesh.py``'s
sampler hook).  Globals within rtol 2e-4 / atol 2e-5 of the reference's
(its own MESH-vs-SP tolerance; measured 1.2e-7 after 2 rounds on both
backends, against an update of 4.2e-2: the 80 recurrent steps compound
f32 ulps far less than that), round and test metrics within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from .test_torch_mesh import JaxSampler, _cfgs, _jax_sim, _port_vars

torch.set_num_threads(1)


def _pairs():
    from fedml_tpu.models import rnn as fr
    from fedml_tpu_torch.models import rnn

    return {"char": (fr.CharLSTM(11, 3, 5), rnn.CharLSTM(11, 3, 5)),
            "word": (fr.WordLSTM(13, 4, 6), rnn.WordLSTM(13, 4, 6))}


def _flax(tree):
    from fedml_tpu_torch import weights

    return weights.torch_to_flax(weights.to_numpy(tree))


@pytest.mark.parametrize("name", ["char", "word"])
def test_lstm_matches_flax(name):
    """Tree, logits, gradient and lanes (module docstring)."""
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.core import pytree as pt

    ref_model, model = _pairs()[name]
    rs = np.random.RandomState(0)
    x = rs.randint(0, model.vocab_size, (3, 7)).astype(np.int32)
    y = rs.randint(0, model.vocab_size, (3, 7)).astype(np.int32)
    variables = model.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    variables = pt.tree_map(lambda t: t + 0.1 * torch.randn(t.shape, generator=g), variables)
    want_tree = jax.eval_shape(lambda: ref_model.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    fv = _flax(variables)
    assert jax.tree_util.tree_structure(want_tree) == jax.tree_util.tree_structure(fv)
    assert ([a.shape for a in jax.tree_util.tree_leaves(want_tree)]
            == [a.shape for a in jax.tree_util.tree_leaves(fv)])

    def loss(p, x, y):
        logits = ref_model.apply({"params": p}, x)
        return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean(), logits

    (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(fv["params"], x, y)
    leaves = [t.clone().requires_grad_(True) for t in pt.tree_leaves(variables["params"])]
    p = pt.tree_unflatten_like(variables["params"], leaves)
    tokens = torch.from_numpy(x)
    logits, stats = model.apply({"params": p}, tokens, True)
    assert stats == {} and logits.dtype == torch.float32
    assert logits.shape == (3, 7, model.vocab_size)
    want = np.asarray(want)
    np.testing.assert_allclose(logits.detach().numpy(), want, atol=1e-5 * np.abs(want).max(),
                               rtol=0)
    got_g = torch.autograd.grad(torch.nn.functional.cross_entropy(
        logits.reshape(-1, model.vocab_size), torch.from_numpy(y).long().reshape(-1)), leaves)
    want_g = jax.tree_util.tree_leaves(weights.flax_to_torch(
        jax.tree_util.tree_map(np.asarray, {"params": grads}))["params"])
    for a, b in zip(got_g, want_g):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5 * np.abs(b).max(), rtol=0)

    other = model.init(torch.Generator().manual_seed(2))
    x2 = torch.from_numpy(rs.randint(0, model.vocab_size, (3, 7)))
    lanes = pt.tree_map(lambda a, b: torch.stack([a, b]), variables, other)
    both, _ = model.apply(lanes, torch.stack([tokens, x2]), True)
    first, _ = model.apply(variables, tokens, True)
    alone, _ = model.apply(other, x2, True)
    assert torch.equal(both[0], first) and torch.equal(both[1], alone)


def test_lstm_cell_and_carry():
    """One layer written out step by step from a zero carry, the gates in
    flax's order (i, f, g, o) and ``z = (h W_h + b_h) + x W_i``."""
    from fedml_tpu_torch.models.rnn import CharLSTM, lstm_layer

    variables = CharLSTM(7, 3, 4).init(torch.Generator().manual_seed(0))
    cell = variables["params"]["StackedLSTM_0"]["OptimizedLSTMCell_0"]
    x = torch.randn(2, 5, 3, generator=torch.Generator().manual_seed(1))
    got = lstm_layer({k: {n: t[None] for n, t in v.items()} for k, v in cell.items()}, x[None])[0]
    h = c = torch.zeros(2, 4)
    for t in range(5):
        z = {g: (h @ cell[f"h{g}"]["kernel"].T + cell[f"h{g}"]["bias"])
             + x[:, t] @ cell[f"i{g}"]["kernel"].T for g in "ifgo"}
        c = torch.sigmoid(z["f"]) * c + torch.sigmoid(z["i"]) * torch.tanh(z["g"])
        h = torch.sigmoid(z["o"]) * torch.tanh(c)
        np.testing.assert_allclose(got[:, t].numpy(), h.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("name,cls,vocab,count", [
    ("rnn", "CharLSTM", 90, 820522), ("char_lstm", "CharLSTM", 90, 820522),
    ("rnn_originalfedavg", "CharLSTM", 90, 820522),
    ("rnn_stackoverflow", "WordLSTM", 10004, 4050748), ("word_lstm", "WordLSTM", 10004, 4050748)])
def test_hub_creates_the_lstms(name, cls, vocab, count):
    """Every LSTM name through both hubs at the published widths: the
    class, the vocabulary from ``output_dim``, the flax tree and the
    parameter count."""
    from fedml_tpu.arguments import Config as RefConfig
    from fedml_tpu.models import model_hub as ref_hub
    from fedml_tpu_torch.arguments import Config
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.models import model_hub

    model = model_hub.create(Config(model=name, dataset="shakespeare"), vocab)
    ref_model = ref_hub.create(RefConfig(model=name, dataset="shakespeare"), vocab)
    assert type(model).__name__ == type(ref_model).__name__ == cls
    variables = model.init(torch.Generator().manual_seed(0))
    want = jax.eval_shape(lambda: ref_model.init(jax.random.PRNGKey(0),
                                                 jnp.zeros((1, 4), jnp.int32)))
    fv = _flax(variables)
    assert jax.tree_util.tree_structure(want) == jax.tree_util.tree_structure(fv)
    assert ([a.shape for a in jax.tree_util.tree_leaves(want)]
            == [a.shape for a in jax.tree_util.tree_leaves(fv)])
    assert sum(t.numel() for t in pt.tree_leaves(variables)) == count


@pytest.mark.parametrize("backend", ["MESH", "sp"])
def test_fedavg_shakespeare_matches_reference(tmp_path, backend):
    """Two FedAvg rounds of the character LSTM (module docstring)."""
    import fedml_tpu_torch
    from fedml_tpu.models import rnn as fr
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.models import rnn
    from fedml_tpu_torch.sim.engine import MeshSimulator

    kw = dict(dataset="shakespeare", model="rnn", synthetic_train_size=96,
              synthetic_test_size=40, learning_rate=0.5, partition_alpha=1.0)
    ref_cfg, _ = _cfgs(tmp_path, **kw)
    _, cfg = _cfgs(tmp_path, backend_sim=backend, **kw)
    ref_sim = _jax_sim(ref_cfg, fr.CharLSTM(vocab_size=90, hidden=16))
    fedml_tpu_torch.init(cfg)
    ds = loader.load(cfg)
    assert ds.train_x.dtype == np.int32 and ds.train_x.shape == (96, 80)
    sim = MeshSimulator(cfg, ds, rnn.CharLSTM(vocab_size=90, hidden=16), device="cpu",
                        sampler=JaxSampler(ref_sim.root_key, ds.n_clients,
                                           cfg.client_num_per_round))
    assert sim._data[0].dtype == torch.int32  # token ids are never cast
    start = _port_vars(ref_sim.global_vars)
    sim.global_vars = pt.tree_map(torch.clone, start)
    ref_hist, hist = ref_sim.run(), sim.run()
    assert len(hist) == len(ref_hist) == 2
    for a, b in zip(hist, ref_hist):
        for k in ("train_loss", "num_steps", "num_samples"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)
    for k in ("test_loss", "test_acc"):
        np.testing.assert_allclose(hist[-1][k], ref_hist[-1][k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    want = _port_vars(ref_sim.global_vars)
    moved = 0.0
    for a, b, s in zip(pt.tree_leaves(sim.global_vars), pt.tree_leaves(want),
                       pt.tree_leaves(start)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=2e-5)
        moved = max(moved, float((b - s).abs().max()))
    assert moved > 1e-3  # the rounds trained
