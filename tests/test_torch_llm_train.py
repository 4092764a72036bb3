"""Port parity: the LLM trainer (``llm/train.py``) against the JAX package's
``LLMTrainer``.

Both train the tiny transformer in f32 (``TransformerConfig.tiny`` at a
vocabulary of 64, two layers) from the reference's initial parameters on
the same token batches (numpy from a seed) for three steps of optax's
``chain(clip_by_global_norm, adamw(warmup_cosine_decay_schedule, b1 0.9,
b2 0.95, eps 1e-8, weight_decay))``, warm-up 1 step, so the first step
runs at rate 0 and the clip bites.  The reference runs on a one-device
``data`` mesh; the port in this process (``data:1``, the unsharded
trainer), and in two spawned ranks on ``data:2`` (ZeRO-3 storage: each
rank keeps half of every sharded leaf and of its moments) and on ``seq:2``
(ring attention).  Tolerances: the losses within rel 1e-5 and the
parameters within 1e-5 of the reference (f32 sums in another order); the
sequence-parallel step's logits and gradient against the port's dense step
at the ring's 2e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ._torch_rank_worker import spawn_ranks

torch.set_num_threads(1)

STEPS = 3
LOSS_REL = 1e-5
PARAM_TOL = 1e-5
RING_TOL = 2e-5
ARGS = dict(learning_rate=1e-2, warmup_steps=1, total_steps=4, weight_decay=0.1,
            grad_clip=1.0, batch_size=4, seq_len=16, seed=0)


def _batches():
    rs = np.random.RandomState(11)
    out = []
    for _ in range(STEPS):
        tokens = rs.randint(0, 64, (ARGS["batch_size"], ARGS["seq_len"])).astype(np.int32)
        out.append((tokens, np.roll(tokens, -1, axis=1)))
    return out


def _port_tcfg():
    from fedml_tpu_torch.models.transformer import TransformerConfig

    return dataclasses.replace(TransformerConfig.tiny(vocab_size=64), dtype=torch.float32,
                               logits_dtype=torch.float32)


@pytest.fixture(scope="module")
def reference():
    """The reference trainer's initial parameters, step losses and final
    parameters on a one-device mesh."""
    from flax.core import unfreeze

    from fedml_tpu.llm.train import LLMTrainArgs, LLMTrainer
    from fedml_tpu.models.transformer import TransformerConfig
    from fedml_tpu.parallel import mesh as meshlib

    tcfg = dataclasses.replace(TransformerConfig.tiny(vocab_size=64), dtype=jnp.float32,
                               logits_dtype=jnp.float32)
    trainer = LLMTrainer(tcfg, LLMTrainArgs(**ARGS),
                         mesh=meshlib.make_mesh(("data",), (1,), jax.devices()[:1]))
    init = jax.tree_util.tree_map(np.asarray, unfreeze(jax.device_get(trainer.params)))
    losses = [trainer.step(t, y)["loss"] for t, y in _batches()]
    final = jax.tree_util.tree_map(np.asarray, unfreeze(jax.device_get(trainer.params)))
    return init, losses, final


def _assert_params(got, want):
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                            jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(np.asarray(a), b, rtol=PARAM_TOL, atol=PARAM_TOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_warmup_cosine_schedule_is_optax():
    import optax

    from fedml_tpu_torch.llm.train import LLMTrainArgs, warmup_cosine_lr

    for args in (LLMTrainArgs(**ARGS), LLMTrainArgs(warmup_steps=3, total_steps=2),
                 LLMTrainArgs(warmup_steps=0, total_steps=5)):
        sched = optax.warmup_cosine_decay_schedule(
            0.0, args.learning_rate, args.warmup_steps,
            max(args.total_steps, args.warmup_steps + 1))
        # XLA's f32 cos and numpy's differ by an ulp, which 1 + cos near pi
        # magnifies (3.2e-7 relative at count 4 of 5)
        np.testing.assert_allclose([warmup_cosine_lr(c, args) for c in range(8)],
                                   [float(sched(c)) for c in range(8)], rtol=1e-6, atol=0)


def test_one_process_trainer_matches_the_reference(reference):
    """``data:1``: the step losses (and perplexities) and the parameters
    after three steps; ``n_params`` the reference's count."""
    from fedml_tpu_torch.llm.train import LLMTrainArgs, LLMTrainer

    init, losses, final = reference
    trainer = LLMTrainer(_port_tcfg(), LLMTrainArgs(**ARGS), device="cpu", params=init)
    hist = trainer.fit(iter(_batches()), steps=STEPS)
    np.testing.assert_allclose([h["loss"] for h in hist], losses, rtol=LOSS_REL)
    np.testing.assert_allclose([h["ppl"] for h in hist], np.exp(losses), rtol=LOSS_REL)
    assert [h["step"] for h in hist] == [1, 2, 3]
    _assert_params(trainer.whole_params(), final)
    assert trainer.n_params() == sum(a.size for a in jax.tree_util.tree_leaves(init))
    assert trainer.token_throughput(steps=1) > 0 and trainer.step_idx == STEPS + 3


@pytest.mark.parametrize("axis", ["data", "seq"])
def test_two_rank_trainer_matches_the_reference(tmp_path, reference, axis):
    """``data:2`` (ZeRO-3: each rank stores half of every sharded leaf and
    of its AdamW moments) and ``seq:2`` (ring attention): the losses and
    parameters of the reference's one-device run; on ``seq:2`` one step's
    logits and gradient against the port's dense step, at 2e-5."""
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.llm.train import LLMTrainArgs, LLMTrainer

    init, losses, final = reference
    batches = _batches()
    ranks = spawn_ranks("llm", 2, tmp_path, {
        "tcfg": _port_tcfg(), "args": ARGS, "mesh": ((axis,), (2,)), "params": init,
        "seq_axis": "seq" if axis == "seq" else None, "batches": batches,
        "grads": axis == "seq"}, timeout=60.0)
    total = sum(a.size for a in jax.tree_util.tree_leaves(init))
    for r in ranks:
        np.testing.assert_allclose(r["losses"], losses, rtol=LOSS_REL)
        _assert_params(r["params"], final)
    if axis == "data":
        # ZeRO-3 storage: the norms' scales stay whole, every other leaf is
        # halved on each rank, and so are its moments
        norms = sum(a.size for p, a in jax.tree_util.tree_flatten_with_path(init)[0]
                    if "norm" in jax.tree_util.keystr(p))
        assert all(r["local_numel"] == r["moment_numel"] == norms + (total - norms) // 2
                   for r in ranks)
        return
    dense = LLMTrainer(_port_tcfg(), LLMTrainArgs(**ARGS), device="cpu", params=init)
    loss, grads, logits = dense.forward_backward(*batches[0])
    assert ranks[0]["grad_loss"] == pytest.approx(float(loss), rel=LOSS_REL)
    got = np.concatenate([r["logits"] for r in ranks], axis=1)
    np.testing.assert_allclose(got, logits.numpy(), rtol=RING_TOL, atol=RING_TOL)
    for r in ranks:
        for a, b in zip(r["grads"], grads):
            np.testing.assert_allclose(a, b.numpy(), rtol=RING_TOL, atol=RING_TOL)
    assert pt.tree_leaves(dense.params)[0].shape == pt.tree_leaves(init)[0].shape
