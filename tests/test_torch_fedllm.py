"""Port parity: the text loader and FedLLM (federated LoRA).

The loader's arrays are bitwise the reference's: the Markov-chain fallback,
its first-target-token partition, and a LEAF json the test writes (the
char-level and the word-level encodings).

FedLLM: ``fedml_tpu.llm.fedllm.FedLLMSimulator`` and the port's run on the
same dataset with the reference's base parameters and adapters copied
across, and the reference's sampled ids and per-step batch draws
(``jax.random.randint(fold_in(client_key, s), (B,), 0, count)``) handed to
the port as its sampler's ``(steps, B)`` tables.  The transformer runs in
f32 here (``TransformerConfig.tiny`` with f32 dtypes): in bf16 the two
differ by a bf16 ulp at rounding boundaries (``test_torch_transformer.py``)
and adamw's first steps, ``lr * g / |g|`` on the zero ``b``, turn such a
difference into a whole ``lr`` wherever a gradient element is near zero.
Tolerances, on the adapters as the update from where they started: the
relative L2 of the difference (over the update's norm) and every element
of it.  One client update: relative 2e-5, elementwise 4e-5 (measured on
the four clients: relative 1.1e-6 to 4.3e-6, elementwise 7.2e-7 to 8.0e-6);
two rounds: relative 5e-4, elementwise 5e-4, a tenth of the learning rate
(measured 1.0e-4 and 1.6e-4).  adamw scales every step to about ``lr``
whatever the gradient's size, so an element whose gradient is near zero
carries a rounding difference of the gradient into a visible one of the
step; XLA also contracts adamw's products into FMAs under jit and the port
does not.  Losses within rtol 1e-5 (measured 1.4e-7).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

RECIPE = "examples/fedllm_shakespeare_lora/fedml_config.yaml"


def _cfgs(tmp_path, **kw):
    import fedml_tpu.arguments as ref_args
    import fedml_tpu_torch.arguments as args

    base = dict(dataset="shakespeare", model="transformer", federated_optimizer="FedLLM",
                client_num_in_total=4, client_num_per_round=2, comm_round=2, epochs=1,
                batch_size=4, learning_rate=0.005, synthetic_train_size=64,
                synthetic_test_size=16, partition_method="homo", frequency_of_the_test=1,
                random_seed=0, data_cache_dir=str(tmp_path))
    base.update(kw)
    extra = {"lora_r": 4, "lora_alpha": 16.0, **base.pop("extra", {})}
    return ref_args.Config(**base, extra=extra), args.Config(**base, extra=dict(extra))


def _assert_same_dataset(a, b):
    for k in ("train_x", "train_y", "test_x", "test_y"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)
    assert a.class_num == b.class_num and a.name == b.name
    assert len(a.client_idx) == len(b.client_idx)
    for i, j in zip(a.client_idx, b.client_idx):
        np.testing.assert_array_equal(np.asarray(i), np.asarray(j))


@pytest.mark.parametrize("dataset,partition", [("shakespeare", "homo"),
                                               ("fed_shakespeare", "hetero")])
def test_text_fallback_matches_reference_bitwise(tmp_path, dataset, partition):
    """The Markov-chain stand-in and the partition by first target token."""
    from fedml_tpu.data import loader as ref_loader
    from fedml_tpu_torch.data import loader

    ref_cfg, cfg = _cfgs(tmp_path, dataset=dataset, partition_method=partition,
                         partition_alpha=0.5, synthetic_train_size=96, random_seed=3)
    ours = loader.load(cfg)
    _assert_same_dataset(ref_loader.load(ref_cfg), ours)
    assert ours.train_x.shape == (96, 80) and ours.class_num == 90
    np.testing.assert_array_equal(ours.train_x[:, 1:], ours.train_y[:, :-1])


def _write_leaf(root, name, users):
    for split in ("train", "test"):
        d = root / name / split
        d.mkdir(parents=True)
        (d / "part.json").write_text(json.dumps({"users": list(users),
                                                 "user_data": users}))


@pytest.mark.parametrize("name", ["shakespeare", "reddit"])
def test_leaf_json_matches_reference_bitwise(tmp_path, name):
    """A LEAF json under ``data_cache_dir``: char-level for shakespeare
    (unknown characters map to 0, sequences cut at 80), word-level hashed
    ids for reddit (string and token-list samples); one client per user in
    sorted order."""
    from fedml_tpu.data import loader as ref_loader
    from fedml_tpu_torch.data import loader

    if name == "shakespeare":
        users = {"zed": {"x": ["To be, or not to be~", "x" * 100], "y": ["!", "y"]},
                 "amy": {"x": ["Hark, what light{"], "y": [" "]}}
    else:
        users = {"u2": {"x": ["the cat sat", [["a", "b"], "c d e"]], "y": ["on", ""]},
                 "u1": {"x": [["w1", "w2", "w3"]], "y": [["w4"]]}}
    _write_leaf(tmp_path, name, users)
    ref_cfg, cfg = _cfgs(tmp_path, dataset=name)
    ours = loader.load(cfg)
    _assert_same_dataset(ref_loader.load(ref_cfg), ours)
    assert ours.n_clients == 2 and ours.train_x.dtype == np.int32


def _batch_tables(root_key, r, client, steps, batch, count):
    """The reference's per-step batch draws of one client as a table."""
    import jax

    from fedml_tpu.core import rng

    key = rng.client_key(rng.round_key(root_key, r), client)
    return torch.from_numpy(np.stack([np.asarray(jax.random.randint(
        jax.random.fold_in(key, s), (batch,), 0, count)) for s in range(steps)]).astype(np.int64))


class JaxLLMSampler:
    """The reference's randomness as a port sampler hook."""

    def __init__(self, root_key, n_total, per_round):
        self.root, self.n_total, self.per_round = root_key, n_total, per_round

    def sample(self, r):
        from fedml_tpu.core import rng

        return np.asarray(rng.sample_clients(self.root, r, self.n_total, self.per_round))

    def batches(self, r, client, steps, batch, count, device):
        return _batch_tables(self.root, r, client, steps, batch, count).to(device)


def _pair(tmp_path, **kw):
    """The reference simulator and the port's on the same data, f32, with
    the reference's base parameters and adapters copied and its sampler."""
    import jax.numpy as jnp

    import fedml_tpu
    import fedml_tpu_torch
    from fedml_tpu.data import loader as ref_loader
    from fedml_tpu.llm.fedllm import FedLLMSimulator as RefSim
    from fedml_tpu.models.transformer import TransformerConfig as RefConfig
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.llm.fedllm import FedLLMSimulator
    from fedml_tpu_torch.models.transformer import TransformerConfig

    ref_cfg, cfg = _cfgs(tmp_path, **kw)
    fedml_tpu.init(ref_cfg)
    fedml_tpu_torch.init(cfg)
    ref_ds, ds = ref_loader.load(ref_cfg), loader.load(cfg)
    vocab = ds.class_num
    ref = RefSim(ref_cfg, ref_ds, tcfg=dataclasses.replace(
        RefConfig.tiny(vocab), dtype=jnp.float32, logits_dtype=jnp.float32))
    n = ds.n_clients
    sim = FedLLMSimulator(cfg, ds, tcfg=dataclasses.replace(
        TransformerConfig.tiny(vocab), dtype=torch.float32, logits_dtype=torch.float32),
        device="cpu", sampler=JaxLLMSampler(ref.root_key, n, min(cfg.client_num_per_round, n)))
    with torch.no_grad():
        pt.tree_map(lambda t, v: t.copy_(v), sim.base_params,
                    weights.tree_from_flax(ref.base_params))
    sim.global_lora = weights.tree_from_flax(ref.global_lora)
    return ref, sim


def _assert_lora_close(got, want, start, rel, atol):
    """``got`` and ``want`` as updates from ``start``: the relative L2 of
    their difference and its largest element."""
    from fedml_tpu_torch import weights

    got = weights.to_numpy(got)
    assert list(got) == sorted(want)
    diff = upd = largest = 0.0
    for path, ab in got.items():
        for k in ("a", "b"):
            w = np.asarray(want[path][k], np.float64)
            d = ab[k] - w
            diff += float((d ** 2).sum())
            upd += float(((w - np.asarray(start[path][k])) ** 2).sum())
            largest = max(largest, float(np.abs(d).max()))
    assert np.sqrt(diff / upd) <= rel and largest <= atol, (np.sqrt(diff / upd), largest)


def test_client_update_matches_reference(tmp_path):
    """One client's local training (its padded shard, the batch table, a
    fresh adamw) from adapters with a non-zero ``b``."""
    import jax
    import jax.numpy as jnp

    from fedml_tpu.core import rng
    from fedml_tpu_torch import weights

    ref, sim = _pair(tmp_path)
    start = jax.tree_util.tree_map(lambda a: a + 0.01, ref.global_lora)
    ci, count = 1, int(sim.counts[1])
    key = rng.client_key(rng.round_key(ref.root_key, 0), ci)
    ix = ref.dataset.client_idx[ci]
    reps = np.resize(ix, ref._capacity)
    want, want_loss = ref._client_step(start, jnp.asarray(ref.dataset.train_x[reps]),
                                       jnp.asarray(ref.dataset.train_y[reps]),
                                       jnp.int32(len(ix)), key)
    table = _batch_tables(ref.root_key, 0, ci, sim.steps, sim.cfg.batch_size, count)
    assert sim.steps == ref.cfg.epochs * max(1, ref._capacity // ref.cfg.batch_size)
    got, losses = sim.client_update(weights.tree_from_flax(start), sim._x[ci], sim._y[ci], table)
    assert losses.shape == (sim.steps,)
    _assert_lora_close(got, want, start, rel=2e-5, atol=4e-5)
    np.testing.assert_allclose(float(losses.mean()), float(want_loss), rtol=1e-5)


def test_two_rounds_match_reference(tmp_path):
    """Two rounds of 2 of 4 clients: the weighted mean of the adapters, the
    round losses and the evaluation (test loss and perplexity)."""
    from fedml_tpu_torch import weights

    ref, sim = _pair(tmp_path)
    start = weights.to_numpy(sim.global_lora)
    for _ in range(2):
        want, got = ref.run_round(), sim.run_round()
        np.testing.assert_allclose(got["train_loss"], want["train_loss"], rtol=1e-5)
    assert sim.round_idx == ref.round_idx == 2
    _assert_lora_close(sim.global_lora, ref.global_lora, start, rel=5e-4, atol=5e-4)
    want, got = ref.evaluate(), sim.evaluate()
    np.testing.assert_allclose(got["test_loss"], want["test_loss"], rtol=1e-5)
    np.testing.assert_allclose(got["test_ppl"], want["test_ppl"], rtol=1e-5)


def test_recipe_through_runner_shrunk(tmp_path):
    """The shipped recipe through ``init`` + ``FedMLRunner(cfg,
    device="cpu")``, its depth cut to 2 rounds and its data to 128 / 32
    sequences: a FedLLMSimulator at the recipe's widths (the tiny
    transformer at vocab 90, bf16, LoRA r 8 on wq/wk/wv/wo), finite
    losses, ``test_ppl = exp(test_loss)``, only the adapters move."""
    import fedml_tpu_torch
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.llm.fedllm import FedLLMSimulator
    from fedml_tpu_torch.runner import FedMLRunner

    cfg = fedml_tpu_torch.init(argv=["--cf", RECIPE])
    cfg.comm_round, cfg.frequency_of_the_test = 2, 1
    cfg.synthetic_train_size, cfg.synthetic_test_size = 128, 32
    cfg.data_cache_dir = str(tmp_path)
    runner = FedMLRunner(cfg, device="cpu")
    sim = runner.runner
    assert isinstance(sim, FedLLMSimulator)
    assert (sim.tcfg.vocab_size, sim.tcfg.d_model, sim.tcfg.dtype) == (90, 128, torch.bfloat16)
    assert sim.rank == 8 and len(sim.global_lora) == 8
    base = [t.clone() for t in pt.tree_leaves(sim.base_params)]
    hist = runner.run()
    assert [h["round"] for h in hist] == [0, 1]
    for h in hist:
        assert np.isfinite(h["train_loss"]) and np.isfinite(h["test_loss"])
        np.testing.assert_allclose(h["test_ppl"], np.exp(h["test_loss"]), rtol=1e-12)
    assert all(torch.equal(a, b) for a, b in zip(base, pt.tree_leaves(sim.base_params)))
    assert any(bool(ab["b"].any()) for ab in sim.global_lora.values())
    assert sim.trained_tokens(2) == 2 * sim.steps * 8 * 80


def test_fedllm_refuses_trust_flags(tmp_path):
    from fedml_tpu_torch.runner import FedMLRunner

    for kw in (dict(enable_dp=True), dict(extra={"aot_programs": True})):
        _, cfg = _cfgs(tmp_path, **kw)
        with pytest.raises(NotImplementedError):
            FedMLRunner(cfg, device="cpu")
