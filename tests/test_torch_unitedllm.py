"""Port parity: UnitedLLM (``llm/unitedllm.py``) and the cross-cloud
platform (``cross_cloud/``) against the JAX package.

The reference's test (``tests/test_cross_cloud_llm.py`` L50-100): two LLM
silos and the server over real TCP loopback, two rounds, only LoRA adapter
trees on the wire, each model payload under half the base model's bytes,
and a test loss that does not rise.  The port runs the same configuration
over TCP from the reference's base and initial adapters (its
``_build_base``, carried in by key) with the reference's batch-index draws
(``jax.random.randint`` from each step's key): the model payloads have the
reference's sizes (less the reference's trace header), and the round
losses are the reference's within the bf16 transformer's tolerance
(``TransformerConfig.tiny`` computes in bf16; ``tests/test_torch_fedllm.py``
holds its logits within 8e-2, so the mean losses are held within 2e-2).  The runner's
``training_type: cross_cloud`` dispatch, the WAN defaults and the trust
refusal are held against the reference's.
"""

import numpy as np
import pytest
import torch

from .conftest import tiny_config

torch.set_num_threads(1)

LOSS_TOL = 2e-2


def _llm_cfgs(**kw):
    import fedml_tpu_torch.arguments as args

    base = dict(training_type="cross_cloud", dataset="shakespeare", model="transformer",
                client_num_in_total=2, client_num_per_round=2, comm_round=2, epochs=1,
                batch_size=4, learning_rate=0.01, synthetic_train_size=128,
                synthetic_test_size=32, frequency_of_the_test=1)
    extra = {"unitedllm": True, "lora_r": 2, **kw.pop("extra", {})}
    base.update(kw)
    ref = tiny_config(**base, extra=extra)
    fields = {k: v for k, v in vars(ref).items() if k in args.Config.__dataclass_fields__}
    return ref, args.Config(**{**fields, "extra": dict(extra)})


class _Sizes:
    """The byte sizes of every encoded message that carries a model, per
    package (``Message.encode`` spied)."""

    def __init__(self, monkeypatch, message_cls, key):
        self.sizes = []
        orig = message_cls.encode

        def spy(msg):
            blob = orig(msg)
            if msg.get(key) is not None:
                self.sizes.append(len(blob))
            return blob

        monkeypatch.setattr(message_cls, "encode", spy)


def _ref_batches(cfg):
    """The reference silo's batch-index table of a round as the port's
    ``batches`` hook."""
    import jax

    from fedml_tpu.core import rng

    seed_key = rng.root_key(cfg.random_seed)

    def table(r, client, steps, bs, count):
        key = rng.client_key(rng.round_key(seed_key, r), client)
        return np.stack([np.asarray(jax.random.randint(jax.random.fold_in(key, s), (bs,), 0,
                                                       count)) for s in range(steps)])

    return table


def test_unitedllm_over_tcp_matches_the_reference(monkeypatch):
    """Two silos and the server over TCP loopback, two rounds: adapter-only
    payloads of the reference's sizes, each under half the base model's
    bytes, the adapters a small share of the base; losses as the
    reference's; the test loss does not rise."""
    import jax

    import fedml_tpu
    import fedml_tpu_torch
    from fedml_tpu.comm.message import Message as RefMessage
    from fedml_tpu.cross_silo import message_define as ref_md
    from fedml_tpu.data import loader as ref_loader
    from fedml_tpu.llm import unitedllm as ref_united
    from fedml_tpu_torch.comm.message import Message
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.cross_silo import message_define as md
    from fedml_tpu_torch.cross_silo.async_soak import _free_port_block
    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.llm.unitedllm import run_unitedllm_process_group

    ref_cfg, cfg = _llm_cfgs(run_id="united_ref", backend="TCP")
    ref_cfg.extra["tcp_base_port"] = _free_port_block(4)
    fedml_tpu.init(ref_cfg)
    ref_ds = ref_loader.load(ref_cfg)
    _, base_params, lora0, _ = ref_united._build_base(ref_cfg, ref_ds)
    base = (jax.tree_util.tree_map(np.asarray, base_params),
            jax.tree_util.tree_map(np.asarray, lora0))
    ref_sizes = _Sizes(monkeypatch, RefMessage, ref_md.MSG_ARG_KEY_MODEL_PARAMS)
    ref_hist, ref_server = ref_united.run_unitedllm_process_group(ref_cfg, ref_ds,
                                                                  backend="TCP", timeout=120.0)

    fedml_tpu_torch.init(cfg)
    cfg.run_id = "united_port"
    cfg.extra["tcp_base_port"] = 0
    ds = loader.load(cfg)
    assert np.array_equal(ds.train_x, ref_ds.train_x) and np.array_equal(ds.test_y, ref_ds.test_y)
    sizes = _Sizes(monkeypatch, Message, md.MSG_ARG_KEY_MODEL_PARAMS)
    hist, server = run_unitedllm_process_group(cfg, ds, "cpu", backend="TCP", timeout=120.0,
                                               base=base, batches=_ref_batches(ref_cfg))

    assert len(hist) == len(ref_hist) == cfg.comm_round
    assert hist[-1]["test_loss"] <= hist[0]["test_loss"] + 1e-6, hist
    for h, r in zip(hist, ref_hist):
        assert h["test_loss"] == pytest.approx(r["test_loss"], abs=LOSS_TOL)
    base_bytes = sum(t.numel() * t.element_size() for t in pt.tree_leaves(
        server.aggregator.base_params))
    lora_bytes = sum(t.numel() * t.element_size() for t in pt.tree_leaves(
        server.aggregator.global_vars))
    assert lora_bytes < base_bytes / 10
    # the same adapter payloads: every model frame the reference's less its
    # trace header, which the port's frames lack (ROADMAP Queue 3)
    assert sizes.sizes and len(sizes.sizes) == len(ref_sizes.sizes)
    assert len({r - p for r, p in zip(sorted(ref_sizes.sizes), sorted(sizes.sizes))}) == 1
    assert all(s < base_bytes / 2 for s in sizes.sizes + ref_sizes.sizes)
    got = pt.tree_leaves(server.aggregator.global_vars)
    want = jax.tree_util.tree_leaves(jax.device_get(ref_server.aggregator.global_vars))
    assert [tuple(a.shape) for a in got] == [tuple(np.shape(b)) for b in want]


def test_runner_dispatches_cross_cloud_as_the_reference():
    """``training_type: cross_cloud`` through ``FedMLRunner``: UnitedLLM in
    one process (a history with the LM loss), the trust refusal word for
    word, and a non-LLM run as the cross-silo platform with the WAN
    straggler defaults (an explicit choice kept)."""
    import fedml_tpu_torch
    from fedml_tpu.runner import FedMLRunner as RefRunner
    from fedml_tpu_torch.runner import FedMLRunner

    _, cfg = _llm_cfgs(run_id="united_runner", role="server", backend="INPROC", comm_round=1)
    history = FedMLRunner(fedml_tpu_torch.init(cfg), device="cpu").run()
    assert history and "test_loss" in history[-1] and "test_ppl" in history[-1]

    ref_cfg, cfg = _llm_cfgs(run_id="united_dp", role="server", backend="INPROC",
                             enable_dp=True)
    with pytest.raises(NotImplementedError) as want:
        RefRunner(ref_cfg).run()
    with pytest.raises(NotImplementedError) as got:
        FedMLRunner(cfg, device="cpu").run()
    assert str(got.value) == str(want.value)

    import fedml_tpu_torch.arguments as args

    plain = tiny_config(training_type="cross_cloud", role="server", backend="INPROC",
                        client_num_in_total=2, client_num_per_round=2, comm_round=1,
                        run_id="cloud_plain", extra={"straggler_quorum_frac": 0.75})
    fields = {k: v for k, v in vars(plain).items() if k in args.Config.__dataclass_fields__}
    cfg = args.Config(**fields)
    runner = FedMLRunner(fedml_tpu_torch.init(cfg), device="cpu")
    assert cfg.extra["straggler_timeout_s"] == 60.0 and cfg.extra["straggler_quorum_frac"] == 0.75
    assert cfg.backend == "INPROC"
    history = runner.run()
    assert len(history) == 1 and "test_acc" in history[0]


def test_unitedllm_builders_take_the_async_server():
    """``extra.async_aggregation`` gives the buffered-async server over the
    adapter aggregator, which folds as it streams; without it the plain
    server."""
    import fedml_tpu_torch
    from fedml_tpu_torch.cross_silo.async_server import AsyncFedMLServerManager
    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.llm.unitedllm import LoRAAggregator, build_unitedllm_server

    for flag in (False, True):
        _, cfg = _llm_cfgs(run_id=f"united_async_{flag}", backend="INPROC",
                           extra={"async_aggregation": flag})
        fedml_tpu_torch.init(cfg)
        server = build_unitedllm_server(cfg, loader.load(cfg), "cpu", backend="INPROC")
        try:
            assert isinstance(server, AsyncFedMLServerManager) == flag
            assert isinstance(server.aggregator, LoRAAggregator)
            assert server.aggregator.stream_mode == flag
        finally:
            server.finish()
