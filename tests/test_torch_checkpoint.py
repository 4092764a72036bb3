"""Round checkpointing in the port (``fedml_tpu_torch/core/checkpoint.py``).

The contract of the reference's ``RoundCheckpointer`` and
``RoundCheckpointMixin``: the newest ``keep`` steps kept, each write
committed atomically, a truncated newest step discarded for the previous
one, the cadence ``checkpoint_every_rounds`` plus the final round, and the
checkpointed RNG key authoritative on resume.  Resume is held bitwise
against a straight run on the CPU: FedLLM (the adapters), MESH FedAvg (the
global variables and the server state), SCAFFOLD (every client's control
variate) and MyAvg (every client's personal model), as the reference's
``tests/test_llm.py::test_fedllm_checkpoint_resume_parity`` holds FedLLM.
"""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _state(v):
    return {"w": torch.arange(8, dtype=torch.float32) + v, "round_idx": v, "root_key": (0, v),
            "server_state": None}


def test_keep_three_and_atomic_write(tmp_path, monkeypatch):
    from fedml_tpu_torch.core.checkpoint import RoundCheckpointer

    ck = RoundCheckpointer(str(tmp_path / "ck"))
    for step in range(1, 6):
        ck.save(step, _state(step))
    assert ck.all_steps() == [3, 4, 5] and ck.latest_round() == 5
    restored = ck.restore()
    assert torch.equal(restored["w"], _state(5)["w"]) and restored["root_key"] == (0, 5)
    assert restored["server_state"] is None
    assert torch.equal(ck.restore(4)["w"], _state(4)["w"])

    def broken(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", broken)
    with pytest.raises(OSError):
        ck.save(6, _state(6))
    # a failed write leaves neither the step nor a temporary file behind
    assert sorted(os.listdir(tmp_path / "ck")) == ["round_3.pt", "round_4.pt", "round_5.pt"]


def test_truncated_latest_step_falls_back(tmp_path):
    """A truncated newest step is discarded and ``latest_round`` falls back
    to the previous intact one (the reference's
    ``tests/test_journal_chaos.py`` contract)."""
    from fedml_tpu_torch.core.checkpoint import RoundCheckpointer

    ck = RoundCheckpointer(str(tmp_path / "ck"), keep=5)
    ck.save(0, _state(0))
    ck.save(1, _state(1))
    assert ck.latest_round() == 1
    path = tmp_path / "ck" / "round_1.pt"
    data = path.read_bytes()
    path.write_bytes(data[: len(data) // 3])
    assert ck.latest_round() == 0
    assert not path.exists()
    assert torch.equal(ck.restore()["w"], _state(0)["w"])
    assert RoundCheckpointer(str(tmp_path / "empty")).latest_round() is None


def test_empty_step_falls_back_and_rejected_state_raises(tmp_path):
    """An empty newest step (a write cut before its first byte) is
    discarded like a truncated one.  A state the weights-only unpickler
    rejects is the program's fault: ``latest_round`` raises and deletes
    no step."""
    import fractions
    import pickle

    from fedml_tpu_torch.core.checkpoint import RoundCheckpointer

    ck = RoundCheckpointer(str(tmp_path / "ck"), keep=5)
    ck.save(0, _state(0))
    (tmp_path / "ck" / "round_1.pt").write_bytes(b"")
    assert ck.latest_round() == 0 and ck.all_steps() == [0]
    ck.save(1, {**_state(1), "server_state": fractions.Fraction(1, 3)})
    with pytest.raises(pickle.UnpicklingError):
        ck.latest_round()
    assert ck.all_steps() == [0, 1]


# -- FedLLM ------------------------------------------------------------------

def _fedllm_cfg(tmp_path, **kw):
    import fedml_tpu_torch.arguments as args

    base = dict(dataset="shakespeare", model="transformer", federated_optimizer="FedLLM",
                client_num_in_total=4, client_num_per_round=2, comm_round=4, epochs=1,
                batch_size=4, learning_rate=5e-3, synthetic_train_size=64,
                synthetic_test_size=16, partition_method="homo", frequency_of_the_test=0,
                random_seed=0, data_cache_dir=str(tmp_path), extra={"lora_r": 4})
    base.update(kw)
    return args.Config(**base)


def _fedllm(cfg, ds):
    from fedml_tpu_torch.llm.fedllm import FedLLMSimulator

    return FedLLMSimulator(cfg, ds, device="cpu")


def test_fedllm_resume_equals_straight_run_bitwise(tmp_path):
    """2 rounds + checkpoint + a fresh simulator resumed for 2 more equal 4
    straight rounds, the adapters bitwise (the port's own sampler: the
    resumed run takes its round draws from the checkpointed key)."""
    import fedml_tpu_torch
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.data import loader

    cfg = fedml_tpu_torch.init(_fedllm_cfg(tmp_path))
    ds = loader.load(cfg)
    straight = _fedllm(cfg, ds)
    want = straight.run()
    ck = str(tmp_path / "ck")
    first = _fedllm(_fedllm_cfg(tmp_path, comm_round=2, checkpoint_dir=ck,
                                checkpoint_every_rounds=1), ds)
    first.run()
    assert first._checkpointer().all_steps() == [1, 2]
    resumed = _fedllm(_fedllm_cfg(tmp_path, checkpoint_dir=ck, resume=True), ds)
    resumed.sampler.root = (12345,)  # the checkpoint's key must replace it
    hist = resumed.run()
    assert [h["round"] for h in hist] == [2, 3]
    assert resumed.root_key == resumed.sampler.root == straight.root_key
    assert [h["train_loss"] for h in hist] == [h["train_loss"] for h in want[2:]]
    for a, b in zip(pt.tree_leaves(straight.global_lora), pt.tree_leaves(resumed.global_lora)):
        assert torch.equal(a, b)


# -- the engine ---------------------------------------------------------------

def _sim_cfg(tmp_path, **kw):
    import fedml_tpu_torch.arguments as args

    base = dict(dataset="synthetic", model="lr", client_num_in_total=6, client_num_per_round=3,
                comm_round=4, epochs=1, batch_size=8, learning_rate=0.1,
                synthetic_train_size=240, synthetic_test_size=60, partition_method="hetero",
                partition_alpha=0.5, frequency_of_the_test=2, random_seed=0,
                data_cache_dir=str(tmp_path), backend_sim="MESH")
    base.update(kw)
    return args.Config(**base)


def _engine(cfg, ds):
    import fedml_tpu_torch
    from fedml_tpu_torch.runner import FedMLRunner

    return FedMLRunner(fedml_tpu_torch.init(cfg), dataset=ds, device="cpu").runner


@pytest.mark.parametrize("kw", [
    dict(federated_optimizer="FedAvg"),
    dict(federated_optimizer="FedOpt", server_optimizer="adam", server_lr=0.05),
    dict(federated_optimizer="SCAFFOLD"),
    dict(federated_optimizer="FedAvg", backend_sim="sp"),
    dict(federated_optimizer="MyAvg", dataset="synthetic_condshift", model="mlp",
         extra={"mlp_hidden": 16, "condshift_clusters": 2, "condshift_scale": 2.5}),
], ids=["fedavg", "fedopt_adam", "scaffold", "fedavg_sp", "myavg"])
def test_engine_resume_equals_straight_run_bitwise(tmp_path, kw):
    """2 + 2 rounds with a checkpoint between equal 4 straight ones
    bitwise: the global variables, the server state (FedOpt's Adam
    moments) and every client's state (SCAFFOLD's control variates,
    MyAvg's personal models).  The resumed simulator is built from another
    seed: the checkpoint's variables and key are authoritative."""
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.data import loader

    cfg = _sim_cfg(tmp_path, **kw)
    ds = loader.load(cfg)
    straight = _engine(cfg, ds)
    want = straight.run()
    ck = str(tmp_path / "ck")
    first = _engine(_sim_cfg(tmp_path, comm_round=2, checkpoint_dir=ck,
                             checkpoint_every_rounds=2, **kw), ds)
    first.run()
    assert first._checkpointer().all_steps() == [2]
    resumed = _engine(_sim_cfg(tmp_path, checkpoint_dir=ck, resume=True, random_seed=7, **kw),
                      ds)
    hist = resumed.run()
    assert [h["round"] for h in hist] == [2, 3]
    assert resumed.root_key == straight.root_key
    for k in ("train_loss", "test_loss"):
        assert hist[-1][k] == want[-1][k]

    def leaves(sim):
        trees = (sim.global_vars, sim.server_state, sim.client_states)
        return [t for tree in trees for t in pt.tree_leaves(tree) if torch.is_tensor(t)]

    a, b = leaves(straight), leaves(resumed)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    if kw["federated_optimizer"] != "FedAvg":  # server or client state held too
        assert len(a) > len(pt.tree_leaves(straight.global_vars))


def test_engine_checkpoint_cadence_and_final_round(tmp_path):
    """``checkpoint_every_rounds`` 2 over 5 rounds saves after rounds 2, 4
    and the last (5); the newest three are kept."""
    from fedml_tpu_torch.data import loader

    cfg = _sim_cfg(tmp_path, comm_round=5, checkpoint_dir=str(tmp_path / "ck"),
                   checkpoint_every_rounds=2, frequency_of_the_test=0)
    sim = _engine(cfg, loader.load(cfg))
    hist = sim.run()
    assert [h["round"] for h in hist] == list(range(5))
    assert sim._checkpointer().all_steps() == [2, 4, 5]
    state = sim._checkpointer().restore()
    assert state["round_idx"] == 5 and state["root_key"] == (0,)
    assert np.isfinite(hist[-1]["train_loss"])
