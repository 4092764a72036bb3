"""Port parity: ``fedml_tpu_torch/runner.py``'s refusals of custom trainers
and aggregators and its dispatch of the simulators that build their own
networks, against ``fedml_tpu/runner.py``.

- A simulator of its own with a custom ``client_trainer`` or
  ``server_aggregator``: the reference's ``ValueError``, word for word,
  raised before any data is loaded (the trust refusal comes first, as
  there).
- Where the reference stores one and never reads it (``server_aggregator``
  on the engine; either under cross-silo or centralized training): a
  ``ValueError`` that says the object is not used, never "not ported".
- A trust flag on each of the six new simulators: the reference's
  ``NotImplementedError`` words from the runner, and the simulator built
  directly refuses it too (``sim/engine.refuse_special_simulator``).
- The six build no ``model_hub`` model (reference L150): ``model: gan`` /
  ``darts`` / ``unet`` never reach the hub.
"""

import pytest
import torch

torch.set_num_threads(1)

OWN_NETS = ["split_nn", "FedGKT", "vertical_fl", "FedGan", "FedNAS", "FedSeg"]
SPECIAL = OWN_NETS + ["decentralized_fl", "HierarchicalFL", "Async_FedAvg", "TA", "FedLLM",
                      "MyAvg"]
# a dataset each of the six can run on, tiny
DATA = {"split_nn": "synthetic", "FedGKT": "synthetic", "vertical_fl": "lending_club",
        "FedGan": "mnist", "FedNAS": "cifar10", "FedSeg": "fets2021"}
MODEL = {"FedGan": "gan", "FedNAS": "darts", "FedSeg": "unet"}


def _cfgs(tmp_path, **kw):
    import fedml_tpu.arguments as ref_args
    import fedml_tpu_torch.arguments as args

    base = dict(client_num_in_total=4, client_num_per_round=2, comm_round=1, batch_size=8,
                synthetic_train_size=64, synthetic_test_size=16, partition_method="homo",
                random_seed=0, data_cache_dir=str(tmp_path))
    base.update(kw)
    return ref_args.Config(**base), args.Config(**base)


def _raised(fn):
    with pytest.raises(Exception) as info:
        fn()
    return info.value


@pytest.mark.parametrize("what", ["client_trainer", "server_aggregator"])
@pytest.mark.parametrize("opt", SPECIAL)
def test_special_simulators_raise_the_reference_words(tmp_path, opt, what):
    from fedml_tpu.runner import FedMLRunner as RefRunner
    from fedml_tpu_torch.runner import FedMLRunner

    ref_cfg, cfg = _cfgs(tmp_path, federated_optimizer=opt, dataset="no_such_set")
    want = _raised(lambda: RefRunner(ref_cfg, **{what: object()}))
    got = _raised(lambda: FedMLRunner(cfg, device="cpu", **{what: object()}))
    assert type(got) is type(want) is ValueError
    assert str(got) == str(want)


@pytest.mark.parametrize("training_type,opt,what,where", [
    ("simulation", "FedAvg", "server_aggregator", "the simulation engine"),
    ("cross_silo", "FedAvg", "client_trainer", "the cross-silo platform"),
    ("cross_silo", "FedAvg", "server_aggregator", "the cross-silo platform"),
    ("centralized", "FedAvg", "client_trainer", "centralized training"),
    ("centralized", "FedAvg", "server_aggregator", "centralized training"),
])
def test_objects_the_reference_ignores_are_refused(tmp_path, training_type, opt, what, where):
    from fedml_tpu_torch.runner import FedMLRunner

    _, cfg = _cfgs(tmp_path, training_type=training_type, federated_optimizer=opt,
                   dataset="no_such_set", role="server", backend="INPROC")
    with pytest.raises(ValueError) as info:
        FedMLRunner(cfg, device="cpu", **{what: object()})
    msg = str(info.value)
    assert f"custom {what} is not used by {where}" in msg and "not ported" not in msg


@pytest.mark.parametrize("opt", OWN_NETS)
def test_trust_flags_refused_on_the_new_simulators(tmp_path, opt):
    from fedml_tpu.runner import FedMLRunner as RefRunner
    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.runner import FedMLRunner, _own_net_simulator

    ref_cfg, cfg = _cfgs(tmp_path, federated_optimizer=opt, dataset=DATA[opt],
                         enable_defense=True)
    want = _raised(lambda: RefRunner(ref_cfg))
    got = _raised(lambda: FedMLRunner(cfg, device="cpu"))
    assert type(got) is type(want) is NotImplementedError
    assert str(got) == str(want)
    cfg.enable_defense = False
    ds = loader.load(cfg)
    cfg.enable_defense = True
    with pytest.raises(NotImplementedError, match="trust features"):
        _own_net_simulator(opt)(cfg, ds, device="cpu")


@pytest.mark.parametrize("opt", OWN_NETS)
def test_new_simulators_build_no_hub_model(tmp_path, monkeypatch, opt):
    from fedml_tpu_torch.models import model_hub
    from fedml_tpu_torch.runner import FedMLRunner, _own_net_simulator

    def no_hub(*a, **k):
        raise AssertionError("model_hub.create called")

    monkeypatch.setattr(model_hub, "create", no_hub)
    _, cfg = _cfgs(tmp_path, federated_optimizer=opt, dataset=DATA[opt],
                   model=MODEL.get(opt, "resnet56"), norm="group",
                   extra={"seg_base": 4, "nas_features": 4, "gan_z_dim": 8})
    runner = FedMLRunner(cfg, device="cpu")
    assert isinstance(runner.runner, _own_net_simulator(opt)) and runner.model is None
