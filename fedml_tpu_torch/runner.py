"""FedMLRunner — platform dispatch (the port of ``fedml_tpu/runner.py``).

Ported so far: the simulation platform with the algorithms of the registry
(``algorithms/__init__.py``: the FedAvg family and FedSGD, the engine's
population mode under ``extra.population_store`` too) and the simulators
of their own: ``HierarchicalFL``, ``MyAvg`` / ``MyAgg-7``, ``FedLLM``,
``decentralized_fl``, ``Async_FedAvg`` and ``TA`` (``sim/hierarchical.py``,
``sim/myavg.py``, ``llm/fedllm.py``, ``sim/decentralized.py``,
``sim/async_fl.py``, ``sim/turboaggregate.py``), and those that build
their own networks, ``split_nn``, ``FedGKT``, ``vertical_fl``, ``FedGan``,
``FedNAS`` and ``FedSeg`` (``sim/split_learning.py``, ``sim/vertical.py``,
``sim/fedgan.py``, ``sim/fednas.py``, ``sim/fedseg.py``); FedLLM and these
six build no ``model_hub`` model (reference L101-110, L150), the rest do;
the cross-silo platform (``cross_silo/``: every protocol, in one process
or as processes of their own, a silo spanning processes too); the
cross-cloud platform (``training_type: cross_cloud``, ``cross_cloud/``:
the cross-silo protocol with WAN defaults, UnitedLLM under
``extra.unitedllm``); the model-serving platform (``training_type:
model_serving``, ``serving/federated.py``, reference L240-300: the plain
cross-silo job under an endpoint identity, for the FedAvg family, SecAgg
and FHE refused with the reference's words); and the centralized baseline
(``training_type: centralized``, ``sim/centralized.py``, reference
L307-311).  Every other platform and optimizer raises
``NotImplementedError``.

Trust flags as the reference routes them (L17-41, L113-150): attack,
defense, DP and contribution run on the engine's FedAvg family (MESH and
sp); MyAvg takes attack, defense and DP and refuses the rest itself; every
other special simulator refuses them all, and so does the centralized
trainer (the reference ignores them there; a flag is never a silent no-op
in the port: these also refuse the engine's unported flags and population
mode, ``sim/engine.refuse_special_simulator``); SecAgg and FHE are
cross-silo protocols, refused in simulation.

Custom trainers and aggregators (reference L140-144, L207-217, L307): a
simulator of its own raises the reference's ``ValueError`` for either; the
engine takes ``client_trainer`` as its algorithm.  Where the reference
stores one and never reads it (``server_aggregator`` on the engine, either
under cross-silo or centralized) the port raises a ``ValueError`` that
says so, as HierarchicalFL refuses the checkpoint keys the reference
ignores: a setting is never dropped unseen.
"""

from __future__ import annotations

import importlib

from . import algorithms, constants as C
from .arguments import Config
from .core.device import resolve_device

# the reference's implemented set (all six); a flag outside it would be a
# silent no-op, so it is refused
_IMPLEMENTED_TRUST_FLAGS = frozenset(C.TRUST_FLAGS)


def _check_unimplemented_flags(cfg: Config) -> None:
    """Security and privacy flags are never silent no-ops: a flag the trust
    stack does not handle is an error (reference L17)."""
    pending = [f for f in C.TRUST_FLAGS
               if getattr(cfg, f, False) and f not in _IMPLEMENTED_TRUST_FLAGS]
    if pending:
        raise NotImplementedError(f"trust features {pending} are enabled in the config but not "
                                  "yet implemented; refusing to run without them")

_PORTED_PLATFORMS = (C.TRAINING_PLATFORM_SIMULATION, C.TRAINING_PLATFORM_CROSS_SILO,
                     C.TRAINING_PLATFORM_CENTRALIZED, C.TRAINING_PLATFORM_CROSS_CLOUD,
                     C.TRAINING_PLATFORM_SERVING)
# simulators of their own (reference runner.py L87-194), beside the
# registry's algorithms on the engine
# the simulators that build their own networks (reference L101-110, but
# FedLLM, which has its own branch): no model_hub model; module and class
# under sim/
_OWN_NET_SIMULATORS = {
    C.FEDERATED_OPTIMIZER_SPLIT_NN: ("split_learning", "SplitNNSimulator"),
    C.FEDERATED_OPTIMIZER_FEDGKT: ("split_learning", "FedGKTSimulator"),
    C.FEDERATED_OPTIMIZER_VERTICAL_FL: ("vertical", "VFLSimulator"),
    C.FEDERATED_OPTIMIZER_FEDGAN: ("fedgan", "FedGANSimulator"),
    C.FEDERATED_OPTIMIZER_FEDNAS: ("fednas", "FedNASSimulator"),
    C.FEDERATED_OPTIMIZER_FEDSEG: ("fedseg", "FedSegSimulator"),
}
_SPECIAL_SIMULATORS = ((C.FEDERATED_OPTIMIZER_HIERARCHICAL_FL, C.FEDERATED_OPTIMIZER_FEDLLM,
                        C.FEDERATED_OPTIMIZER_DECENTRALIZED_FL,
                        C.FEDERATED_OPTIMIZER_ASYNC_FEDAVG,
                        C.FEDERATED_OPTIMIZER_TURBO_AGGREGATE)
                       + C.FEDERATED_OPTIMIZER_MYAVG_ALIASES + tuple(_OWN_NET_SIMULATORS))
_PORTED_OPTIMIZERS = tuple(algorithms.names()) + _SPECIAL_SIMULATORS


def _not_used(what: str, where: str) -> ValueError:
    """The refusal of a custom object the reference stores but never reads
    on this path."""
    return ValueError(f"a custom {what} is not used by {where} (the reference ignores it "
                      "there); remove it")


class FedMLRunner:
    """Builds the simulator or the cross-silo runner for ``cfg`` on
    ``device`` (the card unless the caller names another; with no CUDA and
    no device this raises)."""

    def __init__(self, cfg: Config, dataset=None, model=None, client_trainer=None,
                 server_aggregator=None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dataset = dataset
        self.model = model
        if cfg.training_type not in _PORTED_PLATFORMS:
            raise NotImplementedError(f"training_type {cfg.training_type!r} is not ported "
                                      f"yet (ported: {_PORTED_PLATFORMS})")
        _check_unimplemented_flags(cfg)
        if cfg.training_type == C.TRAINING_PLATFORM_CENTRALIZED:
            self.runner = self._init_centralized_runner(client_trainer, server_aggregator)
            return
        if cfg.federated_optimizer not in _PORTED_OPTIMIZERS:
            raise NotImplementedError(f"federated_optimizer {cfg.federated_optimizer!r} is "
                                      f"not ported yet (ported: {_PORTED_OPTIMIZERS})")
        if cfg.training_type in (C.TRAINING_PLATFORM_CROSS_SILO, C.TRAINING_PLATFORM_CROSS_CLOUD,
                                 C.TRAINING_PLATFORM_SERVING):
            for what, obj in (("client_trainer", client_trainer),
                              ("server_aggregator", server_aggregator)):
                if obj is not None:
                    raise _not_used(what, f"the {cfg.training_type.replace('_', '-')} platform")
            self.runner = (self._init_serving_runner()
                           if cfg.training_type == C.TRAINING_PLATFORM_SERVING
                           else self._init_wire_runner())
        else:
            self.runner = self._init_simulation_runner(client_trainer, server_aggregator)

    def _init_wire_runner(self):
        """The cross-silo runner, or the cross-cloud one (reference L226-239:
        under ``extra.unitedllm`` no ``model_hub`` model, the adapter
        exchange builds its own), each checked before the data is loaded."""
        from .cross_silo import create_cross_silo_runner, refuse_unported_cross_silo

        cfg = self.cfg
        if cfg.training_type == C.TRAINING_PLATFORM_CROSS_SILO:
            refuse_unported_cross_silo(cfg)
            self._load_dataset_and_model()
            return create_cross_silo_runner(cfg, self.dataset, self.model, self.device)
        from . import cross_cloud
        from .core.flags import cfg_extra

        if cfg_extra(cfg, "unitedllm"):
            cross_cloud.refuse_llm_trust(cfg)
            if self.dataset is None:
                from .data import loader

                self.dataset = loader.load(cfg)
        else:
            cross_cloud.apply_defaults(cfg)
            refuse_unported_cross_silo(cfg)
            self._load_dataset_and_model()
        return cross_cloud.create_cross_cloud_runner(cfg, self.dataset, self.model, self.device)

    def _init_serving_runner(self):
        """``training_type: model_serving`` (reference L240-300): the privacy
        flags and the optimizer are checked before the data is loaded."""
        from .cross_silo import refuse_unported_cross_silo
        from .serving.federated import (ServingJobRunner, refuse_secure_serving,
                                        refuse_unservable_optimizer)

        cfg = self.cfg
        refuse_secure_serving(cfg)
        refuse_unservable_optimizer(cfg)
        refuse_unported_cross_silo(cfg)
        self._load_dataset_and_model()
        return ServingJobRunner(cfg, self.dataset, self.model, self.device)

    def _load_dataset_and_model(self) -> None:
        if self.dataset is None:
            from .data import loader

            self.dataset = loader.load(self.cfg)
        if self.model is None:
            from .models import model_hub

            self.model = model_hub.create(self.cfg, self.dataset.class_num,
                                          input_shape=self.dataset.train_x.shape[1:])

    def _init_centralized_runner(self, client_trainer, server_aggregator):
        """The centralized baseline (reference L307): the whole training set
        as one client."""
        from .sim.centralized import CentralizedTrainer
        from .sim.engine import refuse_special_simulator

        refuse_special_simulator(self.cfg, C.TRAINING_PLATFORM_CENTRALIZED)
        for what, obj in (("client_trainer", client_trainer),
                          ("server_aggregator", server_aggregator)):
            if obj is not None:
                raise _not_used(what, "centralized training")

        self._load_dataset_and_model()
        return CentralizedTrainer(self.cfg, self.dataset, self.model, device=self.device)

    def _init_simulation_runner(self, client_trainer, server_aggregator):
        from .sim.engine import refuse_protocol_flags

        refuse_protocol_flags(self.cfg)
        opt = self.cfg.federated_optimizer
        if opt in _SPECIAL_SIMULATORS:
            # these simulators bypass the engine's trust hooks; MyAvg routes
            # attack, defense and DP through them and refuses the rest itself
            active = [f for f in C.TRUST_FLAGS if getattr(self.cfg, f, False)]
            if active and opt not in C.FEDERATED_OPTIMIZER_MYAVG_ALIASES:
                raise NotImplementedError(
                    f"trust features {active} are not yet wired into the {opt!r} simulator "
                    "(supported on the FedAvg-family mesh engine); refusing to run without them")
            if client_trainer is not None or server_aggregator is not None:
                raise ValueError(
                    f"custom client_trainer/server_aggregator are not used by the {opt!r} "
                    "simulator; remove them or use a FedAvg-family optimizer")
        elif server_aggregator is not None:
            raise _not_used("server_aggregator", "the simulation engine")
        if opt == C.FEDERATED_OPTIMIZER_HIERARCHICAL_FL:
            from .sim.hierarchical import HierarchicalSimulator, refuse_unported_hierarchical

            refuse_unported_hierarchical(self.cfg)  # before the data is loaded
            self._load_dataset_and_model()
            return HierarchicalSimulator(self.cfg, self.dataset, self.model, device=self.device)
        if opt == C.FEDERATED_OPTIMIZER_FEDLLM:
            from .llm.fedllm import FedLLMSimulator, refuse_unported_fedllm

            refuse_unported_fedllm(self.cfg)
            if self.dataset is None:
                from .data import loader

                self.dataset = loader.load(self.cfg)
            return FedLLMSimulator(self.cfg, self.dataset, device=self.device)
        if opt in (C.FEDERATED_OPTIMIZER_DECENTRALIZED_FL, C.FEDERATED_OPTIMIZER_ASYNC_FEDAVG,
                   C.FEDERATED_OPTIMIZER_TURBO_AGGREGATE):
            from .sim.engine import refuse_special_simulator

            refuse_special_simulator(self.cfg, opt)  # before the data is loaded
            self._load_dataset_and_model()
            if opt == C.FEDERATED_OPTIMIZER_DECENTRALIZED_FL:
                from .sim.decentralized import DecentralizedSimulator as Sim
            elif opt == C.FEDERATED_OPTIMIZER_ASYNC_FEDAVG:
                from .sim.async_fl import AsyncSimulator as Sim
            else:
                from .sim.turboaggregate import TurboAggregateSimulator as Sim
            return Sim(self.cfg, self.dataset, self.model, device=self.device)
        if opt in _OWN_NET_SIMULATORS:
            from .sim.engine import refuse_special_simulator

            refuse_special_simulator(self.cfg, opt)  # before the data is loaded
            if self.dataset is None:
                from .data import loader

                self.dataset = loader.load(self.cfg)
            return _own_net_simulator(opt)(self.cfg, self.dataset, device=self.device)
        if opt in C.FEDERATED_OPTIMIZER_MYAVG_ALIASES:
            from .sim.myavg import MyAvgSimulator, refuse_unported_myavg

            refuse_unported_myavg(self.cfg)
            self._load_dataset_and_model()
            return MyAvgSimulator(self.cfg, self.dataset, self.model, device=self.device)
        self._load_dataset_and_model()
        from .sim.engine import MeshSimulator

        return MeshSimulator(self.cfg, self.dataset, self.model, algorithm=client_trainer,
                             device=self.device)

    def run(self):
        return self.runner.run()


def _own_net_simulator(opt: str):
    """The simulator class of one of the six that build their own
    networks."""
    module, name = _OWN_NET_SIMULATORS[opt]
    return getattr(importlib.import_module(f".sim.{module}", __package__), name)
