"""FedMLRunner — platform dispatch (the port of ``fedml_tpu/runner.py``).

Ported so far: the simulation platform with the algorithms of the registry
(``algorithms/__init__.py``: the FedAvg family and FedSGD) and the
hierarchical, MyAvg and FedLLM simulators (``HierarchicalFL``, ``MyAvg`` /
``MyAgg-7``, ``FedLLM``: ``sim/hierarchical.py``, ``sim/myavg.py``,
``llm/fedllm.py``; FedLLM builds its own transformer, not a ``model_hub``
model), and the
cross-silo platform (``cross_silo/``: the plain synchronous server, Shamir
SecAgg and LightSecAgg, in one process); every other platform and optimizer
raises ``NotImplementedError``.

Trust flags as the reference routes them (L17-41, L113-140): attack,
defense, DP and contribution run on the engine's FedAvg family (MESH and
sp); MyAvg takes attack, defense and DP and refuses the rest itself; every
other special simulator refuses them all; SecAgg and FHE are cross-silo
protocols, refused in simulation.
"""

from __future__ import annotations

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

_PORTED_PLATFORMS = (C.TRAINING_PLATFORM_SIMULATION, C.TRAINING_PLATFORM_CROSS_SILO)
# simulators of their own (reference runner.py L158, L194), beside the
# registry's algorithms on the engine
_SPECIAL_SIMULATORS = ((C.FEDERATED_OPTIMIZER_HIERARCHICAL_FL, C.FEDERATED_OPTIMIZER_FEDLLM)
                       + C.FEDERATED_OPTIMIZER_MYAVG_ALIASES)
_PORTED_OPTIMIZERS = tuple(algorithms.names()) + _SPECIAL_SIMULATORS


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
        if cfg.federated_optimizer not in _PORTED_OPTIMIZERS:
            raise NotImplementedError(f"federated_optimizer {cfg.federated_optimizer!r} is "
                                      f"not ported yet (ported: {_PORTED_OPTIMIZERS})")
        if server_aggregator is not None:
            raise NotImplementedError("custom server_aggregator is not ported yet")
        _check_unimplemented_flags(cfg)
        if cfg.training_type == C.TRAINING_PLATFORM_CROSS_SILO:
            if client_trainer is not None:
                raise NotImplementedError("custom client_trainer is not ported to cross-silo yet")
            from .cross_silo import create_cross_silo_runner, refuse_unported_cross_silo

            refuse_unported_cross_silo(cfg)  # before the data is loaded
            self._load_dataset_and_model()
            self.runner = create_cross_silo_runner(cfg, self.dataset, self.model, self.device)
        else:
            self.runner = self._init_simulation_runner(client_trainer)

    def _load_dataset_and_model(self) -> None:
        if self.dataset is None:
            from .data import loader

            self.dataset = loader.load(self.cfg)
        if self.model is None:
            from .models import model_hub

            self.model = model_hub.create(self.cfg, self.dataset.class_num,
                                          input_shape=self.dataset.train_x.shape[1:])

    def _init_simulation_runner(self, client_trainer):
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
            if client_trainer is not None:
                raise ValueError(f"a custom client_trainer is not used by the {opt!r} "
                                 "simulator; remove it or use a FedAvg-family optimizer")
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
