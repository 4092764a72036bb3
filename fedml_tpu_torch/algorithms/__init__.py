"""Algorithm registry (the port of ``fedml_tpu/algorithms/__init__.py``).
Ported so far: the FedAvg family and FedSGD."""

from __future__ import annotations

from .. import constants as C
from ..core.flags import cfg_extra
from ..fl.algorithm import FedAlgorithm
from ..fl.types import HParams
from .fedavg import FedAvg, FedAvgSeq
from .fedsgd import FedSGD

_REGISTRY = {
    C.FEDERATED_OPTIMIZER_FEDAVG: FedAvg,
    C.FEDERATED_OPTIMIZER_FEDAVG_SEQ: FedAvgSeq,
    C.FEDERATED_OPTIMIZER_FEDSGD: FedSGD,
}

# algorithms of the JAX package that later slices port
_LATER = (
    C.FEDERATED_OPTIMIZER_FEDOPT, C.FEDERATED_OPTIMIZER_FEDOPT_SEQ,
    C.FEDERATED_OPTIMIZER_FEDPROX, C.FEDERATED_OPTIMIZER_FEDNOVA,
    C.FEDERATED_OPTIMIZER_FEDDYN, C.FEDERATED_OPTIMIZER_SCAFFOLD,
    C.FEDERATED_OPTIMIZER_MIME,
)


def names() -> list[str]:
    return sorted(_REGISTRY)


def create(cfg, hp: HParams = None) -> FedAlgorithm:
    """Build the algorithm named by ``cfg.federated_optimizer``."""
    if hp is None:
        hp = hparams_from_config(cfg)
    name = cfg.federated_optimizer
    if name in _LATER:
        raise NotImplementedError(
            f"federated_optimizer {name!r} is not ported yet (ported: {names()})")
    if name not in _REGISTRY:
        raise ValueError(f"unknown federated_optimizer {name!r}; known: {names()}")
    return _REGISTRY[name](hp, cfg)


def hparams_from_config(cfg, steps_per_epoch: int = 0) -> HParams:
    return HParams(
        epochs=cfg.epochs,
        batch_size=cfg.batch_size,
        learning_rate=cfg.learning_rate,
        momentum=cfg.momentum,
        weight_decay=cfg.weight_decay,
        client_optimizer=cfg.client_optimizer,
        server_optimizer=cfg.server_optimizer,
        server_lr=cfg.server_lr,
        server_momentum=cfg.server_momentum,
        fedprox_mu=cfg.fedprox_mu,
        feddyn_alpha=cfg.feddyn_alpha,
        mime_momentum=cfg.mime_momentum,
        steps_per_epoch=steps_per_epoch,
        step_mode=getattr(cfg, "step_mode", "match"),
        compute_dtype=cfg.compute_dtype,
        fused_blocks=bool(cfg_extra(cfg, "fused_blocks")),
    )
