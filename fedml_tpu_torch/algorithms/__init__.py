"""Algorithm registry (the port of ``fedml_tpu/algorithms/__init__.py``):
the FedAvg family (FedAvg, FedOpt, FedProx, FedNova, FedDyn, SCAFFOLD,
Mime) and FedSGD, each on both simulator backends."""

from __future__ import annotations

from .. import constants as C
from ..core.flags import cfg_extra
from ..fl.algorithm import FedAlgorithm
from ..fl.types import HParams
from .fedavg import FedAvg, FedAvgSeq
from .feddyn import FedDyn
from .fednova import FedNova
from .fedopt import FedOpt, FedOptSeq
from .fedprox import FedProx
from .fedsgd import FedSGD
from .mime import Mime
from .scaffold import Scaffold

_REGISTRY = {
    C.FEDERATED_OPTIMIZER_FEDAVG: FedAvg,
    C.FEDERATED_OPTIMIZER_FEDAVG_SEQ: FedAvgSeq,
    C.FEDERATED_OPTIMIZER_FEDOPT: FedOpt,
    C.FEDERATED_OPTIMIZER_FEDOPT_SEQ: FedOptSeq,
    C.FEDERATED_OPTIMIZER_FEDPROX: FedProx,
    C.FEDERATED_OPTIMIZER_FEDNOVA: FedNova,
    C.FEDERATED_OPTIMIZER_FEDDYN: FedDyn,
    C.FEDERATED_OPTIMIZER_SCAFFOLD: Scaffold,
    C.FEDERATED_OPTIMIZER_MIME: Mime,
    C.FEDERATED_OPTIMIZER_FEDSGD: FedSGD,
}


def names() -> list[str]:
    return sorted(_REGISTRY)


def create(cfg, hp: HParams = None) -> FedAlgorithm:
    """Build the algorithm named by ``cfg.federated_optimizer``."""
    if hp is None:
        hp = hparams_from_config(cfg)
    try:
        cls = _REGISTRY[cfg.federated_optimizer]
    except KeyError:
        raise ValueError(f"unknown federated_optimizer {cfg.federated_optimizer!r}; "
                         f"known: {names()}") from None
    return cls(hp, cfg)


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
