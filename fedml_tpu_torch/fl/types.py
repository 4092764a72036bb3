"""Shared FL types (the port of ``fedml_tpu/fl/types.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any


@dataclass(frozen=True)
class HParams:
    """Static hyperparameters of the local problem."""

    epochs: int = 1
    batch_size: int = 32
    learning_rate: float = 0.03
    momentum: float = 0.0
    weight_decay: float = 0.0
    client_optimizer: str = "sgd"
    server_optimizer: str = "sgd"
    server_lr: float = 1.0
    server_momentum: float = 0.0
    fedprox_mu: float = 0.0
    feddyn_alpha: float = 0.01
    mime_momentum: float = 0.9
    steps_per_epoch: int = 0  # ceil(capacity / batch_size)
    step_mode: str = "match"  # match reference per-client step counts | fixed
    compute_dtype: str = "float32"
    loss: str = "cross_entropy"
    fused_blocks: bool = False

    @property
    def local_steps(self) -> int:
        return self.epochs * self.steps_per_epoch


@dataclass
class ClientOutput:
    """What a client sends up: its contribution (full variables for the
    FedAvg family), refreshed persistent client state, and local metrics."""

    contribution: Any
    client_state: Any
    metrics: dict
