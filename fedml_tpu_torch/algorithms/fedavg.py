"""FedAvg / FedAvg_seq (the port of ``fedml_tpu/algorithms/fedavg.py``): the
base :class:`~fedml_tpu_torch.fl.algorithm.FedAlgorithm` is FedAvg; these
classes carry the registry names."""

from __future__ import annotations

from ..fl.algorithm import FedAlgorithm


class FedAvg(FedAlgorithm):
    name = "FedAvg"


class FedAvgSeq(FedAlgorithm):
    name = "FedAvg_seq"
