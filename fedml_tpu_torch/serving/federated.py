"""Federated serving managers: train-then-serve endpoints.

The port of ``fedml_tpu/serving/federated.py`` (the reference's
``FedMLModelServingServer`` / ``Client``): the cross-silo server and
clients under an endpoint identity (end_point_name, model_name,
model_version).  When the federated run completes, the final global model
is saved as a card artifact (``save_params_card``: wire bytes in flax
layout, the reference's format), registered as a ``ModelCard`` and (with a
deploy scheduler) deployed as a live endpoint; ``extra.model_publish_dir``
rides into the card, so the replicas hot-swap the versions the server
publishes.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

from ..core.device import resolve_device
from ..core.flags import cfg_extra
from ..cross_silo import build_client, build_server
from .deploy import ModelCard, ModelDeployScheduler, save_params_card

#: the federated optimizers whose result the serving platform deploys
SERVING_OPTIMIZERS = ("FedAvg", "FedAvg_seq", "FedOpt", "FedProx")


def refuse_unservable_optimizer(cfg) -> None:
    """The serving platform deploys a FedAvg-family result only (the
    reference raises a bare ``Exception``; this names the limit)."""
    if cfg.federated_optimizer not in SERVING_OPTIMIZERS:
        raise ValueError(
            f"federated serving supports FedAvg-family optimizers, got {cfg.federated_optimizer!r}"
        )


class FedMLModelServingServer:
    def __init__(self, cfg, end_point_name: str, model_name: str, model_version: str = "v1",
                 dataset=None, model=None, scheduler: Optional[ModelDeployScheduler] = None,
                 backend: Optional[str] = None, device=None):
        self.cfg = cfg
        self.end_point_name = end_point_name
        self.model_name = model_name
        self.model_version = model_version
        self.scheduler = scheduler
        self.dataset = dataset
        self.model = model
        refuse_unservable_optimizer(cfg)
        self.server = build_server(cfg, dataset, model, resolve_device(device), backend=backend)

    def run(self, timeout: float = 600.0, artifact_dir: Optional[str] = None,
            replicas: int = 1, feature_dim: Optional[str] = None):
        """Run the federated job; on completion register + deploy the model
        (its artifact under ``artifact_dir``, a temporary directory by
        default)."""
        history = self.server.run_until_done(timeout=timeout)
        card = None
        if self.scheduler is not None:
            artifact_dir = artifact_dir or os.path.join(tempfile.gettempdir(),
                                                        "fedml_tpu_torch_serving")
            path = f"{artifact_dir}/{self.model_name}-{self.model_version}.wire"
            save_params_card(self.server.aggregator.global_vars, path)
            card = ModelCard(
                name=self.model_name, version=self.model_version,
                model=self.cfg.model, classes=self.dataset.class_num, params_path=path,
                publish_dir=cfg_extra(self.cfg, "model_publish_dir") or None,
                feature_dim=feature_dim,
            )
            self.scheduler.cards.register(card)
            self.scheduler.deploy(self.end_point_name, self.model_name,
                                  self.model_version, replicas=replicas)
        return history, card


class FedMLModelServingClient:
    def __init__(self, cfg, end_point_name: str, model_name: str, model_version: str = "v1",
                 dataset=None, model=None, rank: int = 1, backend: Optional[str] = None,
                 device=None):
        self.end_point_name = end_point_name
        self.model_name = model_name
        self.model_version = model_version
        self.client = build_client(cfg, dataset, model, rank, resolve_device(device),
                                   backend=backend)

    def run_in_thread(self):
        return self.client.run_in_thread()

    def finish(self):
        self.client.finish()


#: the reference runner's refusal of a privacy flag on this platform
SECURE_REFUSAL = ("{flag} is not wired into the model_serving platform; run the "
                  "secure-aggregation job under training_type='cross_silo' and deploy the result")


def refuse_secure_serving(cfg) -> None:
    """The serving managers wrap the plain cross-silo constructors; silently
    dropping a privacy flag is worse than refusing (reference
    ``runner.py:244-252``)."""
    for flag in ("enable_secagg", "enable_fhe"):
        if getattr(cfg, flag, False):
            raise NotImplementedError(SECURE_REFUSAL.format(flag=flag))


class ServingJobRunner:
    """``training_type: model_serving`` (reference ``runner.py:240-300``): a
    federated run under an endpoint identity.  As ``role: server`` over an
    in-process backend (INPROC, or TCP with ``tcp_base_port`` 0) it runs the
    server and ``client_num_in_total`` serving clients as threads of this
    process; as a lone server it waits
    for silos elsewhere; as ``role: client`` it runs silo ``cfg.rank``.
    After :meth:`run`, ``server`` holds the finished server (its
    ``aggregator.global_vars`` the final global)."""

    def __init__(self, cfg, dataset, model, device, timeout: float = 600.0):
        self.cfg, self.dataset, self.model, self.device = cfg, dataset, model, device
        self.timeout = timeout
        self.end_point = str(cfg_extra(cfg, "end_point_name") or f"ep-{cfg.run_id}")
        self.model_name = str(cfg_extra(cfg, "serving_model_name") or cfg.model)
        self.version = str(cfg_extra(cfg, "model_version"))
        self.server: Optional[FedMLModelServingServer] = None
        self.clients: list = []

    def run(self):
        from .. import constants as C
        from ..comm.comm_manager import reset_in_memory_fabric
        from ..comm.tcp_backend import link_ports
        from ..cross_silo import in_process_group

        cfg = self.cfg
        ident = (self.end_point, self.model_name, self.version)
        if cfg.role != "server":
            client = FedMLModelServingClient(cfg, *ident, dataset=self.dataset, model=self.model,
                                             rank=int(cfg.rank), device=self.device)
            self.clients = [client]
            thread = client.run_in_thread()
            client.client.done.wait()
            thread.join(timeout=5.0)
            return None
        # the in-process group: INPROC (the reference's single-process
        # backends), or TCP on ports the system picks (tcp_base_port 0)
        backend = (C.COMM_BACKEND_INPROC if cfg.backend in (C.COMM_BACKEND_INPROC, "MESH", "")
                   else cfg.backend)
        if in_process_group(cfg):
            reset_in_memory_fabric(str(getattr(cfg, "run_id", "0")))
            self.clients = [
                FedMLModelServingClient(cfg, *ident, dataset=self.dataset, model=self.model,
                                        rank=r, backend=backend, device=self.device)
                for r in range(1, cfg.client_num_in_total + 1)]
        self.server = FedMLModelServingServer(cfg, *ident, dataset=self.dataset,
                                              model=self.model, backend=backend,
                                              device=self.device)
        link_ports([self.server.server, *(c.client for c in self.clients)])
        for c in self.clients:
            c.client.on_error = self.server.server.abort
            c.run_in_thread()
        try:
            history, _card = self.server.run(timeout=self.timeout)
        finally:
            for c in self.clients:
                c.finish()
        return history
