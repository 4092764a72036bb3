"""Cross-silo platform (the port of ``fedml_tpu/cross_silo/__init__.py``).

``FedMLRunner`` with ``training_type: cross_silo`` dispatches on ``role`` as
the reference's ``_CrossSiloRunner.run`` does:

- ``role: server`` over an in-process backend (``INPROC``, or ``MESH`` /
  unset as the reference reads them) runs 1 server + ``client_num_in_total``
  clients as threads of one process over the in-process fabric: the plain
  synchronous server, the buffered-async server (``extra.async_aggregation``,
  ``cross_silo/async_server.py``), LightSecAgg (``enable_secagg``, the
  reference's default ``extra.secagg_method: lightsecagg``,
  ``cross_silo/lightsecagg.py``) or Shamir SecAgg (``extra.secagg_method:
  shamir``, ``cross_silo/secagg_shamir.py``).  ``backend: TCP`` with
  ``extra.tcp_base_port: 0`` runs the same group over loopback sockets on
  ports the system picks (``comm/tcp_backend.py``, ``link_ports``): an
  in-process convenience of the port, the reference's
  ``run_in_process_group(..., backend="TCP")``.
- ``role: server`` over TCP with a nonzero ``tcp_base_port`` builds the
  server alone, listening on ``tcp_base_port``, and runs it until it
  finishes; its silos are processes of their own.
- ``role: client`` (TCP, nonzero ``tcp_base_port``) builds the silo of
  ``rank`` alone, listening on ``tcp_base_port + rank``, and runs its receive
  loop until the server's FINISH, polling the loop's thread so a loop that
  died ends the process (it raises, where the reference returns).  A peer's
  host comes from ``extra.tcp_ip_config`` (rank -> host; loopback by
  default), so silos may run on other hosts.

Chunk frames (``extra.comm_chunk_bytes``), chaos (``extra.chaos_*``) and the
server and client journals (``extra.server_journal_dir``,
``client_journal_dir``) run on either backend and in every role.

The plain and async servers run the trust pipeline
(``build_trust_pipeline``): attacks, defenses, local and central DP, as the
reference's do.

Parity hooks, read when the group is built (:meth:`_CrossSiloRunner.setup`,
which :meth:`run` calls): ``global_vars`` (the initial global model, the
port's tree; default: the port's own init stream), ``perms`` (the clients'
per-epoch permutations, ``perms(round, client, epochs, cap)``),
``noise_sampler`` (the central-DP draws of Shamir SecAgg), ``trust_sampler``
(the trust pipeline's draws on the plain and async servers,
``trust/dp/dp.py`` ``NoiseSampler``'s methods), ``mask_seeds``
(LightSecAgg's client mask seeds by rank; default OS entropy),
``upload_noise`` (the upload codec's uniform draws, ``upload_noise(round,
rank, leaf, shape, device)``; default the clients' generators) and
``logger`` (the server's metrics logger).

Compressed uploads (``extra.comm_compression: qsgd8 | topk``) and
``extra.streaming_aggregation`` run on the plain and async protocols: delta
uploads on wire v2, folded on the server's device as they land.  Under
Shamir SecAgg with ``secagg_stream``, ``qsgd8`` selects the
quantize-then-mask ring; under the other secure configurations the codec is
ignored, as in the reference.

Algorithms: FedAvg, FedOpt and FedProx (their contribution is the client's
full variables; the server runs the algorithm's ``aggregate`` and
``server_update`` on the uploads, the client plain local SGD).  Refused with
``NotImplementedError``, each naming ROADMAP Queue 1 item 7 where it waits:
SCAFFOLD, FedNova, FedDyn and Mime; any backend but INPROC and TCP (GRPC and
MQTT_S3 need packages the port does not depend on); the client role under
SecAgg, LightSecAgg or FHE; TCP under SecAgg; multi-process silos
(``extra.coordinator_address``, the reference's ``silo_dist.py``) and FHE.
Both SecAgg protocols take FedAvg alone.
"""

from __future__ import annotations

import time
from typing import Optional

from .. import constants as C
from ..core.flags import cfg_extra
from ..data.dataset import pad_eval_set
from .client import ClientMasterManager, FedMLTrainer
from .server import FedMLAggregator, FedMLServerManager, eval_batch_size

_IN_PROCESS_BACKENDS = (C.COMM_BACKEND_INPROC, "MESH", "")
_LOOPBACK = ("127.0.0.1", "localhost", "::1")
_ROLES = ("server", "client")
#: where the refusals below wait (ROADMAP.md)
_ITEM_7 = "ROADMAP.md Queue 1 item 7"
# the algorithms whose contribution is the client's full variables: the
# server applies their aggregate and server step to the uploaded models, and
# the client trains with plain local SGD (no hooks: FedProx trains without
# its proximal term, as the reference's client does).  The registry's others
# contribute something else (normalized updates, control variates, full
# gradients), which the cross-silo wire does not carry.
_CROSS_SILO_OPTIMIZERS = (C.FEDERATED_OPTIMIZER_FEDAVG, C.FEDERATED_OPTIMIZER_FEDAVG_SEQ,
                          C.FEDERATED_OPTIMIZER_FEDOPT, C.FEDERATED_OPTIMIZER_FEDOPT_SEQ,
                          C.FEDERATED_OPTIMIZER_FEDPROX)


def build_aggregator(cfg, dataset, model, device, global_vars=None, trust_sampler=None
                     ) -> FedMLAggregator:
    """The plain server's aggregator with the configuration's trust
    pipeline (None when no trust flag is set); ``trust_sampler`` is its
    draws' parity hook."""
    from ..trust.pipeline import build_trust_pipeline

    test_arrays = pad_eval_set(dataset.test_x, dataset.test_y, eval_batch_size(cfg))
    return FedMLAggregator(cfg, model, test_arrays, device, global_vars=global_vars,
                           trust=build_trust_pipeline(cfg, trust_sampler))


def build_server(cfg, dataset, model, device, backend: Optional[str] = None, global_vars=None,
                 logger=None, trust_sampler=None) -> FedMLServerManager:
    """The plain synchronous server, or the buffered-async one under
    ``extra.async_aggregation``."""
    aggregator = build_aggregator(cfg, dataset, model, device, global_vars=global_vars,
                                  trust_sampler=trust_sampler)
    if cfg_extra(cfg, "async_aggregation"):
        from .async_server import AsyncFedMLServerManager

        return AsyncFedMLServerManager(cfg, aggregator, backend=backend, logger=logger)
    return FedMLServerManager(cfg, aggregator, backend=backend, logger=logger)


def build_client(cfg, dataset, model, rank: int, device, backend: Optional[str] = None,
                 perms=None) -> ClientMasterManager:
    ix = dataset.client_idx[rank - 1]
    trainer = FedMLTrainer(cfg, model, dataset.train_x[ix], dataset.train_y[ix], device,
                           perms=perms)
    return ClientMasterManager(cfg, trainer, rank=rank, backend=backend)


def build_process_group(cfg, dataset, model, device, backend: str = C.COMM_BACKEND_INPROC,
                        global_vars=None, perms=None, logger=None, trust_sampler=None):
    """``(server, clients)`` of the plain synchronous protocol, not started
    (over TCP, every endpoint knows the others' ports)."""
    from ..comm.inproc import InProcRouter
    from ..comm.tcp_backend import link_ports

    InProcRouter.reset(str(getattr(cfg, "run_id", "0")))
    server = build_server(cfg, dataset, model, device, backend=backend, global_vars=global_vars,
                          logger=logger, trust_sampler=trust_sampler)
    clients = [build_client(cfg, dataset, model, r, device, backend=backend, perms=perms)
               for r in range(1, cfg.client_num_in_total + 1)]
    link_ports([server, *clients])
    return server, clients


def run_group(server: FedMLServerManager, clients: list, timeout: float = 600.0) -> list:
    """Start the clients' receive loops, run the server until it finishes,
    stop the clients; returns the server's history.  A client handler that
    raises fails the run (the server's ``abort``)."""
    for c in clients:
        c.on_error = server.abort
        c.run_in_thread()
    try:
        history = server.run_until_done(timeout=timeout)
        for c in clients:
            c.done.wait(5.0)
    finally:
        for c in clients:
            c.finish()
    return history


def in_process_group(cfg) -> bool:
    """Whether ``cfg`` runs the server and its silos as threads of this
    process: ``role: server`` over an in-process backend, or over TCP with
    ``tcp_base_port: 0``."""
    return cfg.role == "server" and (cfg.backend in _IN_PROCESS_BACKENDS
                                     or not int(cfg_extra(cfg, "tcp_base_port")))


def refuse_unported_cross_silo(cfg) -> None:
    """Raise for a cross-silo configuration this slice does not serve."""
    if cfg.role not in _ROLES:
        raise ValueError(f"cross-silo role {cfg.role!r}; known: {list(_ROLES)}")
    secure = bool(getattr(cfg, "enable_secagg", False))
    if cfg_extra(cfg, "coordinator_address") or int(cfg_extra(cfg, "num_processes") or 0) > 1:
        raise NotImplementedError(
            "multi-process silos (extra.coordinator_address / num_processes, the reference's "
            f"silo_dist.py) are not ported yet ({_ITEM_7}); run each silo as one process")
    if cfg.role == "client":
        if secure or getattr(cfg, "enable_fhe", False):
            raise NotImplementedError(
                "the client role under SecAgg, LightSecAgg or FHE is not ported yet "
                f"({_ITEM_7}); those protocols run as one process (role 'server', INPROC)")
        if cfg.backend in _IN_PROCESS_BACKENDS:
            raise NotImplementedError(
                f"role 'client' over backend {cfg.backend!r}: a silo of its own needs a "
                "transport between processes, and of those the port has TCP alone (gRPC "
                f"and MQTT_S3 wait, {_ITEM_7}); set backend TCP")
    if cfg.backend not in _IN_PROCESS_BACKENDS:
        from ..comm.comm_manager import refuse_unported_transport

        refuse_unported_transport(cfg.backend)
        if secure:
            raise NotImplementedError(f"cross-silo backend {cfg.backend!r} is ported for the "
                                      f"plain server only (synchronous or async), not yet "
                                      f"under SecAgg ({_ITEM_7})")
        if cfg.role == "client" and not int(cfg_extra(cfg, "tcp_base_port")):
            raise ValueError(
                "extra.tcp_base_port 0 binds ports the system picks, which only endpoints of "
                "one process can share (the in-process group of role 'server'); a silo "
                "process of its own needs the fixed ports tcp_base_port + rank")
        if in_process_group(cfg):
            remote = {str(h) for h in (cfg_extra(cfg, "tcp_ip_config") or {}).values()} - set(
                _LOOPBACK)
            if remote:
                raise NotImplementedError(
                    f"a TCP run over other hosts ({sorted(remote)}) with tcp_base_port 0 runs "
                    "the server and its silos in this one process; set a nonzero "
                    "tcp_base_port and start the silos as processes of their own "
                    "(role 'client')")
    if cfg.role == "client":
        n = cfg.client_num_in_total
        if not 1 <= int(cfg.rank) <= n:
            raise ValueError(f"role 'client' needs a rank in 1..{n}, got {cfg.rank}")
    if cfg_extra(cfg, "async_aggregation") and secure:
        raise ValueError("extra.async_aggregation is not used by the SecAgg servers (the "
                         "reference ignores it there); remove it")
    if cfg.federated_optimizer not in _CROSS_SILO_OPTIMIZERS:
        from ..algorithms import names

        simulated = [n for n in names() if n not in _CROSS_SILO_OPTIMIZERS]
        raise NotImplementedError(
            f"cross-silo federated_optimizer {cfg.federated_optimizer!r}: a silo uploads its "
            f"full variables, which is the contribution of {_CROSS_SILO_OPTIMIZERS} alone; "
            f"{simulated} contribute something else and run in the simulator")
    if getattr(cfg, "enable_fhe", False):
        raise NotImplementedError("enable_fhe (the FHE cross-silo protocol) is not ported yet")
    from .client import refuse_unported_client
    from .server import refuse_unported_server

    refuse_unported_server(cfg, secure=secure)
    refuse_unported_client(cfg)
    if secure:
        method = _secagg_method(cfg)
        if method == "lightsecagg":
            from .lightsecagg import secagg_params

            secagg_params(cfg)
        else:
            from .secagg_shamir import shamir_secagg_params

            shamir_secagg_params(cfg)
        if cfg.client_num_per_round < cfg.client_num_in_total:
            name = "LightSecAgg" if method == "lightsecagg" else "Shamir SecAgg"
            raise ValueError(
                f"{name} requires full participation per round (client_num_per_round="
                f"{cfg.client_num_per_round} != N={cfg.client_num_in_total})")


def _secagg_method(cfg) -> str:
    """``"lightsecagg"`` or ``"shamir"``, from ``extra.secagg_method``."""
    method = str(cfg_extra(cfg, "secagg_method")).lower()
    if method in ("lightsecagg", "lsa"):
        return "lightsecagg"
    if method in ("shamir", "secagg", "pairwise"):
        return "shamir"
    raise ValueError(f"unknown secagg_method {method!r}; use 'lightsecagg' or 'shamir'")


class _CrossSiloRunner:
    def __init__(self, cfg, dataset, model, device, timeout: float = 600.0):
        self.cfg, self.dataset, self.model, self.device = cfg, dataset, model, device
        self.timeout = timeout
        # parity hooks (module docstring); None = the port's own
        self.global_vars = None
        self.perms = None
        self.noise_sampler = None
        self.trust_sampler = None
        self.mask_seeds = None
        self.upload_noise = None
        self.logger = None
        self.server: Optional[FedMLServerManager] = None
        self.clients: list = []

    def setup(self) -> None:
        """Build what this process runs (module docstring): the in-process
        group, the server alone, or the silo of ``cfg.rank`` alone (their
        shards go to the device)."""
        if not in_process_group(self.cfg):
            self._setup_role()
            return
        hooks = {k: v for k, v in (("global_vars", self.global_vars), ("perms", self.perms),
                                   ("logger", self.logger)) if v is not None}
        secure = bool(getattr(self.cfg, "enable_secagg", False))
        lsa = secure and _secagg_method(self.cfg) == "lightsecagg"
        if self.noise_sampler is not None and (not secure or lsa):
            raise ValueError("noise_sampler serves Shamir SecAgg's central DP only")
        if self.mask_seeds is not None and not lsa:
            raise ValueError("mask_seeds serves LightSecAgg only")
        if self.trust_sampler is not None and secure:
            raise ValueError("trust_sampler serves the plain server's trust pipeline only")
        if lsa:
            from .lightsecagg import build_lightsecagg_process_group

            if self.mask_seeds is not None:
                hooks["mask_seeds"] = self.mask_seeds
            group = build_lightsecagg_process_group
        elif secure:
            from .secagg_shamir import build_shamir_secagg_process_group

            if self.noise_sampler is not None:
                hooks["noise_sampler"] = self.noise_sampler
            group = build_shamir_secagg_process_group
        else:
            if self.trust_sampler is not None:
                hooks["trust_sampler"] = self.trust_sampler
            group = build_process_group
        backend = (C.COMM_BACKEND_TCP if self.cfg.backend == C.COMM_BACKEND_TCP
                   else C.COMM_BACKEND_INPROC)
        self.server, self.clients = group(self.cfg, self.dataset, self.model, self.device,
                                          backend, **hooks)
        for c in self.clients:
            c.upload_noise = self.upload_noise

    def _setup_role(self) -> None:
        """One endpoint of a run over TCP between processes."""
        if self.noise_sampler is not None or self.mask_seeds is not None:
            raise ValueError("noise_sampler and mask_seeds serve the SecAgg groups only")
        cfg = self.cfg
        if cfg.role == "server":
            hooks = {k: v for k, v in (("global_vars", self.global_vars), ("logger", self.logger),
                                       ("trust_sampler", self.trust_sampler)) if v is not None}
            self.server = build_server(cfg, self.dataset, self.model, self.device,
                                       backend=C.COMM_BACKEND_TCP, **hooks)
            return
        client = build_client(cfg, self.dataset, self.model, int(cfg.rank), self.device,
                              backend=C.COMM_BACKEND_TCP, perms=self.perms)
        client.upload_noise = self.upload_noise
        self.clients = [client]

    def run(self):
        """The server's history, or None for a silo (as the reference)."""
        if self.server is None and not self.clients:
            self.setup()
        if self.server is None:
            run_silo(self.clients[0], self.timeout)
            return None
        if not self.clients:
            return self.server.run_until_done(self.timeout)
        return run_group(self.server, self.clients, self.timeout)


def run_silo(client: ClientMasterManager, timeout: float = 600.0, poll_s: float = 5.0) -> None:
    """Run one silo's receive loop until the server's FINISH; polls the
    loop's thread, so a loop that died on a transport error ends the wait
    (and raises) instead of hanging the process, and raises
    ``TimeoutError`` after ``timeout`` s without FINISH.  The loop handles
    FINISH on its own thread, so after ``done`` nothing of the silo is left
    running mid-kernel when the interpreter exits."""
    thread = client.run_in_thread()
    deadline = time.monotonic() + timeout
    try:
        while not client.done.wait(min(poll_s, max(0.0, deadline - time.monotonic()))):
            if not thread.is_alive() or time.monotonic() >= deadline:
                break
        thread.join(timeout=poll_s)
    finally:
        client.finish()
    if not client.done.is_set():
        if thread.is_alive() or time.monotonic() >= deadline:
            raise TimeoutError(f"silo {client.rank}: no FINISH from the server in {timeout}s")
        raise RuntimeError(f"silo {client.rank}: its receive loop ended before the server's "
                           "FINISH")


def create_cross_silo_runner(cfg, dataset, model, device) -> _CrossSiloRunner:
    """The runner of a configuration ``refuse_unported_cross_silo`` let
    through (``FedMLRunner`` checks it before it loads the data)."""
    return _CrossSiloRunner(cfg, dataset, model, device)
