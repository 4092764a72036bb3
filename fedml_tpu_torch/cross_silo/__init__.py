"""Cross-silo platform (the port of ``fedml_tpu/cross_silo/__init__.py``).

``FedMLRunner`` with ``training_type: cross_silo`` dispatches on ``role`` as
the reference's ``_CrossSiloRunner.run`` does:

- ``role: server`` over an in-process backend (``INPROC``, or ``MESH`` /
  unset as the reference reads them) runs 1 server + ``client_num_in_total``
  clients as threads of one process over the in-process fabric: the plain
  synchronous server, the buffered-async server (``extra.async_aggregation``,
  ``cross_silo/async_server.py``), LightSecAgg (``enable_secagg``, the
  reference's default ``extra.secagg_method: lightsecagg``,
  ``cross_silo/lightsecagg.py``), Shamir SecAgg (``extra.secagg_method:
  shamir``, ``cross_silo/secagg_shamir.py``) or FHE (``enable_fhe``,
  ``cross_silo/fhe.py``), with the aggregation tree's edge managers
  (``extra.hier_fanout`` / ``hier_topology``, ``cross_silo/edge.py``;
  :func:`build_edges`) on the plain server.  ``backend: TCP`` with
  ``extra.tcp_base_port: 0`` runs the same group over loopback sockets on
  ports the system picks (``comm/tcp_backend.py``, ``link_ports``): an
  in-process convenience of the port, for TCP alone.
- ``role: server`` over any other backend (TCP with a nonzero
  ``tcp_base_port``, GRPC, MQTT_S3) builds the server alone (of any
  protocol, :func:`group_builders`) over ``cfg.backend`` and runs it until
  it finishes; its silos are processes of their own.  The tree is refused
  there, as in a silo: the reference starts edges only in its in-process
  group.
- ``role: client`` (TCP or GRPC on fixed ports, or MQTT_S3 with
  ``extra.mqtt_host``) builds the silo of ``rank`` alone and runs its
  receive loop until the server's FINISH, polling the loop's thread so a
  loop that died ends the process (it raises, where the reference returns).
  Over TCP it listens on ``tcp_base_port + rank`` and over GRPC on
  ``grpc_base_port + rank``, a peer's host from ``extra.tcp_ip_config`` /
  ``grpc_ip_config`` (loopback by default); over MQTT_S3 every party dials
  the broker at ``mqtt_host:mqtt_port`` and shares the HTTP store at
  ``extra.object_store_url``.
- A lone role over a backend whose fabric lives in one process (WEB3 and
  THETASTORE on the in-memory ledger, MQTT_S3 without ``mqtt_host`` on the
  in-memory broker) raises ``ValueError`` (:data:`ONE_PROCESS_FABRIC`): the
  reference's lone server would wait for silos that cannot reach it until
  its timeout.  Those backends run as the in-process group,
  :func:`run_in_process_group` (``backend=...``), as the reference's tests
  run them.

Chunk frames (``extra.comm_chunk_bytes``: INPROC, TCP and GRPC), chaos
(``extra.chaos_*``) and the server and client journals
(``extra.server_journal_dir``, ``client_journal_dir``) run on every backend
and in every role; under the secure protocols and FHE the journals run as
far as the reference's do (Shamir's server journal, the LightSecAgg and FHE
clients' journals, which hold nothing; ``server.py`` and ``client.py`` name
the others' failures in the reference).

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
``NotImplementedError``: SCAFFOLD, FedNova, FedDyn and Mime (the reference
fails on them in its server's receive thread; ROADMAP Queue 3).  Both SecAgg
protocols and FHE take FedAvg alone and every silo each round.

A silo spanning processes (``role: client`` with ``extra.
coordinator_address`` / ``num_processes`` / ``process_id``, the reference's
L64-86 and L130-150): the gloo process group comes up at ``init``; rank 0
is the silo master, the only rank that speaks the protocol; the others run
``silo_dist.run_silo_follower`` (``cross_silo/silo_dist.py``).  Under
SecAgg or FHE it raises the reference's ``NotImplementedError``.
"""

from __future__ import annotations

import time
from typing import Optional

from .. import constants as C
from ..core.flags import cfg_extra
from ..data.dataset import pad_eval_set
from .client import ClientMasterManager, FedMLTrainer, secagg_method
from .server import FedMLAggregator, FedMLServerManager, eval_batch_size

_IN_PROCESS_BACKENDS = (C.COMM_BACKEND_INPROC, "MESH", "")
_LOOPBACK = ("127.0.0.1", "localhost", "::1")
_ROLES = ("server", "client")
#: a lone role over a fabric of one process (a decided difference, ROADMAP
#: Queue 3): the reference's lone server waits for its silos until its
#: timeout (600 s), and its lone silo waits for the server's FINISH for ever
ONE_PROCESS_FABRIC = (
    "role {role!r} alone over backend {backend!r}: {fabric} serves the endpoints of one "
    "process, so silos in other processes cannot reach the server (the reference's lone "
    "server waits for them until its 600 s timeout, its lone silo for ever); run the "
    "in-process group (role 'server' over INPROC, or cross_silo.run_in_process_group(..., "
    "backend={backend!r})){hint}")
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


def build_edges(cfg, device, backend: str = C.COMM_BACKEND_INPROC) -> list:
    """The aggregation tree's edge (and region) managers of ``cfg``, not
    started; empty when the hier flags are unset."""
    from .edge import EdgeAggregatorManager, build_topology

    topo = build_topology(cfg)
    if topo is None:
        return []
    return [EdgeAggregatorManager(cfg, topo, rank=r, device=device, backend=backend)
            for r in topo.aggregator_ranks]


def build_process_group(cfg, dataset, model, device, backend: str = C.COMM_BACKEND_INPROC,
                        global_vars=None, perms=None, logger=None, trust_sampler=None):
    """``(server, clients)`` of the plain synchronous protocol, not started
    (over TCP or gRPC, every endpoint knows the others' ports).  Under the
    aggregation tree the edge managers ride on the server as
    ``server.edges``; :func:`run_group` starts and stops them."""
    from ..comm.comm_manager import reset_in_memory_fabric
    from ..comm.tcp_backend import link_ports

    reset_in_memory_fabric(getattr(cfg, "run_id", "0"))
    server = build_server(cfg, dataset, model, device, backend=backend, global_vars=global_vars,
                          logger=logger, trust_sampler=trust_sampler)
    clients = [build_client(cfg, dataset, model, r, device, backend=backend, perms=perms)
               for r in range(1, cfg.client_num_in_total + 1)]
    server.edges = build_edges(cfg, device, backend)
    link_ports([server, *clients, *server.edges])
    return server, clients


def run_group(server: FedMLServerManager, clients: list, timeout: float = 600.0) -> list:
    """Start the clients' (and the tree's edges') receive loops, run the
    server until it finishes, stop them; returns the server's history.  A
    client or edge handler that raises fails the run (the server's
    ``abort``)."""
    parties = [*clients, *server.edges]
    for c in parties:
        c.on_error = server.abort
        c.run_in_thread()
    try:
        history = server.run_until_done(timeout=timeout)
        for c in parties:
            c.done.wait(5.0)
    finally:
        for c in parties:
            c.finish()
    return history


def run_in_process_group(cfg, dataset, model, device, backend: str = C.COMM_BACKEND_INPROC,
                         timeout: float = 600.0, **hooks) -> list:
    """1 server + ``client_num_in_total`` clients (and the tree's edges) of
    ``cfg``'s protocol as threads of this process over ``backend``; returns
    the server's history (the reference's ``run_in_process_group``, which
    its tests call with every backend).  ``hooks``: the protocol's builder
    hooks (``global_vars``, ``perms``, ...)."""
    build_group = group_builders(cfg)[0]
    server, clients = build_group(cfg, dataset, model, device, backend, **hooks)
    return run_group(server, clients, timeout)


def in_process_group(cfg) -> bool:
    """Whether ``cfg`` runs the server and its silos as threads of this
    process: ``role: server`` over an in-process backend, or over TCP with
    ``tcp_base_port: 0``."""
    if cfg.role != "server":
        return False
    if cfg.backend == C.COMM_BACKEND_TCP:
        return not int(cfg_extra(cfg, "tcp_base_port"))
    return cfg.backend in _IN_PROCESS_BACKENDS


def one_process_fabric(cfg) -> Optional[str]:
    """What keeps ``cfg.backend``'s endpoints in one process (the in-memory
    ledger, or the in-memory broker of MQTT_S3 without ``extra.mqtt_host``),
    or None."""
    from ..comm.comm_manager import LEDGER_BACKENDS

    if cfg.backend in LEDGER_BACKENDS:
        return "the in-memory ledger"
    if cfg.backend == C.COMM_BACKEND_MQTT_S3 and not cfg_extra(cfg, "mqtt_host"):
        return "the in-memory MQTT broker and store"
    return None


def protocol(cfg) -> str:
    """The configuration's cross-silo protocol: ``"plain"``, ``"shamir"``,
    ``"lightsecagg"`` or ``"fhe"``."""
    if getattr(cfg, "enable_secagg", False):
        return secagg_method(cfg)
    return "fhe" if getattr(cfg, "enable_fhe", False) else "plain"


def spanning_silo(cfg) -> bool:
    """Whether this silo spans processes (``extra.coordinator_address`` or
    the environment's coordinator, the reference's routing: its L130-150);
    ``cross_silo/silo_dist.py``."""
    from ..parallel import multihost

    return cfg.role == "client" and (multihost.coordinator(cfg) is not None
                                     or multihost.is_multiprocess())


def refuse_unported_cross_silo(cfg) -> None:
    """Raise for a cross-silo configuration this slice does not serve."""
    if cfg.role not in _ROLES:
        raise ValueError(f"cross-silo role {cfg.role!r}; known: {list(_ROLES)}")
    proto = protocol(cfg)
    secure = proto != "plain"
    if spanning_silo(cfg):
        from .silo_dist import check_spanning_silo

        check_spanning_silo(cfg, secure)
    if cfg.role == "client" and cfg.backend in _IN_PROCESS_BACKENDS:
        raise NotImplementedError(
            f"role 'client' over backend {cfg.backend!r}: a silo of its own needs a "
            "transport between processes: TCP or GRPC on fixed ports, or MQTT_S3 with "
            "extra.mqtt_host and extra.object_store_url")
    if cfg.backend not in _IN_PROCESS_BACKENDS:
        from ..comm.comm_manager import check_backend

        check_backend(cfg.backend)
        fabric = one_process_fabric(cfg)
        if fabric is not None:
            hint = ("; or set extra.mqtt_host and extra.object_store_url"
                    if cfg.backend == C.COMM_BACKEND_MQTT_S3 else "")
            raise ValueError(ONE_PROCESS_FABRIC.format(role=cfg.role, backend=cfg.backend,
                                                       fabric=fabric, hint=hint))
        port_flag = {C.COMM_BACKEND_TCP: "tcp_base_port",
                     C.COMM_BACKEND_GRPC: "grpc_base_port"}.get(cfg.backend)
        if port_flag and not in_process_group(cfg) and not int(cfg_extra(cfg, port_flag)):
            raise ValueError(
                f"extra.{port_flag} 0 binds ports the system picks, which only endpoints of "
                "one process can share (the in-process group: role 'server' over TCP, or "
                "cross_silo.run_in_process_group); a lone server or silo needs the fixed "
                f"ports {port_flag} + rank")
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
        raise ValueError("extra.async_aggregation is not used by the secure servers (the "
                         "reference ignores it there); remove it")
    from .edge import EDGES_IN_PROCESS_ONLY, build_topology, hop_codec_from_config

    topo = build_topology(cfg)  # the reference's validation; secure modes raise
    hop_codec_from_config(cfg)
    if topo is not None:
        if not in_process_group(cfg):
            raise ValueError(EDGES_IN_PROCESS_ONLY)
        if cfg_extra(cfg, "async_aggregation"):
            from .async_server import refuse_hierarchical_async

            refuse_hierarchical_async(cfg)
    if cfg.federated_optimizer not in _CROSS_SILO_OPTIMIZERS:
        from ..algorithms import names

        simulated = [n for n in names() if n not in _CROSS_SILO_OPTIMIZERS]
        raise NotImplementedError(
            f"cross-silo federated_optimizer {cfg.federated_optimizer!r}: a silo uploads its "
            f"full variables, which is the contribution of {_CROSS_SILO_OPTIMIZERS} alone; "
            f"{simulated} contribute something else and run in the simulator")
    from .client import refuse_unported_client
    from .server import refuse_unported_server

    refuse_unported_server(cfg, secure=None if proto == "plain" else proto)
    refuse_unported_client(cfg)
    if getattr(cfg, "enable_fhe", False):
        # also beside enable_secagg, which the reference's builders would
        # take while dropping FHE unseen
        from .fhe import check_fhe_compatible

        check_fhe_compatible(cfg)
    if proto == "lightsecagg":
        from .lightsecagg import secagg_params

        secagg_params(cfg)
    elif proto == "shamir":
        from .secagg_shamir import shamir_secagg_params

        shamir_secagg_params(cfg)
    if secure and cfg.client_num_per_round < cfg.client_num_in_total:
        name = {"lightsecagg": "LightSecAgg", "shamir": "Shamir SecAgg",
                "fhe": "FHE aggregation"}[proto]
        raise ValueError(
            f"{name} requires full participation per round (client_num_per_round="
            f"{cfg.client_num_per_round} != N={cfg.client_num_in_total})")


#: the parity hooks each protocol's server takes, and every client
_SERVER_HOOKS = {"plain": ("global_vars", "logger", "trust_sampler"),
                 "shamir": ("global_vars", "logger", "noise_sampler"),
                 "lightsecagg": ("global_vars", "logger"),
                 "fhe": ("global_vars", "logger")}
_CLIENT_HOOKS = ("perms",)
_ALL_HOOKS = ("global_vars", "perms", "noise_sampler", "trust_sampler", "mask_seeds",
              "upload_noise", "logger")


def group_builders(cfg) -> tuple:
    """``(build_group, build_server, build_client)`` of ``cfg``'s protocol:
    the in-process group's builder and the lone server's and silo's, each
    ``(cfg, dataset, model, [rank,] device, backend, **hooks)``."""
    proto = protocol(cfg)
    if proto == "shamir":
        from .secagg_shamir import (build_sa_client, build_sa_server,
                                    build_shamir_secagg_process_group)

        return build_shamir_secagg_process_group, build_sa_server, build_sa_client
    if proto == "lightsecagg":
        from .lightsecagg import build_lightsecagg_process_group, build_lsa_client, build_lsa_server

        return build_lightsecagg_process_group, build_lsa_server, build_lsa_client
    if proto == "fhe":
        from .fhe import build_fhe_client, build_fhe_process_group, build_fhe_server

        return build_fhe_process_group, build_fhe_server, build_fhe_client
    return build_process_group, build_server, build_client


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
        #: a follower rank of a silo spanning processes (``silo_dist.py``)
        self.follower = False

    def _hooks(self, names) -> dict:
        return {k: getattr(self, k) for k in names if getattr(self, k) is not None}

    def setup(self) -> None:
        """Build what this process runs (module docstring): the in-process
        group, the server alone, or the silo of ``cfg.rank`` alone (their
        shards go to the device)."""
        proto = protocol(self.cfg)
        allowed = set(_SERVER_HOOKS[proto]) | set(_CLIENT_HOOKS) | {"upload_noise"}
        if proto == "lightsecagg":
            allowed.add("mask_seeds")
        stray = sorted(k for k in _ALL_HOOKS if getattr(self, k) is not None and k not in allowed)
        if stray:
            raise ValueError(f"hooks {stray} are not used by the {proto} protocol "
                             "(noise_sampler: Shamir SecAgg's central DP; trust_sampler: the "
                             "plain server's trust pipeline; mask_seeds: LightSecAgg)")
        build_group, build_srv, build_cli = group_builders(self.cfg)
        backend = (C.COMM_BACKEND_INPROC if self.cfg.backend in _IN_PROCESS_BACKENDS
                   else self.cfg.backend)
        if in_process_group(self.cfg):
            hooks = self._hooks(set(_SERVER_HOOKS[proto]) | set(_CLIENT_HOOKS))
            if proto == "lightsecagg" and self.mask_seeds is not None:
                hooks["mask_seeds"] = self.mask_seeds
            self.server, self.clients = build_group(self.cfg, self.dataset, self.model,
                                                    self.device, backend, **hooks)
        elif self.cfg.role == "server":
            self.server = build_srv(self.cfg, self.dataset, self.model, self.device,
                                    backend=backend, **self._hooks(_SERVER_HOOKS[proto]))
        elif spanning_silo(self.cfg):
            self._setup_spanning_silo(backend)
        else:
            rank = int(self.cfg.rank)
            hooks = self._hooks(_CLIENT_HOOKS)
            if proto == "lightsecagg" and self.mask_seeds is not None:
                hooks["mask_seed"] = self.mask_seeds.get(rank)
            self.clients = [build_cli(self.cfg, self.dataset, self.model, rank, self.device,
                                      backend=backend, **hooks)]
        for c in self.clients:
            c.upload_noise = self.upload_noise

    def _setup_spanning_silo(self, backend: str) -> None:
        """A silo spanning the process group (the reference's L64-86): the
        master (rank 0) builds the client over :class:`DistributedSiloTrainer`;
        a follower builds nothing and runs ``run_silo_follower``."""
        from ..parallel import multihost
        from .silo_dist import DistributedSiloTrainer

        # the process group is up since ``fedml_tpu_torch.init``
        if multihost.process_index() != 0:
            self.follower = True
            return
        rank = int(self.cfg.rank)
        ix = self.dataset.client_idx[rank - 1]
        trainer = DistributedSiloTrainer(self.cfg, self.model, self.dataset.train_x[ix],
                                         self.dataset.train_y[ix], self.device,
                                         **self._hooks(_CLIENT_HOOKS))
        self.clients = [ClientMasterManager(self.cfg, trainer, rank=rank, backend=backend)]

    def run(self):
        """The server's history, or None for a silo (as the reference)."""
        if self.server is None and not self.clients and not self.follower:
            self.setup()
        if self.follower:
            from .silo_dist import run_silo_follower

            ix = self.dataset.client_idx[int(self.cfg.rank) - 1]
            run_silo_follower(self.cfg, self.model, self.dataset.train_x[ix],
                              self.dataset.train_y[ix], self.device)
            return None
        if self.server is None:
            try:
                run_silo(self.clients[0], self.timeout)
            finally:  # release a spanning silo's followers, even on a failure
                finish = getattr(self.clients[0].trainer, "finish", None)
                if callable(finish):
                    finish()
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
