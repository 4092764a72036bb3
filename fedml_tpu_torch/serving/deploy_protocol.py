"""Master/worker deploy protocol: deployment orchestrated over the comm plane.

The port of ``fedml_tpu/serving/deploy_protocol.py``, over the port's
``comm_manager`` (INPROC and TCP alike):

- :class:`DeployWorkerManager`: one a worker host; owns a local
  :class:`~fedml_tpu_torch.serving.deploy.ModelDeployScheduler` (process
  replicas on its device by default, any ``ReplicaRuntime`` injectable)
  and answers DEPLOY / SCALE / UNDEPLOY commands, reporting ready replica
  ports.
- :class:`DeployMasterManager`: collects worker capacity reports, splits
  requested replicas across workers (capacity-weighted round-robin),
  aggregates readiness, and routes ``predict`` round-robin over every ready
  (worker, port) pair with failover.

Model weights travel by card reference (``params_path`` on a shared
filesystem), as in the reference.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import urllib.request
from typing import Optional

from ..comm.comm_manager import FedMLCommManager
from ..comm.message import Message
from .deploy import ModelCard, ModelDeployScheduler

log = logging.getLogger("fedml_tpu_torch.serving.deploy_protocol")

MSG_TYPE_W2M_WORKER_ONLINE = 60
MSG_TYPE_M2W_DEPLOY = 61
MSG_TYPE_W2M_REPLICA_STATUS = 62
MSG_TYPE_M2W_SCALE = 63
MSG_TYPE_M2W_UNDEPLOY = 64
MSG_TYPE_M2W_FINISH = 65

ARG_ENDPOINT = "endpoint"
ARG_CARD = "card_json"
ARG_REPLICAS = "replicas"
ARG_PORTS = "ready_ports"
ARG_HOST = "host"
ARG_CAPACITY = "capacity"


class DeployWorkerManager(FedMLCommManager):
    """Worker edge: local deploy scheduler behind the comm protocol
    (reference ``worker_protocol_manager.py`` + ``device_model_deployment``)."""

    def __init__(self, cfg, rank: int, workdir: str, backend: Optional[str] = None,
                 capacity: int = 4, host: str = "127.0.0.1", runtime=None,
                 report_interval_s: float = 0.3, device=None):
        super().__init__(cfg, rank=rank, size=0, backend=backend)
        self.sched = ModelDeployScheduler(
            f"{workdir}/worker{rank}.sqlite", reconcile_interval_s=0.5,
            runtime=runtime, device=device,
        )
        self.capacity = capacity
        self.host = host
        self.report_interval_s = report_interval_s
        self._stop = threading.Event()
        self._reporter: Optional[threading.Thread] = None

    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(MSG_TYPE_M2W_DEPLOY, self.handle_deploy)
        self.register_message_receive_handler(MSG_TYPE_M2W_SCALE, self.handle_scale)
        self.register_message_receive_handler(MSG_TYPE_M2W_UNDEPLOY, self.handle_undeploy)
        self.register_message_receive_handler(MSG_TYPE_M2W_FINISH, self.handle_finish)

    def start(self) -> None:
        """Announce capacity (reference edges report on connect)."""
        msg = Message(MSG_TYPE_W2M_WORKER_ONLINE, self.rank, 0)
        msg.add_params(ARG_CAPACITY, self.capacity)
        msg.add_params(ARG_HOST, self.host)
        self.send_message(msg)
        self.sched.run_in_thread()
        self._reporter = threading.Thread(target=self._report_loop, daemon=True)
        self._reporter.start()

    # -- command handlers -----------------------------------------------------
    def handle_deploy(self, msg: Message) -> None:
        name = msg.get(ARG_ENDPOINT)
        card = ModelCard(**json.loads(msg.get(ARG_CARD)))
        replicas = int(msg.get(ARG_REPLICAS))
        try:
            if name in self.sched.endpoints:
                # a redelivered/duplicate DEPLOY must not overwrite the live
                # Endpoint record (the old replica processes would leak) —
                # but a duplicate carrying a DIFFERENT card means the master
                # wants a different model under this name; serving the old
                # one silently would be wrong, so say so loudly
                live = self.sched.endpoints[name].card
                if card != live:
                    log.warning(
                        "worker %d: duplicate DEPLOY for live endpoint %s "
                        "carries a different card (%s:%s vs live %s:%s) — "
                        "keeping the live model; undeploy first to replace",
                        self.rank, name, card.name, card.version,
                        live.name, live.version,
                    )
                self.sched.scale(name, replicas)
            else:
                self.sched.cards.register(card)
                self.sched.deploy(name, card.name, card.version, replicas=replicas)
        except Exception:
            log.exception("worker %d: deploy %s failed", self.rank, name)
        self._report(name)

    def handle_scale(self, msg: Message) -> None:
        name = msg.get(ARG_ENDPOINT)
        n = int(msg.get(ARG_REPLICAS))
        if n <= 0:
            # scaled off this worker entirely: drop the endpoint record,
            # not just its replicas (a zero-replica husk would linger)
            self.sched.undeploy(name)
        elif name in self.sched.endpoints:
            self.sched.scale(name, n)
        else:
            # scaled ONTO a worker that never hosted this endpoint: the
            # SCALE message carries the card so this is a fresh deploy
            card = ModelCard(**json.loads(msg.get(ARG_CARD)))
            try:
                self.sched.cards.register(card)
                self.sched.deploy(name, card.name, card.version, replicas=n)
            except Exception:
                log.exception("worker %d: scale-deploy %s failed", self.rank, name)
        self._report(name)

    def handle_undeploy(self, msg: Message) -> None:
        self.sched.undeploy(msg.get(ARG_ENDPOINT))
        self._report(msg.get(ARG_ENDPOINT))

    def handle_finish(self, msg: Message) -> None:
        self.stop()
        self.finish()

    # -- readiness reporting --------------------------------------------------
    def _report(self, endpoint: str) -> None:
        ep = self.sched.endpoints.get(endpoint)
        ports = ep.ready_ports() if ep is not None else []
        out = Message(MSG_TYPE_W2M_REPLICA_STATUS, self.rank, 0)
        out.add_params(ARG_ENDPOINT, endpoint)
        out.add_params(ARG_PORTS, [int(p) for p in ports])
        out.add_params(ARG_HOST, self.host)
        try:
            self.send_message(out)
        except Exception:
            log.debug("worker %d: status report undeliverable", self.rank)

    def _report_loop(self) -> None:
        """Readiness changes asynchronously (replica boot, crash-restart);
        report every endpoint periodically so the master's routing table
        converges without polling RPCs (reference workers push status)."""
        while not self._stop.wait(self.report_interval_s):
            for name in list(self.sched.endpoints):
                self._report(name)

    def stop(self) -> None:
        self._stop.set()
        self.sched.stop()


class DeployMasterManager(FedMLCommManager):
    """Master: placement + endpoint aggregation + inference routing
    (reference ``master_protocol_manager.py`` + the gateway role)."""

    def __init__(self, cfg, backend: Optional[str] = None):
        super().__init__(cfg, rank=0, size=0, backend=backend)
        self.workers: dict[int, dict] = {}           # rank -> {capacity, host}
        # endpoint -> worker rank -> {"ports": [...], "host": str}
        self.endpoints: dict[str, dict[int, dict]] = {}
        self.placements: dict[str, dict[int, int]] = {}
        # cards by endpoint: scale-up may land on a worker that never saw the
        # original DEPLOY, so SCALE messages re-ship the card
        self.cards: dict[str, ModelCard] = {}
        self._lock = threading.Lock()
        self._place_rr = 0   # placement rotation (under _lock)
        self._predict_rr = 0  # routing rotation (racy by design; benign)

    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(MSG_TYPE_W2M_WORKER_ONLINE, self.handle_worker_online)
        self.register_message_receive_handler(MSG_TYPE_W2M_REPLICA_STATUS, self.handle_replica_status)

    def handle_worker_online(self, msg: Message) -> None:
        with self._lock:
            self.workers[msg.get_sender_id()] = {
                "capacity": int(msg.get(ARG_CAPACITY)),
                "host": msg.get(ARG_HOST),
            }

    def handle_replica_status(self, msg: Message) -> None:
        name = msg.get(ARG_ENDPOINT)
        with self._lock:
            # reports for endpoints the master no longer tracks (undeployed)
            # are dropped — a report snapshotted before the UNDEPLOY landed
            # must not resurrect a stale routing entry with dead ports
            if name not in self.placements:
                return
            self.endpoints.setdefault(name, {})[msg.get_sender_id()] = {
                "ports": list(msg.get(ARG_PORTS)),
                "host": msg.get(ARG_HOST),
            }

    # -- orchestration API ----------------------------------------------------
    def wait_workers(self, n: int, timeout: float = 30.0) -> None:
        deadline = time.time() + timeout
        while time.time() < deadline:
            with self._lock:
                if len(self.workers) >= n:
                    return
            time.sleep(0.05)
        with self._lock:
            online = len(self.workers)
        raise TimeoutError(f"only {online}/{n} workers reported online")

    def _place_locked(self, replicas: int, endpoint: str) -> dict[int, int]:
        """Capacity-weighted round-robin split (reference splits a
        deployment's replicas across selected edges).  Caller holds _lock.
        Free capacity accounts for every OTHER endpoint's current placement;
        the winning placement is COMMITTED to ``self.placements[endpoint]``
        before the lock is released, so concurrent deploys cannot both see
        the same free slot and over-commit the cluster.  Raises WITHOUT
        mutating state when capacity is short."""
        workers = dict(self.workers)
        if not workers:
            raise RuntimeError("no workers online")
        free = {r: int(w["capacity"]) for r, w in workers.items()}
        for name, held in self.placements.items():
            if name == endpoint:
                continue  # an endpoint being re-placed frees its own slots
            for r, n in held.items():
                free[r] = free.get(r, 0) - n
        placement = {r: 0 for r in workers}
        order = sorted(workers)
        i = self._place_rr
        placed = 0
        while placed < replicas and any(f > 0 for f in free.values()):
            r = order[i % len(order)]
            i += 1
            if free[r] > 0:
                placement[r] += 1
                free[r] -= 1
                placed += 1
        if placed < replicas:
            # raise BEFORE committing the cursor or the placement: a failed
            # attempt must leave no state (a retry sees identical conditions)
            raise RuntimeError(
                f"cluster capacity exhausted: placed {placed}/{replicas} replicas"
            )
        self._place_rr = i
        placement = {r: n for r, n in placement.items() if n > 0}
        self.placements[endpoint] = placement
        return placement

    def deploy(self, endpoint: str, card: ModelCard, replicas: int = 1) -> dict[int, int]:
        # ONE critical section for guard + placement + card commit: racing
        # duplicate deploys must not both pass the guard, and a failed
        # placement must leave NO state behind (messages go out after the
        # lock — workers' replies re-enter handlers that take _lock)
        with self._lock:
            if endpoint in self.placements:
                # re-deploying over a live name would orphan replicas on
                # workers the new placement omits (they'd keep serving the
                # OLD card through the routing table)
                raise ValueError(
                    f"endpoint {endpoint!r} is already deployed; scale() it "
                    "or undeploy() first"
                )
            placement = self._place_locked(replicas, endpoint)
            self.cards[endpoint] = card
        for rank, n in placement.items():
            msg = Message(MSG_TYPE_M2W_DEPLOY, 0, rank)
            msg.add_params(ARG_ENDPOINT, endpoint)
            msg.add_params(ARG_CARD, json.dumps(card.__dict__))
            msg.add_params(ARG_REPLICAS, n)
            self.send_message(msg)
        return placement

    def scale(self, endpoint: str, replicas: int) -> dict[int, int]:
        with self._lock:
            card = self.cards.get(endpoint)
            if card is None:
                # also covers scale-after-undeploy racing: once undeploy
                # popped the card, a late scale must refuse instead of
                # resurrecting a placement with no card behind it
                raise KeyError(f"endpoint {endpoint!r} was never deployed")
            old = dict(self.placements.get(endpoint, {}))
            placement = self._place_locked(replicas, endpoint)
        for rank in set(old) | set(placement):
            n = placement.get(rank, 0)
            msg = Message(MSG_TYPE_M2W_SCALE, 0, rank)
            msg.add_params(ARG_ENDPOINT, endpoint)
            msg.add_params(ARG_REPLICAS, n)
            # the card rides along: a scale-up may land on a worker that
            # never saw the original DEPLOY
            msg.add_params(ARG_CARD, json.dumps(card.__dict__))
            self.send_message(msg)
        return placement

    def undeploy(self, endpoint: str) -> None:
        # broadcast to EVERY known worker, not just the current placement:
        # re-placements (scale) may have left endpoint records on workers no
        # longer in the table, and a worker without the endpoint no-ops
        with self._lock:
            self.placements.pop(endpoint, None)
            self.cards.pop(endpoint, None)
            ranks = list(self.workers)
            self.endpoints.pop(endpoint, None)
        for rank in ranks:
            msg = Message(MSG_TYPE_M2W_UNDEPLOY, 0, rank)
            msg.add_params(ARG_ENDPOINT, endpoint)
            self.send_message(msg)

    def shutdown_workers(self) -> None:
        with self._lock:
            ranks = list(self.workers)
        for rank in ranks:
            self.send_message(Message(MSG_TYPE_M2W_FINISH, 0, rank))

    # -- routing (the gateway role over worker-hosted replicas) ---------------
    def ready_targets(self, endpoint: str) -> list[tuple[str, int]]:
        with self._lock:
            reports = dict(self.endpoints.get(endpoint, {}))
        return [(rep["host"], p) for _rank, rep in sorted(reports.items())
                for p in rep["ports"]]

    def wait_ready(self, endpoint: str, replicas: int, timeout: float = 60.0) -> bool:
        deadline = time.time() + timeout
        while time.time() < deadline:
            if len(self.ready_targets(endpoint)) >= replicas:
                return True
            time.sleep(0.1)
        return False

    def predict(self, endpoint: str, request: dict, timeout: float = 30.0) -> dict:
        targets = self.ready_targets(endpoint)
        if not targets:
            raise RuntimeError(f"endpoint {endpoint!r} has no ready replicas")
        body = json.dumps(request).encode()
        self._predict_rr += 1
        last_err: Optional[Exception] = None
        for i in range(len(targets)):
            host, port = targets[(self._predict_rr + i) % len(targets)]
            req = urllib.request.Request(
                f"http://{host}:{port}/predict", data=body,
                headers={"Content-Type": "application/json"},
            )
            try:
                with urllib.request.urlopen(req, timeout=timeout) as r:
                    return json.loads(r.read())
            except Exception as e:  # failover across workers AND replicas
                last_err = e
        raise RuntimeError(f"all replicas of {endpoint!r} failed: {last_err}")
