"""Soak harnesses of the buffered-async server (the port of
``fedml_tpu/cross_silo/async_soak.py``).

- :func:`run_soak`: thousands of simulated clients against one real
  :class:`~.async_server.AsyncFedMLServerManager` (real aggregator, fold,
  dispatch ledger, watchdog and wire bytes over the in-process fabric).
  The clients are events on a latency heap (lognormal: a long straggler
  tail), not threads.  Injected upload drops give the watchdog work, and
  every one is accounted (``unaccounted_drops`` 0: re-issued by the
  watchdog, or its slot still in flight).
- :func:`run_kill_recover_soak`: the same under seeded chaos on both legs
  with the server journal on; the server is hard-killed mid-run and rebuilt
  over its journal, and the accounting identity covers both lifetimes.
- :func:`run_client_kill_soak`: real in-process clients under the async
  server, killed mid-run and rebuilt over their client journals.
- :func:`run_multiproc_kill_soak`: real OS processes over TCP
  (``cross_silo/soak_worker.py``), real SIGKILLs of the server and of
  silos, each restarted over its journal.

- :func:`run_edge_kill_soak`: the synchronous aggregation tree with a
  sequenced simulated fleet; an edge is hard-killed mid-round and rebuilt
  over its journal, bitwise the clean leg.

The reference's client crash-parity harness (``run_client_crash_parity``)
is the port's ``cross_silo/crash_drill.py``.  The reference reads its
fold-lag and staleness quantiles off its metrics registry (not ported);
here they come from the server's plain bucket counts, by the same rule (the
upper edge of the bucket where the cumulative count reaches the quantile).
There is no flight recorder.

Every harness runs on the card unless its caller passes ``device="cpu"``;
the multi-process soak's workers likewise.
"""

from __future__ import annotations

import contextlib
import heapq
import os
import queue
import threading
import time
from typing import Optional

import numpy as np

from ..core.device import resolve_device

#: the checkout a worker process imports the port from
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _percentile_from_counts(hist, q: float) -> Optional[float]:
    """The upper edge of the bucket of ``hist`` (an ``async_server.BucketCounts``)
    where the cumulative count reaches ``q`` of the total; None when empty."""
    total = sum(hist.counts)
    if total <= 0:
        return None
    target, cum = q * total, 0
    for bound, n in zip(hist.edges, hist.counts):
        cum += n
        if cum >= target:
            return float(bound)
    return float(hist.edges[-1])


class _FleetSender:
    """A comm-manager-shaped adapter over the in-process router, so the
    simulated fleet's uploads can go through the chaos wrapper as a real
    client's do; ``route`` gets the message alone (the router taps' form),
    ``send_raw`` is the wrapper's corrupt-frame point."""

    def __init__(self, router):
        self.router = router

    def send_message(self, msg) -> None:
        self.router.route(msg)

    def send_raw(self, receiver_id: int, payload: bytes) -> None:
        self.router.queues[receiver_id].put(payload)


def _upload_chaos_sender(router, chaos_flags: Optional[dict], seed: int):
    """``(sender, chaos wrapper or None)`` of the fleet's upload leg: the
    seeded wrapper (rank 1 of its own, so its schedule is apart from the
    server's) when a fault is set, else the bare adapter."""
    sender = _FleetSender(router)
    if not chaos_flags:
        return sender, None
    from ..comm.chaos import ChaosCommManager, ChaosConfig

    cfg = ChaosConfig(
        seed=int(chaos_flags.get("chaos_seed", seed)) + 1,
        drop=float(chaos_flags.get("chaos_drop_prob", 0.0)),
        delay=float(chaos_flags.get("chaos_delay_prob", 0.0)),
        delay_max_s=float(chaos_flags.get("chaos_delay_max_s", 0.05)),
        duplicate=float(chaos_flags.get("chaos_duplicate_prob", 0.0)),
        reorder=float(chaos_flags.get("chaos_reorder_prob", 0.0)),
        corrupt=float(chaos_flags.get("chaos_corrupt_prob", 0.0)),
    )
    if not cfg.active():
        return sender, None
    wrapper = ChaosCommManager(sender, cfg, rank=1)
    return wrapper, wrapper


class _TaggedQueue:
    """Queue-shaped proxy: a ``put`` lands in the shared fan-in queue tagged
    with the simulated client's rank."""

    __slots__ = ("rid", "shared")

    def __init__(self, rid: int, shared: "queue.Queue"):
        self.rid = rid
        self.shared = shared

    def put(self, item) -> None:
        self.shared.put((self.rid, item))


class _FanInQueues(dict):
    """The router's queues: rank 0 keeps the server's inbox, every other
    rank fans into one shared queue the fleet's workers drain."""

    def __init__(self, shared: "queue.Queue", server_inbox: "queue.Queue"):
        super().__init__()
        self[0] = server_inbox
        self._shared = shared

    def __missing__(self, rid: int):
        proxy = _TaggedQueue(rid, self._shared)
        self[rid] = proxy
        return proxy


class _SimulatedFleet:
    """An event-scheduled client population.  Worker threads drain the
    fan-in queue: status probes are answered at once; a dispatch is either
    dropped (a seeded coin per event: the injected failure) or scheduled on
    the latency heap, which one scheduler thread pops and answers through
    the router (the real wire bytes)."""

    def __init__(self, router, md, template_params, *, drop_prob: float,
                 latency_mean_s: float, latency_sigma: float, seed: int,
                 workers: int = 4, sender=None, upload_keys: bool = False):
        self.router = router
        # model replies go through ``sender`` (the chaos wrapper when the
        # upload leg has chaos); status replies stay on the bare router
        self.sender = sender if sender is not None else _FleetSender(router)
        #: stamp idempotence keys (the per-dispatch ordinal as the attempt),
        #: so a duplicated frame carries its original's key
        self.upload_keys = bool(upload_keys)
        self.md = md
        self.template = template_params
        self.drop_prob = float(drop_prob)
        # lognormal(mu, sigma) of mean latency_mean_s
        self.mu = float(np.log(max(latency_mean_s, 1e-6)) - 0.5 * latency_sigma ** 2)
        self.sigma = float(latency_sigma)
        self.seed = int(seed)
        self.drops_injected = 0
        self.replies_sent = 0
        self._nonce = 0
        self._lock = threading.Lock()
        self._heap: list = []
        self._cond = threading.Condition(self._lock)
        self._stop = False
        self._threads: list[threading.Thread] = []
        self._workers = workers

    def start(self, shared: "queue.Queue") -> None:
        for i in range(self._workers):
            t = threading.Thread(target=self._worker, args=(shared,), name=f"soak-client-{i}",
                                 daemon=True)
            t.start()
            self._threads.append(t)
        t = threading.Thread(target=self._scheduler, name="soak-sched", daemon=True)
        t.start()
        self._threads.append(t)

    def stop(self, shared: "queue.Queue") -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        for _ in range(self._workers):
            shared.put(None)
        for t in self._threads:
            t.join(timeout=10.0)

    def _worker(self, shared: "queue.Queue") -> None:
        from ..comm.message import Message

        md = self.md
        while True:
            item = shared.get()
            if item is None:
                return
            rid, data = item
            try:
                msg = Message.decode(data)  # the tensors stay undecoded
            except Exception:
                continue
            mtype = msg.get_type()
            if mtype == md.MSG_TYPE_S2C_CHECK_CLIENT_STATUS:
                reply = Message(md.MSG_TYPE_C2S_CLIENT_STATUS, rid, 0)
                reply.add_params(md.MSG_ARG_KEY_CLIENT_STATUS, md.CLIENT_STATUS_ONLINE)
                reply.add_params(md.MSG_ARG_KEY_CLIENT_OS, md.CLIENT_OS_PYTHON)
                self.router.route(reply)
            elif mtype in (md.MSG_TYPE_S2C_INIT_CONFIG, md.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT):
                version = int(msg.get_control(md.MSG_ARG_KEY_ROUND_INDEX, 0))
                epoch = msg.get_control(md.MSG_ARG_KEY_SESSION_EPOCH)
                with self._lock:
                    self._nonce += 1
                    nonce = self._nonce
                rng = np.random.default_rng([self.seed, rid, nonce])
                if rng.random() < self.drop_prob:
                    with self._lock:
                        self.drops_injected += 1
                    continue  # the upload is lost; the watchdog must recover it
                latency = float(rng.lognormal(self.mu, self.sigma))
                with self._cond:
                    heapq.heappush(self._heap, (time.monotonic() + latency, nonce, rid, version,
                                                epoch))
                    self._cond.notify()
            # FINISH needs no answer here

    def _scheduler(self) -> None:
        while True:
            with self._cond:
                while not self._stop and (not self._heap
                                          or self._heap[0][0] > time.monotonic()):
                    wait = (self._heap[0][0] - time.monotonic()) if self._heap else 0.2
                    self._cond.wait(timeout=max(0.001, min(wait, 0.2)))
                if self._stop:
                    return
                _due, nonce, rid, version, epoch = heapq.heappop(self._heap)
            self._send_reply(rid, version, nonce, epoch)

    def _send_reply(self, rid: int, version: int, nonce: int, epoch=None) -> None:
        from ..comm.message import Message
        from ..core import pytree as pt

        md = self.md
        # a cheap, deterministic "trained" model: the template scaled per
        # (client, nonce), non-degenerate folds without any training
        f = 1.0 + 1e-3 * ((rid * 31 + nonce) % 97) / 97.0
        params = pt.tree_map(lambda a: (a * f).astype(a.dtype) if a.dtype.kind == "f" else a,
                             self.template)
        reply = Message(md.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER, rid, 0)
        reply.add_params(md.MSG_ARG_KEY_MODEL_PARAMS, params)
        reply.add_params(md.MSG_ARG_KEY_NUM_SAMPLES, float(16 + (rid % 7) * 8))
        reply.add_params(md.MSG_ARG_KEY_ROUND_INDEX, version)
        if epoch is not None:
            reply.add_params(md.MSG_ARG_KEY_SESSION_EPOCH, int(epoch))
        if self.upload_keys:
            reply.add_params(md.MSG_ARG_KEY_UPLOAD_KEY,
                             f"{rid}:{version}:{-1 if epoch is None else int(epoch)}:{nonce}")
        try:
            self.sender.send_message(reply)
        except Exception:
            return
        with self._lock:
            self.replies_sent += 1


def attach_sim_fleet(server, *, drop_prob: float = 0.0, latency_mean_s: float = 0.003,
                     latency_sigma: float = 1.0, seed: int = 0, workers: int = 4):
    """Swap a built in-process server's fabric for the fan-in simulated
    fleet and start it; returns ``(fleet, shared_queue)``, torn down by
    ``fleet.stop(shared_queue)``.  (The reference's upload-chaos and key
    options serve its multi-tenant control plane, not ported.)"""
    from ..comm.inproc import InProcRouter
    from . import message_define as md

    router = InProcRouter.get(str(getattr(server.cfg, "run_id", "0")))
    shared: "queue.Queue" = queue.Queue()
    # after the server bound its rank-0 inbox
    router.queues = _FanInQueues(shared, router.queues[0])
    fleet = _SimulatedFleet(router, md, server.aggregator.host_global_flax(),
                            drop_prob=drop_prob, latency_mean_s=latency_mean_s,
                            latency_sigma=latency_sigma, seed=seed, workers=workers)
    fleet.start(shared)
    return fleet, shared


def _soak_config(run_id: str, n_clients: int, concurrency: int, buffer_k: int, versions: int,
                 staleness_exponent: float, redispatch_timeout_s: float,
                 extra_flags: Optional[dict] = None):
    from ..arguments import Config

    return Config(
        training_type="cross_silo", dataset="synthetic", model="lr",
        client_num_in_total=n_clients, client_num_per_round=concurrency,
        comm_round=versions, epochs=1, batch_size=16, learning_rate=0.1,
        partition_method="homo", synthetic_train_size=512, synthetic_test_size=64,
        frequency_of_the_test=0, compute_dtype="float32", metrics_jsonl_path="",
        run_id=run_id,
        extra={"async_aggregation": True, "async_buffer_k": buffer_k,
               "async_staleness_exponent": staleness_exponent,
               "async_concurrency": concurrency,
               "async_redispatch_timeout_s": redispatch_timeout_s, **(extra_flags or {})},
    )


def _server_data(cfg):
    """The server's dataset and model: loaded with 8 clients, so the
    partitioner never splits a small synthetic set thousands of ways (the
    server only evaluates)."""
    import dataclasses

    from ..data import loader
    from ..models import model_hub

    ds_cfg = dataclasses.replace(cfg, client_num_in_total=8, client_num_per_round=8)
    ds = loader.load(ds_cfg)
    return ds, model_hub.create(ds_cfg, ds.class_num, input_shape=ds.train_x.shape[1:])


def run_soak(n_clients: int = 10000, concurrency: int = 1024, buffer_k: int = 64,
             versions: int = 20, staleness_exponent: float = 0.5, drop_prob: float = 0.02,
             latency_mean_s: float = 0.005, latency_sigma: float = 1.0,
             redispatch_timeout_s: float = 2.0, seed: int = 0, workers: int = 4,
             timeout_s: float = 600.0, device=None) -> dict:
    """Drive one async server to ``versions`` virtual rounds under
    ``n_clients`` simulated clients; returns the accounting (versions/s,
    staleness, fold-lag p50 / p95, peak buffered, drops and re-issues).
    (The reference's journal and extra-flag options serve its bench, not
    ported.)"""
    import fedml_tpu_torch

    from ..comm.inproc import InProcRouter
    from . import build_server

    device = resolve_device(device)
    run_id = f"soak_async_{seed}_{n_clients}_{versions}"
    cfg = _soak_config(run_id, n_clients, concurrency, buffer_k, versions, staleness_exponent,
                       redispatch_timeout_s)
    fedml_tpu_torch.init(cfg)
    ds, model = _server_data(cfg)
    InProcRouter.reset(run_id)
    server = build_server(cfg, ds, model, device, backend="INPROC")
    fleet, shared = attach_sim_fleet(server, drop_prob=drop_prob, latency_mean_s=latency_mean_s,
                                     latency_sigma=latency_sigma, seed=seed, workers=workers)
    t0 = time.monotonic()
    server.run_in_thread()
    server.start()
    completed = server.done.wait(timeout_s)
    wall_total = time.monotonic() - t0
    summary = server.async_summary()
    peak = int(server.aggregator.peak_buffered_updates)
    server.finish()
    fleet.stop(shared)
    InProcRouter.reset(run_id)
    if not completed:
        raise RuntimeError(f"async soak did not reach {versions} versions in {timeout_s}s: "
                           f"{summary}, drops_injected={fleet.drops_injected}, "
                           f"replies_sent={fleet.replies_sent}")
    drops = fleet.drops_injected
    # every injected drop is either re-issued by the watchdog or its slot is
    # still tracked in flight: anything else lost work without a trail
    unaccounted = max(0, drops - summary["timeout_redispatches"] - summary["outstanding_at_end"])
    return {
        "clients": n_clients,
        "concurrency": summary["concurrency"],
        "buffer_k": summary["buffer_k"],
        "versions": summary["server_version"],
        "arrivals": summary["arrivals"],
        "wall_s": summary["wall_s"],
        "wall_total_s": round(wall_total, 4),
        "versions_per_sec": summary["versions_per_sec"],
        "arrivals_per_sec": (round(summary["arrivals"] / summary["wall_s"], 2)
                             if summary["wall_s"] else None),
        "staleness_mean": summary["staleness_mean"],
        "staleness_max": summary["staleness_max"],
        "staleness_hist_counts": list(server.staleness_hist.counts),
        "fold_lag_p50_s": _percentile_from_counts(server.fold_lag_hist, 0.50),
        "fold_lag_p95_s": _percentile_from_counts(server.fold_lag_hist, 0.95),
        "peak_buffered_updates": peak,
        "drops_injected": drops,
        "replies_sent": fleet.replies_sent,
        "timeout_redispatches": summary["timeout_redispatches"],
        "outstanding_at_end": summary["outstanding_at_end"],
        "throttled_at_end": summary["throttled_at_end"],
        "unaccounted_drops": unaccounted,
    }


#: the kill-and-recover soak's default seeded chaos: every fault class on
#: the dispatch leg, mild enough that the watchdog keeps the run moving
DEFAULT_CHAOS_FLAGS = {
    "chaos_drop_prob": 0.02,
    "chaos_corrupt_prob": 0.01,
    "chaos_duplicate_prob": 0.01,
    "chaos_reorder_prob": 0.02,
    "chaos_delay_prob": 0.05,
    "chaos_delay_max_s": 0.002,
}


def _silent_losses(mgr) -> int:
    from ..comm.chaos import ChaosCommManager

    return mgr.silent_losses() if isinstance(mgr, ChaosCommManager) else 0


def run_kill_recover_soak(n_clients: int = 256, concurrency: int = 64, buffer_k: int = 16,
                          versions: int = 8, kill_at_version: Optional[int] = None,
                          staleness_exponent: float = 0.5, drop_prob: float = 0.02,
                          latency_mean_s: float = 0.003, latency_sigma: float = 1.0,
                          redispatch_timeout_s: float = 1.0, seed: int = 0, workers: int = 4,
                          chaos: Optional[dict] = None, client_chaos: Optional[dict] = None,
                          timeout_s: float = 300.0, device=None) -> dict:
    """Run the async server under seeded chaos with its journal on,
    hard-kill it at ``kill_at_version`` (nothing past the last snapshot
    survives), rebuild it over the same journal and drive the same
    simulated fleet to the end.  The accounting: the rebuilt server resumes
    at the journaled version (``monotone``), completes, and every silent
    loss (fleet drops, chaos drop / corrupt on both legs) is a watchdog
    re-issue, a stale-epoch rejection, a tracked slot, or a slot in flight
    at the kill but newer than the last snapshot (``unaccounted`` 0).
    Duplicated uploads carry their original's key and come back as dedups
    (``client_chaos`` defaults to the dispatch leg's faults; ``{}`` turns
    upload chaos off)."""
    import shutil
    import tempfile

    import fedml_tpu_torch

    from ..comm.inproc import InProcRouter
    from . import build_server
    from . import message_define as md

    device = resolve_device(device)
    journal_dir = tempfile.mkdtemp(prefix="soak_journal_")
    chaos_flags = dict(DEFAULT_CHAOS_FLAGS if chaos is None else chaos)
    chaos_flags.setdefault("chaos_seed", seed)
    kill_at = kill_at_version if kill_at_version is not None else max(1, versions // 2)
    run_id = f"soak_killrec_{seed}_{n_clients}_{versions}"
    cfg = _soak_config(run_id, n_clients, concurrency, buffer_k, versions, staleness_exponent,
                       redispatch_timeout_s,
                       extra_flags={"server_journal_dir": journal_dir, **chaos_flags})
    fedml_tpu_torch.init(cfg)
    ds, model = _server_data(cfg)
    try:
        InProcRouter.reset(run_id)
        server_a = build_server(cfg, ds, model, device, backend="INPROC")
        router = InProcRouter.get(run_id)
        shared: queue.Queue = queue.Queue()
        router.queues = _FanInQueues(shared, router.queues[0])
        template = server_a.aggregator.host_global_flax()
        upload_flags = dict(chaos_flags if client_chaos is None else client_chaos)
        sender, upload_chaos = _upload_chaos_sender(router, upload_flags, seed)
        fleet = _SimulatedFleet(router, md, template, drop_prob=drop_prob,
                                latency_mean_s=latency_mean_s, latency_sigma=latency_sigma,
                                seed=seed, workers=workers, sender=sender, upload_keys=True)
        fleet.start(shared)
        t0 = time.monotonic()
        server_a.run_in_thread()
        server_a.start()
        # a bare version read: the kill needs no consistent snapshot, the
        # journal is one
        deadline = time.monotonic() + timeout_s
        while server_a.server_version < kill_at:
            if time.monotonic() > deadline:
                raise RuntimeError(f"kill-recover soak never reached version {kill_at}: "
                                   f"{server_a.async_summary()}")
            if server_a.done.is_set():
                break
            time.sleep(0.005)
        a_summary = server_a.async_summary()
        a_chaos = _silent_losses(server_a.com_manager)
        t_kill = time.monotonic()
        server_a.hard_kill()
        server_b = build_server(cfg, ds, model, device, backend="INPROC")
        recovered_version = server_b.server_version
        recovered_inflight = len(server_b._prev_epoch_inflight)
        recovered_redisp = server_b.timeout_redispatches
        t_restart = time.monotonic()
        server_b.run_in_thread()
        server_b.start()
        completed = server_b.done.wait(timeout_s)
        t_done = time.monotonic()
        b_summary = server_b.async_summary()
        b_chaos = _silent_losses(server_b.com_manager)
        peak = max(int(server_a.aggregator.peak_buffered_updates),
                   int(server_b.aggregator.peak_buffered_updates))
        server_b.finish()
        fleet.stop(shared)
        InProcRouter.reset(run_id)
        if not completed:
            raise RuntimeError(f"recovered server did not reach {versions} versions in "
                               f"{timeout_s}s: {b_summary}, recovered_at={recovered_version}, "
                               f"kill_summary={a_summary}")
        # the silent losses of both legs and both lifetimes against what
        # accounts for them: re-issues in either lifetime (B's own beyond
        # the journaled carry-over), stale rejections, tracked slots, and
        # slots in flight at the kill that the last snapshot did not hold
        upload_losses = upload_chaos.silent_losses() if upload_chaos else 0
        upload_dups = upload_chaos.injected.get("duplicate", 0) if upload_chaos else 0
        losses = fleet.drops_injected + a_chaos + b_chaos + upload_losses
        total_redisp = (a_summary["timeout_redispatches"]
                        + b_summary["timeout_redispatches"] - recovered_redisp)
        lost_at_kill = max(0, a_summary["outstanding_at_end"] - recovered_inflight)
        accounted = (total_redisp + b_summary["rejected_stale"] + b_summary["outstanding_at_end"]
                     + b_summary["prev_epoch_inflight_at_end"] + lost_at_kill)
        unaccounted = max(0, losses - accounted)
        wall = (t_kill - t0) + (t_done - t_restart)
        return {
            "clients": n_clients,
            "concurrency": concurrency,
            "buffer_k": buffer_k,
            "versions": b_summary["server_version"],
            "versions_at_kill": a_summary["server_version"],
            "recovered_version": recovered_version,
            "recovered_inflight": recovered_inflight,
            "session_epoch": b_summary["session_epoch"],
            "monotone": (0 < recovered_version <= a_summary["server_version"]
                         <= b_summary["server_version"]),
            "arrivals": b_summary["arrivals"],
            "wall_s": round(wall, 4),
            "versions_per_sec": round(b_summary["server_version"] / max(wall, 1e-9), 4),
            "fleet_drops_injected": fleet.drops_injected,
            "chaos_silent_losses": a_chaos + b_chaos,
            "upload_chaos_losses": upload_losses,
            "upload_duplicates_injected": upload_dups,
            "deduped": b_summary["deduped"],
            "timeout_redispatches": total_redisp,
            "rejected_stale": b_summary["rejected_stale"],
            "outstanding_at_end": b_summary["outstanding_at_end"],
            "prev_epoch_inflight_at_end": b_summary["prev_epoch_inflight_at_end"],
            "lost_inflight_at_kill": lost_at_kill,
            "unaccounted": unaccounted,
            "peak_buffered_updates": peak,
        }
    finally:
        shutil.rmtree(journal_dir, ignore_errors=True)


def run_edge_kill_soak(n_clients: int = 4, fanout: int = 2, rounds: int = 2,
                       kill: Optional[tuple] = (0, 0, 1), seed: int = 0,
                       hop_codec: Optional[str] = None, codec: Optional[str] = None,
                       topology: Optional[dict] = None, timeout_s: float = 120.0,
                       device=None, global_vars=None, model: str = "lr",
                       cfg_overrides: Optional[dict] = None) -> dict:
    """Edge kill soak over the synchronous aggregation tree: the real root
    and :class:`~.edge.EdgeAggregatorManager` nodes on the in-process
    fabric, the clients simulated by this harness so every arrival is
    sequenced: uploads go in sorted order, one edge's subtree at a time,
    each waited for before the next.  The clean and kill legs so run the
    same fold op sequence and their final globals match bitwise (raw hop;
    ``hop_codec`` trades that pin for the bytes).

    ``kill = (round, edge_ordinal, after_children)`` hard-kills that edge
    once ``after_children`` of its children folded (each fold journaled
    under ``<journal>/edge_<rank>``), rebuilds it over the same journal and
    router queue (uploads sent while it was dead stay queued), re-sends the
    folded uploads under their keys and drives the run out; every upload
    sent is a fold, a dedup or a relay at one edge over both lifetimes
    (``unaccounted`` 0).  ``kill=None`` is the clean leg; ``fanout=0`` with
    no ``topology`` (an ``extra.hier_topology`` dict) runs the flat
    protocol under the same sequencing.  ``codec`` compresses the simulated
    uploads (keyed ``fold_in(root_key(seed), rank * 1009 + round)``, the
    reference's fold with the port's draws), on ``device``.

    Beyond the reference: ``device`` (the card unless ``"cpu"``),
    ``global_vars`` (the initial global, the port's tree), ``model`` and
    ``cfg_overrides`` (fields of the configuration, e.g. a dataset).  (The
    reference's ``extra_flags`` serve its observability flags, not
    ported.)"""
    import dataclasses
    import shutil
    import tempfile

    import fedml_tpu_torch

    from .. import weights
    from ..arguments import Config
    from ..comm import codecs as codecs_mod
    from ..comm.inproc import InProcRouter
    from ..comm.message import Message
    from ..core import pytree as pt
    from ..core import rng
    from ..data import loader
    from ..models import model_hub
    from . import build_server
    from . import message_define as md
    from .edge import EdgeAggregatorManager, build_topology

    device = resolve_device(device)
    workdir = tempfile.mkdtemp(prefix="soak_edgekill_")
    shape = "flat" if (fanout <= 0 and not topology) else ("topo" if topology else f"f{fanout}")
    run_id = (f"soak_edgekill_{seed}_{n_clients}_{rounds}_{shape}_"
              f"{'clean' if kill is None else 'kill'}")
    hier_extra = ({"hier_topology": topology} if topology
                  else {"hier_fanout": fanout} if fanout > 0 else {})
    cfg = Config(
        training_type="cross_silo", dataset="synthetic", model=model,
        client_num_in_total=n_clients, client_num_per_round=n_clients, comm_round=rounds,
        epochs=1, batch_size=16, learning_rate=0.1, partition_method="homo",
        synthetic_train_size=64 * n_clients, synthetic_test_size=64, frequency_of_the_test=0,
        compute_dtype="float32", metrics_jsonl_path="", run_id=run_id, random_seed=seed,
        extra={"streaming_aggregation": True, "server_journal_dir": f"{workdir}/journal",
               **hier_extra, **({"hier_hop_codec": hop_codec} if hop_codec else {})})
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    fedml_tpu_torch.init(cfg)
    ds = loader.load(cfg)
    net = model_hub.create(cfg, ds.class_num, input_shape=ds.train_x.shape[1:])
    topo = build_topology(cfg)
    try:
        InProcRouter.reset(run_id)
        router = InProcRouter.get(run_id)
        agg_ranks = [] if topo is None else topo.aggregator_ranks
        edges = {r: EdgeAggregatorManager(cfg, topo, rank=r, device=device, backend="INPROC")
                 for r in agg_ranks}
        for e in edges.values():
            e.run_in_thread()
        server = build_server(cfg, ds, net, device, backend="INPROC", global_vars=global_vars)
        template = server.aggregator.host_global_flax()
        # client ranks fan into the harness's queue; the root's and the
        # edges' inboxes stay real
        shared: queue.Queue = queue.Queue()
        fan = _FanInQueues(shared, router.queues[0])
        for r in agg_ranks:
            fan[r] = router.queues[r]
        router.queues = fan
        dispatches: dict[tuple, object] = {}
        cond = threading.Condition()
        stop = threading.Event()

        def worker():
            while not stop.is_set():
                try:
                    item = shared.get(timeout=0.05)
                except queue.Empty:
                    continue
                if item is None:
                    return
                rid, data = item
                try:
                    msg = Message.decode(data)
                except Exception:
                    continue
                mtype = msg.get_type()
                if mtype == md.MSG_TYPE_S2C_CHECK_CLIENT_STATUS:
                    reply = Message(md.MSG_TYPE_C2S_CLIENT_STATUS, rid, 0)
                    reply.add_params(md.MSG_ARG_KEY_CLIENT_STATUS, md.CLIENT_STATUS_ONLINE)
                    reply.add_params(md.MSG_ARG_KEY_CLIENT_OS, md.CLIENT_OS_PYTHON)
                    router.route(reply)
                elif mtype in (md.MSG_TYPE_S2C_INIT_CONFIG, md.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT):
                    r = int(msg.get_control(md.MSG_ARG_KEY_ROUND_INDEX, -1))
                    with cond:
                        dispatches[(rid, r)] = msg.get_control(md.MSG_ARG_KEY_SESSION_EPOCH)
                        cond.notify_all()

        wt = threading.Thread(target=worker, name="edge-soak-clients", daemon=True)
        wt.start()
        deadline = time.monotonic() + timeout_s

        def wait_for(pred, what: str):
            while not pred():
                if time.monotonic() > deadline:
                    raise RuntimeError(f"edge kill soak stalled waiting for {what} "
                                       f"(run_id={run_id})")
                time.sleep(0.002)

        def upload_for(rid: int, round_idx: int, epoch) -> Message:
            f = 1.0 + 1e-3 * ((rid * 31 + round_idx * 7) % 97) / 97.0
            params = pt.tree_map(lambda a: (a * f).astype(a.dtype)
                                 if np.asarray(a).dtype.kind == "f" else a, template)
            if codec is not None:
                on_dev = weights.to_torch(params, device)
                params, _, _ = codecs_mod.compress_pytree(
                    on_dev, codec, key=rng.fold_in(rng.root_key(seed), rid * 1009 + round_idx),
                    min_elems=codecs_mod.LOW_RANK_MIN_COMPRESS_ELEMS)
            up = Message(md.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER, rid,
                         0 if topo is None else topo.parent(rid))
            up.add_params(md.MSG_ARG_KEY_MODEL_PARAMS, params)
            up.add_params(md.MSG_ARG_KEY_NUM_SAMPLES, float(16 + (rid % 7) * 8))
            up.add_params(md.MSG_ARG_KEY_ROUND_INDEX, round_idx)
            if epoch is not None:
                up.add_params(md.MSG_ARG_KEY_SESSION_EPOCH, int(epoch))
            # a stable key per (client, round): a re-send after the kill
            # must reconcile as a dedup
            up.add_params(md.MSG_ARG_KEY_UPLOAD_KEY, f"{rid}:{round_idx}:h:0")
            return up

        uploads_sent = edge_kills = 0
        t0 = time.monotonic()
        server.run_in_thread()
        server.start()
        if topo is None:
            if kill is not None:
                raise ValueError("kill injection needs a tree (fanout >= 1)")
            groups = [(None, list(range(1, n_clients + 1)))]
        else:
            groups = [(r, sorted(topo.children_of[r])) for r in topo.edge_ranks]
        for round_idx in range(rounds):
            for ordinal, (erank, children) in enumerate(groups):
                kill_here = (erank is not None and kill is not None and kill[0] == round_idx
                             and kill[1] == ordinal)
                sent_this_edge: list = []
                for k, rid in enumerate(children):
                    if kill_here and k == kill[2]:
                        edges[erank].hard_kill()
                        edge_kills += 1
                        time.sleep(0.15)  # the dead loop's poll runs out
                        replacement = EdgeAggregatorManager(cfg, topo, rank=erank,
                                                            device=device, backend="INPROC")
                        edges[erank] = replacement
                        replacement.run_in_thread()
                        replacement.recovery_resume()
                        for prev in sent_this_edge:  # the journaled dedup swallows them
                            router.route(prev)
                            uploads_sent += 1
                        base_d = replacement.deduped_uploads
                        wait_for(lambda: edges[erank].deduped_uploads
                                 >= base_d + len(sent_this_edge),
                                 f"dedup of re-sent uploads at edge {erank}")
                    with cond:
                        while (rid, round_idx) not in dispatches:
                            if not cond.wait(timeout=0.1) and time.monotonic() > deadline:
                                raise RuntimeError(f"no dispatch for client {rid} round "
                                                   f"{round_idx} (run_id={run_id})")
                        epoch = dispatches[(rid, round_idx)]
                    up = upload_for(rid, round_idx, epoch)
                    # the baseline before the route: the fold may land first
                    base_f = 0 if erank is None else edges[erank].folds + edges[erank].relays
                    router.route(up)
                    uploads_sent += 1
                    sent_this_edge.append(up)
                    if erank is None:
                        wait_for(lambda: rid in server.aggregator.flag_client_model_uploaded
                                 or server.round_idx > round_idx or server.done.is_set(),
                                 f"root fold of client {rid}")
                    else:
                        wait_for(lambda: edges[erank].folds + edges[erank].relays >= base_f + 1,
                                 f"fold of client {rid} at edge {erank}")
                # the root folds the partials in edge order in both legs
                wait_for(lambda: all(c in server.aggregator.flag_client_model_uploaded
                                     for c in children)
                         or server.round_idx > round_idx or server.done.is_set(),
                         f"root accounting of edge {erank} round {round_idx}")
        completed = server.done.wait(max(0.1, deadline - time.monotonic()))
        wall = time.monotonic() - t0
        stop.set()
        shared.put(None)
        wt.join(timeout=5.0)
        folds = sum(e.folds for e in edges.values())
        relays = sum(e.relays for e in edges.values())
        dedups = sum(e.deduped_uploads for e in edges.values())
        out = {
            "clients": n_clients, "fanout": fanout, "rounds": rounds,
            "edges": 0 if topo is None else len(topo.edge_ranks),
            "edge_kills": edge_kills, "uploads_sent": uploads_sent, "edge_folds": folds,
            "edge_relays": relays, "edge_dedups": dedups,
            # every upload sent is a fold, a dedup or a relay at one edge
            "unaccounted": 0 if topo is None else uploads_sent - folds - relays - dedups,
            "partials_sent": sum(e.partials_sent for e in edges.values()),
            "root_ingress_bytes": int(server.upload_ingress_bytes),
            "root_deduped": int(server.deduped_uploads),
            "peak_buffered_root": int(server.aggregator.peak_buffered_updates),
            "peak_buffered_edge": max((e._fold.peak_buffered for e in edges.values()
                                       if e._fold is not None), default=0),
            "wall_s": round(wall, 4),
            "global_leaves": pt.tree_leaves(server.aggregator.host_global_flax()),
        }
        server.finish()
        for e in edges.values():
            e.finish()
        InProcRouter.reset(run_id)
        if not completed:
            raise RuntimeError(f"edge kill soak did not finish {rounds} rounds in {timeout_s}s "
                               f"(folds={folds}, dedups={dedups})")
        return out
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def run_client_kill_soak(n_clients: int = 6, versions: int = 6, buffer_k: int = 3,
                         concurrency: int = 3, kill_marks: tuple = ((2, 1), (4, 2)),
                         codec: Optional[str] = "topk", redispatch_timeout_s: float = 1.0,
                         seed: int = 0, timeout_s: float = 240.0, device=None) -> dict:
    """Real in-process clients under the async server; each ``(rank,
    at_version)`` of ``kill_marks`` hard-kills that client the first time
    the server reaches the version and rebuilds it over its client journal
    (residuals, epoch and attempt counts resume).  Every kill comes back as
    one restart, a journal resume or a cold rejoin (``unaccounted`` = kills
    - resumed - cold == 0); a resent upload shows as a server dedup."""
    import shutil
    import tempfile

    import fedml_tpu_torch

    from ..comm.inproc import InProcRouter
    from ..data import loader
    from ..models import model_hub
    from . import build_client, build_server

    device = resolve_device(device)
    workdir = tempfile.mkdtemp(prefix="soak_clientkill_")
    run_id = f"soak_clientkill_{seed}_{n_clients}_{versions}_{len(kill_marks)}"
    try:
        cfg = _soak_config(
            run_id, n_clients, concurrency, buffer_k, versions, staleness_exponent=0.5,
            redispatch_timeout_s=redispatch_timeout_s,
            extra_flags={"server_journal_dir": f"{workdir}/server_journal",
                         "client_journal_dir": f"{workdir}/client_journal",
                         # the LR's leaves are small: a low floor so the
                         # codec's error feedback crosses the kills
                         **({"comm_compression": codec, "comm_compress_min_size": 64}
                            if codec else {})})
        fedml_tpu_torch.init(cfg)
        ds = loader.load(cfg)
        model = model_hub.create(cfg, ds.class_num, input_shape=ds.train_x.shape[1:])
        InProcRouter.reset(run_id)
        clients = {r: build_client(cfg, ds, model, r, device, backend="INPROC")
                   for r in range(1, n_clients + 1)}
        for c in clients.values():
            c.run_in_thread()
        server = build_server(cfg, ds, model, device, backend="INPROC")
        t0 = time.monotonic()
        server.run_in_thread()
        server.start()
        pending = sorted(kill_marks, key=lambda m: m[1])
        kills = resumed = cold = 0
        deadline = time.monotonic() + timeout_s
        while not server.done.wait(0.002):
            if time.monotonic() > deadline:
                raise RuntimeError(f"client-kill soak did not reach {versions} versions in "
                                   f"{timeout_s}s: {server.async_summary()}")
            while pending and server.server_version >= pending[0][1]:
                rank, _mark = pending.pop(0)
                clients[rank].hard_kill()
                kills += 1
                time.sleep(0.05)  # the dead receive loop drains out
                replacement = build_client(cfg, ds, model, rank, device, backend="INPROC")
                if replacement.resumed_from_journal:
                    resumed += 1
                else:
                    cold += 1
                replacement.run_in_thread()
                clients[rank] = replacement
        wall = time.monotonic() - t0
        summary = server.async_summary()
        peak = int(server.aggregator.peak_buffered_updates)
        server.finish()
        for c in clients.values():
            c.done.wait(5.0)
        finished = sum(1 for c in clients.values() if c.done.is_set())
        for c in clients.values():
            c.finish()
        InProcRouter.reset(run_id)
        return {
            "clients": n_clients,
            "versions": summary["server_version"],
            "wall_s": round(wall, 4),
            "versions_per_sec": round(summary["server_version"] / max(wall, 1e-9), 4),
            "arrivals": summary["arrivals"],
            "kills": kills,
            "resumed_from_journal": resumed,
            "cold_rejoins": cold,
            "unaccounted": kills - resumed - cold,
            "deduped": summary["deduped"],
            "rejected_stale": summary["rejected_stale"],
            "timeout_redispatches": summary["timeout_redispatches"],
            "peak_buffered_updates": peak,
            "clients_finished": finished,
        }
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _free_port_block(n: int, attempts: int = 64) -> int:
    """A base port whose ``n`` ports ``base .. base + n - 1`` all bind now
    (TCP endpoint ``i`` listens on ``base + i``); another process may take
    one before its endpoint binds, so callers pass the block to endpoints
    that retry a held port (``comm/tcp_backend.py``)."""
    import socket

    rng = np.random.default_rng([os.getpid(), time.time_ns() % (1 << 32)])
    for _ in range(attempts):
        base = int(rng.integers(20000, 60000))
        socks = []
        try:
            for off in range(n):
                s = socket.socket()
                s.bind(("0.0.0.0", base + off))
                socks.append(s)
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError("no free port block found")


def _tail(path: str, nbytes: int = 4000) -> str:
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() - nbytes))
            return f.read().decode("utf-8", "replace")
    except OSError:
        return "<no log>"


def soak_worker_env() -> dict:
    """The environment of a worker process: this checkout on the path, one
    OpenMP thread."""
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def spawn_soak_worker(cfg_path: str, role: str, rank: int, workdir: str, log_path: str,
                      device: Optional[str] = None, env: Optional[dict] = None):
    """Start ``python -m fedml_tpu_torch.cross_silo.soak_worker`` (a fresh
    interpreter: never a fork of a process with CUDA up), its output to
    ``log_path``."""
    import subprocess
    import sys

    argv = [sys.executable, "-m", "fedml_tpu_torch.cross_silo.soak_worker", cfg_path, role,
            str(rank), workdir] + ([str(device)] if device is not None else [])
    with open(log_path, "wb") as lf:
        return subprocess.Popen(argv, stdout=lf, stderr=subprocess.STDOUT,
                                env=env if env is not None else soak_worker_env(),
                                cwd=_REPO_ROOT)


def run_multiproc_kill_soak(n_clients: int = 3, versions: int = 160, buffer_k: int = 3,
                            concurrency: int = 3, kill_server_at: int = 80,
                            client_kills: tuple = ((1, 20), (2, 45)),
                            journal_every_rounds: int = 5, redispatch_timeout_s: float = 1.0,
                            seed: int = 0, chaos: Optional[dict] = None,
                            timeout_s: float = 420.0, device: Optional[str] = None,
                            cfg_overrides: Optional[dict] = None,
                            extra_overrides: Optional[dict] = None) -> dict:
    """Real OS processes, real SIGKILLs: one async server process and
    ``n_clients`` silo processes (``soak_worker``) over TCP, each with its
    journal.  The supervisor follows the server journal's steps (read-only;
    atomic replaces make the reads safe), SIGKILLs the server at
    ``kill_server_at`` and each ``(rank, at_version)`` silo at its mark,
    restarts every victim over its journal and drives the run to the end:
    process death, listener teardown and rebinding, refused connections,
    reconnect backoff against a listener really gone, and cold interpreter
    restarts.

    The accounting: all ``versions`` with monotone journal steps (the
    restarted server resumes at the last committed step); every silo kill
    comes back as one restart, a journal resume or a cold rejoin
    (``unaccounted`` 0); no upload folds twice (resends dedup by key).
    ``chaos`` puts ``chaos_*`` flags in every worker's configuration, so
    seeded faults ride the same run as the SIGKILLs; the server reports
    its wrapper's injections.  A worker that exits on its own with an error
    fails the soak; every worker is bounded by ``timeout_s`` and all are
    killed at the end.

    ``device`` is each worker's (``None``: the card), ``cfg_overrides`` and
    ``extra_overrides`` replace the LR configuration's fields and flags (the
    card's drill runs the flagship ResNet-20).  Sizing: a SIGKILL restart
    costs an interpreter start, ``import torch`` and the data (and CUDA's
    set-up on the card), so ``versions`` must leave rounds for every
    victim to come back to."""
    import glob
    import json
    import shutil
    import signal
    import tempfile

    from .journal import ServerJournal

    workdir = tempfile.mkdtemp(prefix="soak_multiproc_")
    summary_path = os.path.join(workdir, "server_summary.json")
    journal_dir = os.path.join(workdir, "server_journal")
    base_port = _free_port_block(n_clients + 1)
    cfg_path = os.path.join(workdir, "cfg.json")
    cfg_json = {
        "training_type": "cross_silo", "dataset": "synthetic", "model": "lr",
        "client_num_in_total": n_clients, "client_num_per_round": concurrency,
        "comm_round": versions, "epochs": 1, "batch_size": 16, "learning_rate": 0.1,
        "partition_method": "homo", "synthetic_train_size": 64 * n_clients,
        "synthetic_test_size": 64, "frequency_of_the_test": 0, "compute_dtype": "float32",
        "metrics_jsonl_path": "", "random_seed": seed, "run_id": f"mpsoak_{seed}",
        "backend": "TCP", **(cfg_overrides or {}),
        "extra": {
            "async_aggregation": True, "async_buffer_k": buffer_k,
            "async_concurrency": concurrency,
            "async_redispatch_timeout_s": redispatch_timeout_s,
            "server_journal_dir": journal_dir,
            "server_journal_every_rounds": journal_every_rounds,
            "client_journal_dir": os.path.join(workdir, "client_journal"),
            "comm_compression": "topk", "comm_compress_min_size": 64,
            "tcp_base_port": base_port,
            **({"chaos_seed": seed, **chaos} if chaos else {}),
            **(extra_overrides or {}),
        },
    }
    with open(cfg_path, "w") as f:
        json.dump(cfg_json, f)
    env = soak_worker_env()
    env["SOAK_WORKER_TIMEOUT_S"] = str(timeout_s)
    boots: dict[int, int] = {}

    def spawn(role: str, rank: int):
        boots[rank] = boots.get(rank, 0) + 1
        return spawn_soak_worker(cfg_path, role, rank, workdir,
                                 os.path.join(workdir, f"{role}_{rank}_boot{boots[rank]}.log"),
                                 device=device, env=env)

    def logs() -> str:
        return "\n".join(f"--- {p} ---\n{_tail(p)}"
                         for p in sorted(glob.glob(os.path.join(workdir, "*.log"))))

    journal_reader = ServerJournal(journal_dir)
    procs: dict[int, object] = {r: spawn("client", r) for r in range(1, n_clients + 1)}
    procs[0] = spawn("server", 0)
    pending_client_kills = sorted(client_kills, key=lambda m: m[1])
    server_killed = False
    versions_at_kill = None
    max_step_seen = 0
    monotone = True
    server_restarts = client_restarts = 0
    t0 = time.monotonic()
    try:
        deadline = t0 + timeout_s
        while not os.path.exists(summary_path):
            if time.monotonic() > deadline:
                raise RuntimeError(f"multiproc soak did not complete in {timeout_s}s (journal "
                                   f"step {max_step_seen}/{versions})\n{logs()}")
            steps = journal_reader.steps()
            step = max(steps) if steps else 0
            if step < max_step_seen:
                monotone = False  # the journal went back: recovery broke continuity
            max_step_seen = max(max_step_seen, step)
            if not server_killed and max_step_seen >= kill_server_at:
                server_killed = True
                versions_at_kill = max_step_seen
                procs[0].send_signal(signal.SIGKILL)
                procs[0].wait(timeout=30)
                time.sleep(0.2)
                procs[0] = spawn("server", 0)
                server_restarts += 1
            while pending_client_kills and max_step_seen >= pending_client_kills[0][1]:
                rank, _mark = pending_client_kills.pop(0)
                procs[rank].send_signal(signal.SIGKILL)
                procs[rank].wait(timeout=30)
                time.sleep(0.2)
                procs[rank] = spawn("client", rank)
                client_restarts += 1
            for rank, p in procs.items():
                if p.poll() not in (None, 0):
                    raise RuntimeError(f"worker rank {rank} exited rc={p.poll()} "
                                       f"unexpectedly\n{logs()}")
            time.sleep(0.02)
        with open(summary_path) as f:
            summary = json.load(f)
        # FINISH went out: the silos get a bounded drain
        drain = time.monotonic() + 30.0
        while time.monotonic() < drain and any(procs[r].poll() is None
                                               for r in range(1, n_clients + 1)):
            time.sleep(0.2)
        clients_finished = sum(1 for r in range(1, n_clients + 1) if procs[r].poll() == 0)
        resumed = cold = 0
        for bp in glob.glob(os.path.join(workdir, "boot_r*.json")):
            with open(bp) as f:
                boot = json.load(f)
            if boot.get("restart"):
                if boot.get("resumed"):
                    resumed += 1
                else:
                    cold += 1
        reports = []
        for rp in sorted(glob.glob(os.path.join(workdir, "report_r*.json"))):
            with open(rp) as f:
                reports.append(json.load(f))
        return {
            "clients": n_clients,
            "versions": summary["server_version"],
            "versions_at_kill": versions_at_kill,
            "recovered_step": summary.get("recovered_step"),
            "session_epoch": summary["session_epoch"],
            "monotone": bool(monotone and summary["server_version"] >= max_step_seen
                             and (summary.get("recovered_step") or 0)
                             <= (versions_at_kill or versions)),
            "completed": bool(summary.get("completed")),
            "arrivals": summary["arrivals"],
            "server_kills": server_restarts,
            "client_kills": client_restarts,
            "resumed_from_journal": resumed,
            "cold_rejoins": cold,
            "unaccounted": client_restarts - resumed - cold,
            "deduped": summary["deduped"],
            "rejected_stale": summary["rejected_stale"],
            "timeout_redispatches": summary["timeout_redispatches"],
            "clients_finished": clients_finished,
            "chaos": summary.get("chaos"),
            "reports": reports,
            "wall_s": round(time.monotonic() - t0, 4),
        }
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
        for p in procs.values():
            with contextlib.suppress(Exception):
                p.wait(timeout=10)
        shutil.rmtree(workdir, ignore_errors=True)
