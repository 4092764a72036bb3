"""Buffered-async cross-silo server (the port of
``fedml_tpu/cross_silo/async_server.py``): FedBuff-style
staleness-decayed folds.

The synchronous server closes a round when every selected client has
replied; this manager removes the barrier:

- **Clients train continuously.**  Every upload is answered with a fresh
  dispatch of the current global model.  ``async_concurrency`` clients
  (default ``client_num_per_round``) are kept in flight; a deterministic
  round-robin cursor rotates work through the rest of the fleet.
- **Every arrival folds at once** into the streaming accumulator
  (``FedMLAggregator.fold``, on the server's device, a ``qsgd8`` leaf
  through the dequantize kernel) with weight ``n * s(tau)``, where ``tau =
  server_version - client_version`` (the version the dispatch carried,
  echoed in the reply's round index) and ``s(tau) = (1 + tau) **
  -async_staleness_exponent``; ``s(0)`` is the literal ``1.0``, so an
  all-fresh run folds bitwise like the synchronous streaming path.  Under
  an attack, a defense or LDP (a trust pipeline that needs the stacked
  models) the upload is buffered instead, with the decayed weight; central
  DP alone streams and lands its noise (one launch of the noise kernel) at
  each virtual round's finalize.
- **A virtual round closes every ``async_buffer_k`` arrivals**: finalize,
  the algorithm's server step, evaluation on the test cadence, ``server_version
  += 1``, the journal snapshot, and the finish at ``comm_round``.
- **A redispatch watchdog bounds lost work**: a dispatch not answered
  within ``async_redispatch_timeout_s`` re-issues its slot to the next
  client, so a lost dispatch or upload costs one timeout.
- **Recovery** (``extra.server_journal_dir``): the journal carries the
  server version, the in-flight table, the round-robin cursor, the
  staleness cursors and the dedup table.  A recovered server resumes under
  a bumped session epoch; an old-epoch upload folds exactly once when its
  ``(client, version)`` is in the journaled in-flight table, and every
  other old-epoch upload is rejected.

What the reference keeps in its metrics registry and trace spans (not
ported, ROADMAP Queue 1 item 10) are plain attributes here: the arrival
counts by path (``arrivals_by_path``) and the staleness and fold-lag
histograms (``staleness_hist``, ``fold_lag_hist``: plain counts over the
reference's bucket edges).  The reference's health ledger is not ported
either: no RTT or deadline breach is recorded,
``extra.health_aware_selection`` stays refused, so nothing is throttled
(the journal's throttle set and ``health`` entry are empty).  There is no
gang scheduler (the reference's ``round_gate`` is None on the single-job
path), no model publication and no AOT warm-up.

Lock order: the receive thread (uploads), the watchdog on the runtime's
timer thread and the caller's thread all touch the dispatch ledger and the
fold under ``_agg_lock``.  ``send_finish`` runs under it (from the
virtual-round close), so ``finish`` only flips the ``_finished`` latch,
which the watchdog re-checks under the lock, and does not wait for the
timer thread (``_join_runtime_on_finish``).  ``hard_kill`` takes no lock,
as a SIGKILL takes none.
"""

from __future__ import annotations

import bisect
import logging
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..comm.message import Message
from ..core.flags import cfg_extra
from ..obs.metrics import MetricsLogger
from . import message_define as md
from .server import FedMLAggregator, FedMLServerManager

log = logging.getLogger("fedml_tpu_torch.cross_silo.async_server")

#: the reference's bucket edges (``fedml_async_staleness_versions``)
STALENESS_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0)
#: the reference's default latency buckets (``fedml_async_fold_lag_seconds``):
#: 100 us doubling, 22 edges
FOLD_LAG_BUCKETS = tuple(1e-4 * 2.0 ** i for i in range(22))


class BucketCounts:
    """A fixed-bucket histogram as plain counts: ``edges`` (ascending, then
    ``+inf``) and ``counts[i]``, the observations ``<= edges[i]`` and above
    the edge before (the reference registry's ``observe``)."""

    def __init__(self, edges):
        self.edges = tuple(float(b) for b in edges) + (float("inf"),)
        self.counts = [0] * len(self.edges)

    def observe(self, value: float) -> None:
        self.counts[bisect.bisect_left(self.edges, float(value))] += 1


def staleness_scale(staleness: int, exponent: float) -> float:
    """Polynomial staleness decay ``s(tau) = (1 + tau) ** -exponent``
    (FedBuff).  ``s(0)`` is the literal ``1.0``, so a fresh update's fold is
    bitwise the synchronous streaming fold; a zero exponent disables the
    decay."""
    if staleness <= 0 or exponent == 0.0:
        return 1.0
    return float((1.0 + float(staleness)) ** (-float(exponent)))


def refuse_hierarchical_async(cfg) -> None:
    """The reference's gate: the async protocol dispatches per client on
    each fold, with no round barrier for an edge to fold against."""
    from .edge import build_topology

    if build_topology(cfg) is not None:
        raise NotImplementedError("hierarchical aggregation (hier_fanout/hier_topology) is "
                                  "synchronous-only for now; unset it or async_aggregation")


class AsyncFedMLServerManager(FedMLServerManager):
    """Buffered-async server manager (module docstring)."""

    _journal_recover_deferred = True
    _join_runtime_on_finish = False

    def __init__(self, cfg, aggregator: FedMLAggregator, backend: Optional[str] = None,
                 logger: Optional[MetricsLogger] = None):
        refuse_hierarchical_async(cfg)
        super().__init__(cfg, aggregator, backend=backend, logger=logger)
        self._agg_lock = threading.Lock()
        self.server_version = 0
        self.buffer_k = max(1, int(cfg_extra(cfg, "async_buffer_k")))
        self.staleness_exponent = float(cfg_extra(cfg, "async_staleness_exponent"))
        self.concurrency = max(1, int(cfg_extra(cfg, "async_concurrency", None) or self.per_round))
        self.redispatch_timeout = float(cfg_extra(cfg, "async_redispatch_timeout_s"))
        #: client -> (dispatched version, monotonic send time) of every
        #: assignment in flight: the watchdog's scan set
        self._outstanding: dict[int, tuple[int, float]] = {}
        self._ever_dispatched: set[int] = set()
        self._rr_cursor = 0
        self._arrivals_in_round = 0
        self._round_staleness: list[int] = []
        self._finished = False
        self.total_arrivals = 0
        self.timeout_redispatches = 0
        self.staleness_sum = 0
        self.staleness_max = 0
        self.first_dispatch_monotonic: Optional[float] = None
        self.finished_monotonic: Optional[float] = None
        #: the reference's registry series, as plain counts
        self.arrivals_by_path = {"folded": 0, "buffered": 0}
        self.staleness_hist = BucketCounts(STALENESS_BUCKETS)
        self.fold_lag_hist = BucketCounts(FOLD_LAG_BUCKETS)
        # recovery: the journaled in-flight table re-enters _outstanding when
        # dispatching resumes; _prev_epoch_inflight is the acceptance set of
        # old-epoch uploads (dispatched before the crash, never folded into
        # the journaled state, so folded once with corrected staleness)
        self._recovered_outstanding: dict[int, int] = {}
        self._prev_epoch_inflight: dict[int, int] = {}
        self._journal_recover()

    # -- protocol ------------------------------------------------------------
    def send_init_msg(self) -> None:
        """All clients online: dispatch the first ``concurrency`` wave and arm
        the watchdog.  A recovered server re-arms its journaled in-flight
        table first (those uploads may still come under the old epoch, or
        never, and then re-issue through the watchdog) and tops up from
        there."""
        with self._agg_lock:
            if self._init_sent:
                return
            self._init_sent = True
            if self.server_version >= self.comm_round:
                # the crash came after the last virtual round's snapshot
                self._finished = True
                self.finished_monotonic = time.monotonic()
                self.send_finish()
                return
            # bootstrap publication: serving workers come up on the initial
            # (or journal-recovered) global before the first virtual round
            self._publish_model()
            self.first_dispatch_monotonic = time.monotonic()
            self._round_t0 = time.perf_counter()
            if self._recovered_outstanding:
                now = time.monotonic()
                for cid, ver in self._recovered_outstanding.items():
                    self._outstanding.setdefault(cid, (ver, now))
                self._recovered_outstanding = {}
            self._refill()
            self._arm_watchdog()

    def handle_message_receive_model(self, msg: Message) -> None:
        now = time.monotonic()
        with self._agg_lock:
            if self._finished:
                return  # after the finish: the run is closed
            sender = int(msg.get_sender_id())
            # a key already folded is a redelivery: dropped before the epoch
            # fence, since the journaled key table outlives a crash
            upload_key = msg.get_control(md.MSG_ARG_KEY_UPLOAD_KEY)
            if upload_key is not None and self._is_duplicate_upload(sender, upload_key):
                self.deduped_uploads += 1
                return
            # control-only reads: a plain get() of a missing key would
            # restore the tensors and demote the fold to the dense buffer
            client_version = int(msg.get_control(md.MSG_ARG_KEY_ROUND_INDEX,
                                                 self.server_version))
            if self.journal is not None:
                # the session-epoch fence: an old-epoch upload folds once iff
                # its (client, version) is in the journaled in-flight table
                epoch = int(msg.get_control(md.MSG_ARG_KEY_SESSION_EPOCH, self.session_epoch))
                if epoch != self.session_epoch:
                    if not (epoch == self.session_epoch - 1
                            and self._prev_epoch_inflight.get(sender) == client_version):
                        self.rejected_stale += 1
                        return
                    del self._prev_epoch_inflight[sender]
            staleness = max(0, self.server_version - client_version)
            self._outstanding.pop(sender, None)
            n_samples = float(msg.get(md.MSG_ARG_KEY_NUM_SAMPLES))
            is_delta = bool(msg.get_control(md.MSG_ARG_KEY_MODEL_IS_DELTA, False))
            self._round_payload_bytes += int(msg.wire_nbytes)
            scale = staleness_scale(staleness, self.staleness_exponent)
            if self.aggregator.fold(sender, msg, n_samples, is_delta, scale=scale):
                self.arrivals_by_path["folded"] += 1
            else:
                # the exact path (a trust pipeline that needs the stacked
                # models): the decay rides the weight
                self.aggregator.add_local_trained_result(
                    sender, msg.get(md.MSG_ARG_KEY_MODEL_PARAMS), n_samples * scale,
                    is_delta=is_delta)
                self.arrivals_by_path["buffered"] += 1
            self._note_upload_key(sender, upload_key)
            self.total_arrivals += 1
            self._arrivals_in_round += 1
            self._round_staleness.append(int(staleness))
            self.staleness_sum += int(staleness)
            self.staleness_max = max(self.staleness_max, int(staleness))
            self.staleness_hist.observe(float(staleness))
            if msg.recv_monotonic is not None:
                self.fold_lag_hist.observe(max(0.0, now - msg.recv_monotonic))
            if self._arrivals_in_round >= self.buffer_k:
                self._close_virtual_round()
            if not self._finished:
                self._dispatch(self._next_client(fallback=sender))

    def _close_virtual_round(self) -> None:
        """Finalize, step the server, evaluate, bump the version, journal;
        finish at ``comm_round``.  Caller holds _agg_lock."""
        arrivals = self._arrivals_in_round
        t0 = time.perf_counter()
        self.aggregator.aggregate(self.server_version)
        stal = self._round_staleness
        metrics = {
            "round": self.server_version,
            "arrivals": arrivals,
            "staleness_mean": round(float(np.mean(stal)), 4) if stal else 0.0,
            "staleness_max": int(max(stal)) if stal else 0,
            **self.aggregator.round_metrics(),
        }
        if self.cfg.frequency_of_the_test and (
            (self.server_version + 1) % self.cfg.frequency_of_the_test == 0
            or self.server_version == self.comm_round - 1
        ):
            metrics.update(self.aggregator.test_on_server())
        if self.aggregator.device.type == "cuda":
            torch.cuda.synchronize(self.aggregator.device)
        end = time.perf_counter()
        metrics.update(round_time_s=end - self._round_t0, aggregate_time_s=end - t0,
                       upload_bytes=self._round_payload_bytes)
        self._round_t0, self._round_payload_bytes = end, 0
        self.logger.log(metrics)
        self.history.append(metrics)
        self.server_version += 1
        self.round_idx = self.server_version
        self._arrivals_in_round = 0
        self._round_staleness = []
        # the accumulator is fresh and the dispatch ledger consistent: the
        # journal's commit point, and (extra.model_publish_dir) the serving
        # fleet's version bump
        self._journal_snapshot()
        self._publish_model()
        if self.server_version >= self.comm_round:
            self._finished = True
            self.finished_monotonic = time.monotonic()
            self.send_finish()
            return
        self._refill()

    # -- dispatch ------------------------------------------------------------
    def _dispatch(self, cid: int) -> None:
        """Send the current global, stamped with ``server_version``, to one
        client and track the assignment.  Caller holds _agg_lock."""
        first = cid not in self._ever_dispatched
        self._ever_dispatched.add(cid)
        msg = Message(md.MSG_TYPE_S2C_INIT_CONFIG if first else md.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT,
                      0, cid)
        msg.add_params(md.MSG_ARG_KEY_MODEL_PARAMS, self.aggregator._host_global())
        msg.add_params(md.MSG_ARG_KEY_CLIENT_INDEX, cid - 1)
        msg.add_params(md.MSG_ARG_KEY_ROUND_INDEX, self.server_version)
        if self.journal is not None:
            msg.add_params(md.MSG_ARG_KEY_SESSION_EPOCH, self.session_epoch)
        try:
            self._outstanding[cid] = (self.server_version, time.monotonic())
            self.send_message(msg)
        except Exception:
            # one unreachable peer must not kill the receive or timer
            # thread: the watchdog refills the slot
            self._outstanding.pop(cid, None)
            log.warning("async dispatch to client %d failed; slot refills", cid, exc_info=True)

    def _next_client(self, fallback: int) -> int:
        """Round-robin over the clients, skipping those in flight;
        ``fallback`` when none is idle.  Caller holds _agg_lock."""
        pool = self.client_ids
        for _ in range(len(pool)):
            cid = pool[self._rr_cursor % len(pool)]
            self._rr_cursor += 1
            if cid not in self._outstanding:
                return cid
        return fallback

    def _refill(self) -> None:
        """Top the in-flight set back up to ``concurrency``.  Caller holds
        _agg_lock."""
        for _ in range(max(0, self.concurrency - len(self._outstanding))):
            cid = self._next_client(fallback=-1)
            if cid < 0 or cid in self._outstanding:
                return  # everyone in flight
            self._dispatch(cid)

    # -- watchdog ------------------------------------------------------------
    def _arm_watchdog(self) -> None:
        if self.redispatch_timeout <= 0:
            return
        self._runtime.arm(self, "watchdog", max(0.05, min(1.0, self.redispatch_timeout / 4)),
                          self._on_watchdog)

    def _on_watchdog(self) -> None:
        with self._agg_lock:
            if self._finished or self.done.is_set():
                return
            now = time.monotonic()
            overdue = [cid for cid, (_v, t0) in self._outstanding.items()
                       if now - t0 > self.redispatch_timeout]
            for cid in overdue:
                self._outstanding.pop(cid, None)
                self.timeout_redispatches += 1
                self._dispatch(self._next_client(fallback=cid))
            self._refill()
            self._arm_watchdog()

    # -- recovery journal ------------------------------------------------------
    def _journal_recover(self) -> None:
        """Install the newest intact snapshot (at construction, before any
        thread): version, model and server state, the dispatch ledger, the
        staleness cursors, the dedup table and the run's counts; resume
        under a bumped session epoch."""
        if self.journal is None:
            return
        snap = self.journal.restore()
        if snap is None:
            return
        p = snap["protocol"]
        self.session_epoch = int(p.get("session_epoch", 0)) + 1
        self.server_version = int(p.get("server_version", 0))
        self.round_idx = self.server_version
        self.recovered_step = int(snap["step"])
        self._rr_cursor = int(p.get("rr_cursor", 0))
        self._ever_dispatched = {int(c) for c in p.get("ever_dispatched", [])}
        self.total_arrivals = int(p.get("total_arrivals", 0))
        self.timeout_redispatches = int(p.get("timeout_redispatches", 0))
        self.rejected_stale = int(p.get("rejected_stale", 0))
        self.staleness_sum = int(p.get("staleness_sum", 0))
        self.staleness_max = int(p.get("staleness_max", 0))
        self._recovered_outstanding = {int(c): int(v)
                                       for c, v in (p.get("outstanding") or {}).items()}
        self._prev_epoch_inflight = dict(self._recovered_outstanding)
        if snap["model"] is not None:
            self.aggregator.restore_model_state(snap["model"])
        self.aggregator.restore_stream_state(p, snap["arrays"])
        self._restore_folded_keys(p)
        log.info("recovered from journal step %d (version %d, session epoch %d, %d in-flight "
                 "re-armed)", self.recovered_step, self.server_version, self.session_epoch,
                 len(self._recovered_outstanding))

    def _journal_protocol_state(self) -> dict:
        return {
            "kind": "async", "session_epoch": self.session_epoch,
            "server_version": self.server_version, "round_idx": self.round_idx,
            "outstanding": {str(c): int(v) for c, (v, _t) in sorted(self._outstanding.items())},
            "throttled": [],
            "ever_dispatched": sorted(self._ever_dispatched),
            "rr_cursor": int(self._rr_cursor),
            "total_arrivals": int(self.total_arrivals),
            "timeout_redispatches": int(self.timeout_redispatches),
            "rejected_stale": int(self.rejected_stale),
            "deduped": int(self.deduped_uploads),
            "folded_keys": self._export_folded_keys(),
            "staleness_sum": int(self.staleness_sum),
            "staleness_max": int(self.staleness_max),
            "health": {},
        }

    # -- teardown ------------------------------------------------------------
    def finish(self) -> None:
        # a latch that only flips False -> True: reached under _agg_lock from
        # send_finish, bare on the timeout path; a watchdog already waiting
        # for the lock re-checks it there and returns
        self._finished = True
        super().finish()

    def hard_kill(self) -> None:
        """Crash simulation: stop the receive loop and the watchdog at once,
        with no FINISH, no journal write and no lock; what the journal does
        not hold is lost, as under SIGKILL."""
        self._finished = True
        super().hard_kill()

    # -- accounting ------------------------------------------------------------
    def async_summary(self) -> dict:
        """The run's accounting (the reference's keys)."""
        with self._agg_lock:
            wall = None
            if self.first_dispatch_monotonic is not None:
                end = self.finished_monotonic or time.monotonic()
                wall = max(1e-9, end - self.first_dispatch_monotonic)
            return {
                "server_version": self.server_version,
                "arrivals": self.total_arrivals,
                "buffer_k": self.buffer_k,
                "concurrency": self.concurrency,
                "staleness_mean": round(self.staleness_sum / max(1, self.total_arrivals), 4),
                "staleness_max": self.staleness_max,
                "timeout_redispatches": self.timeout_redispatches,
                "rejected_stale": self.rejected_stale,
                "deduped": self.deduped_uploads,
                "recovered_step": self.recovered_step,
                "session_epoch": self.session_epoch,
                "outstanding_at_end": len(self._outstanding),
                "prev_epoch_inflight_at_end": len(self._prev_epoch_inflight),
                "throttled_at_end": 0,
                "wall_s": round(wall, 4) if wall is not None else None,
                "versions_per_sec": round(self.server_version / wall, 4) if wall else None,
            }
