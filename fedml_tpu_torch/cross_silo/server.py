"""Cross-silo FL server (the port of ``fedml_tpu/cross_silo/server.py``).

The synchronous round loop of the reference::

  start -> check client status -> all ONLINE -> send_init
  -> on each client model: add, check_whether_all_receive -> aggregate
  -> test -> client_selection -> sync model out -> ... -> finish

with its bounded-wait straggler handling (``extra.straggler_timeout_s``)
and status re-probe on the event-driven runtime (``cross_silo/runtime.py``).
The global model lives on the device; models travel as numpy trees in flax
layout (``weights.torch_to_flax`` before a send, ``flax_to_torch`` after a
receive), so a frame carries the reference's bytes for the same weights.

Kept as the reference keeps it: the buffer-all aggregate through the
algorithm's ``aggregate`` / ``server_update`` (the FedAvg family), and the
streaming fold.  Under a codec (``extra.comm_compression``) or
``extra.streaming_aggregation``, for an algorithm whose ``aggregate`` is
the stock weighted mean (``supports_associative_fold``), each arriving
reply's still-undecoded frame folds leaf by leaf into a running weighted
sum as it lands (``parallel/stream_fold.py``: f32, flax layout, on the
server's device, bitwise the reference's host fold; a ``qsgd8`` leaf
through the dequantize kernel), so at most the sum and one reply are
buffered; a delta upload (``model_is_delta``) folds as sent and the round's
base comes back at finalize.  A frame whose structure or shapes differ from
the model's falls back to the dense buffer, with a warning, as in the
reference.  Each history row also carries ``round_time_s`` (broadcast to
evaluated), ``aggregate_time_s`` and ``upload_bytes`` (wire bytes of the
round's model uploads): the reference records these in its metrics
registry and trace spans, which the port has not ported yet; for the same
reason a broadcast carries no trace-propagation header.  A handler that
raises fails the run at once (``run_until_done`` raises), where the
reference logs it and waits for its timeout; a transport error
(``OSError``: a reset, a refused connection) is contained as the reference
contains it.

The trust pipeline (``trust/pipeline.py``) runs as the reference runs it:
on the buffer-all path its three hooks around the aggregate
(``on_client_outputs``, ``on_aggregation`` with its override, then
``on_after_aggregation``); a pipeline of central DP alone
(``supports_streaming``) keeps the streaming fold and fires its finalize
hook once on the folded aggregate, with the same round's draws, so the
streaming CDP global is bitwise the buffer-all one.  Central DP's noise is
one launch of the noise kernel a round on either path.  Attacks, defenses
and LDP keep the buffer-all path.

Recovery (``extra.server_journal_dir``, ``cross_silo/journal.py``): the
plain server snapshots its protocol state at round boundaries (and every
``server_journal_every_folds`` streaming folds), recovers the newest intact
snapshot when it is built, and resumes under a bumped session epoch, which
every dispatch carries: an upload stamped with an older epoch is rejected.
Uploads keyed by a client journal are folded once per key (the last
``DEDUP_KEYS_PER_CLIENT`` keys a client, journaled).  :meth:`hard_kill`
simulates a crash.  The reference's health ledger is not ported: the
journal's ``health`` entry is empty.

The buffered-async server (``extra.async_aggregation``) is the subclass in
``cross_silo/async_server.py``; this class carries its hooks: a deferred
journal recovery (``_journal_recover_deferred``), the journaled dedup
table's export and restore, and a ``finish`` that does not wait for the
timer thread (``_join_runtime_on_finish``; the async server finishes from
under its lock, which its watchdog takes).  The reference's dispatch times
(``_sent_at``) feed its RTT histogram and health ledger, neither ported,
so the port keeps none.

The aggregation tree (``extra.hier_fanout`` / ``hier_topology``,
``cross_silo/edge.py``): the server dispatches to the root's child
aggregators, one message each with its subtree's plan, and folds each
tagged partial with direct adds (:meth:`FedMLAggregator.fold_partial`);
its sources count as received clients, so quorum and the all-receive
check are the flat protocol's.  ``upload_ingress_bytes`` counts the wire
bytes of the uploads that reached the server.

Model publication (``extra.model_publish_dir``, ``serving/publisher.py``,
reference L732-738 and L1185-1198): at the first dispatch and at every
version bump (each round's end; the async server's every virtual round)
the server writes its host global (numpy, flax layout: the wire's bytes,
bitwise the reference's for the same global) as ``params-v<round>.wire``
and commits the manifest, so serving workers hot-swap the live model.

Refused with ``NotImplementedError`` when flagged: the flight recorder,
SLOs, the timeline, OTLP, remote observability, health-aware selection,
the AOT store, the metrics endpoint (``ROADMAP.md`` Queue 1 item 10b), and
contribution assessment (the reference's cross-silo server computes none,
so the flag would be a silent no-op).
"""

from __future__ import annotations

import logging
import math
import threading
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from .. import weights
from ..algorithms import create as create_algorithm, hparams_from_config
from ..comm import codecs, wire
from ..comm.base import BACKOFF_PURPOSE_STATUS_PROBE, backoff_delay
from ..comm.comm_manager import FedMLCommManager
from ..comm.message import Message
from ..core import pytree as pt
from ..core import rng
from ..core.checkpoint import tree_to_device
from ..core.flags import cfg_extra
from ..fl.local_sgd import make_eval_fn
from ..obs.metrics import MetricsLogger
from . import message_define as md

log = logging.getLogger("fedml_tpu_torch.cross_silo.server")

# extra.server_shard_fold (the reference's ShardedStreamAccumulator over its
# mesh) is served as it stands: the fold's one shard owner in this process is
# the server's device, so the sharded fold is the device fold, bitwise the
# reference's on the CPU (tests/test_torch_multiprocess.py)
_UNPORTED_SERVER_FLAGS = (
    "flight_recorder", "slo_specs", "perf_timeline", "otlp_endpoint",
    "enable_remote_obs", "health_aware_selection", "aot_programs", "metrics_port")
#: the reference's LightSecAgg server recovers a crash at a round boundary,
#: but not one inside a round (a decided difference, ROADMAP Queue 3)
LSA_SERVER_JOURNAL_REFUSAL = (
    "extra.server_journal_dir under LightSecAgg: the reference's LightSecAgg server recovers "
    "a crash at a round boundary, but a crash inside a round stalls the recovered run: the "
    "dead server's masked uploads of that round, still queued for rank 0, are taken against "
    "the round's new mask exchange and the aggregate masks never decode (the reference's run "
    "times out); refused until that recovery works")

#: the reference's FHE server recovers a crash at a round boundary, but not
#: one inside a round (a decided difference, ROADMAP Queue 3)
FHE_SERVER_JOURNAL_REFUSAL = (
    "extra.server_journal_dir under FHE: the reference's FHE server recovers a crash at a "
    "round boundary, but a crash inside a round ends at a wrong global: the FHE upload "
    "carries no session epoch, so the recovered server takes a dead server's upload still "
    "queued for rank 0 before its first dispatch and closes the round on it alone (one "
    "ciphertext rescaled by n/k); refused until that recovery works")

#: idempotence keys remembered per client for the exactly-once dedup (the
#: reference's bound)
DEDUP_KEYS_PER_CLIENT = 16


def refuse_unported_server(cfg, secure: Optional[str] = None) -> None:
    """Raise for a server feature this slice does not serve.  ``secure``
    names a secure server's protocol (``"shamir"``, ``"lightsecagg"`` or
    ``"fhe"``), which checks its trust composition itself; of the journals
    Shamir SecAgg takes the server's (its round-boundary and mid-round
    crashes recover as the reference's do), LightSecAgg none (the
    reference's fails inside a round) and FHE none (the reference's fails
    inside a round)."""
    for flag in _UNPORTED_SERVER_FLAGS:
        value = cfg_extra(cfg, flag)
        # metrics_port 0 is set (an ephemeral port in the reference)
        if value or (flag == "metrics_port" and value is not None):
            raise NotImplementedError(f"extra.{flag} is not ported to the cross-silo server yet "
                                      "(ROADMAP.md Queue 1 item 10b)")
    if secure == "lightsecagg" and cfg_extra(cfg, "server_journal_dir"):
        raise NotImplementedError(LSA_SERVER_JOURNAL_REFUSAL)
    if secure == "fhe" and cfg_extra(cfg, "server_journal_dir"):
        raise NotImplementedError(FHE_SERVER_JOURNAL_REFUSAL)
    if secure is None and getattr(cfg, "enable_contribution", False):
        raise NotImplementedError("enable_contribution on the cross-silo server: the "
                                  "reference's server computes no contribution, so the flag "
                                  "would be a silent no-op; run contribution in the simulator")


def _apply_delta(global_leaf, delta_leaf):
    """global + delta per leaf (host numpy), mirroring the client's
    ``_leaf_delta``: f32 math for float leaves, a native add for integers."""
    g, d = np.asarray(global_leaf), np.asarray(delta_leaf)
    if g.dtype.kind in "fc":
        return (g.astype(np.float32) + d.astype(np.float32)).astype(g.dtype)
    return g + d


def provisional_steps_per_epoch(cfg) -> int:
    """The reference's config-derived steps/epoch guess: the server's
    algorithm never trains, so the FedAvg family only needs it positive."""
    return max(1, math.ceil(
        getattr(cfg, "synthetic_train_size", 1024) / max(cfg.client_num_in_total, 1)
        / cfg.batch_size))


def eval_batch_size(cfg) -> int:
    return min(256, max(32, cfg.test_batch_size))


class FedMLAggregator:
    """Server-side state: the global model on ``device``, the round's model
    buffer and the algorithm frame (reference ``FedMLAggregator``).

    ``global_vars`` (the port's tree) is the initial global model; without
    it the model is initialised from the port's own init stream (the
    reference draws flax's init from ``root_key(seed)``: tests carry its
    weights across).  ``trust``: the round's trust pipeline, or None."""

    def __init__(self, cfg, model, test_arrays, device, global_vars=None, trust=None):
        self.cfg = cfg
        self.trust = trust
        self.device = torch.device(device)
        self.hp = hparams_from_config(cfg, steps_per_epoch=provisional_steps_per_epoch(cfg))
        self.algorithm = create_algorithm(cfg, self.hp).build(model)
        self.root_key = rng.root_key(cfg.random_seed)
        if global_vars is None:
            global_vars = model.init(rng.generator(rng.init_key(self.root_key)), device)
        self.global_vars = pt.tree_map(lambda t: torch.as_tensor(t).to(device), global_vars)
        self.server_state = self.algorithm.init_server_state(self.global_vars)
        self.model_dict: dict[int, object] = {}
        self.sample_num_dict: dict[int, float] = {}
        self.flag_client_model_uploaded: dict[int, bool] = {}
        tx, ty, n_valid = test_arrays
        self._test = (torch.from_numpy(np.ascontiguousarray(tx)).to(device),
                      torch.from_numpy(np.ascontiguousarray(ty)).to(device, torch.long),
                      int(n_valid))
        self._eval_fn = make_eval_fn(model, self.hp, batch_size=eval_batch_size(cfg))
        self._init_stream_mode(cfg)

    def _init_stream_mode(self, cfg) -> None:
        """The streaming fold is on under a codec,
        ``extra.streaming_aggregation`` or the async server
        (``extra.async_aggregation``) when the algorithm's aggregate is a
        weight-associative fold and the trust pipeline (if any) never needs
        the stacked client models (central DP alone); otherwise the
        buffer-all path."""
        trust_streams = self.trust is None or self.trust.supports_streaming()
        self.stream_mode = bool(
            (codecs.codec_from_config(cfg) or cfg_extra(cfg, "streaming_aggregation")
             or cfg_extra(cfg, "async_aggregation"))
            and trust_streams and self.algorithm.supports_associative_fold())
        self._np_global = None      # host copy of the global (flax layout), per round
        self._stream_tmpl = None    # (base leaves on the device, wire skeleton), per round
        self._stream_acc = None     # the round's DeviceStreamAccumulator
        self._stream_w = 0.0
        self._stream_w_delta = 0.0
        self._stream_folded = 0
        #: high-water mark of client updates buffered at once (the streaming
        #: fold's bound: <= 2 whatever the clients a round)
        self.peak_buffered_updates = 0
        #: host seconds of the round's folds and of its finalize (launches
        #: enqueued, not waited for)
        self.fold_time_s = 0.0
        self.finalize_time_s = 0.0

    def host_global_flax(self) -> dict:
        """The global model as the wire carries it: numpy, flax layout (one
        device-to-host copy)."""
        return weights.torch_to_flax(weights.to_numpy(self.global_vars))

    def _host_global(self) -> dict:
        if self._np_global is None:
            self._np_global = self.host_global_flax()
        return self._np_global

    def _stream_template(self) -> tuple:
        """The round's base leaves (flax layout, on the device) in wire
        order, and the wire skeleton of a model reply."""
        if self._stream_tmpl is None:
            skel, leaves = wire.flatten_with_skeleton(
                {md.MSG_ARG_KEY_MODEL_PARAMS: weights.tensors_to_flax(self.global_vars)})
            self._stream_tmpl = (leaves, skel)
        return self._stream_tmpl

    def _note_buffered(self, inflight: int = 0) -> None:
        n = len(self.model_dict) + inflight + (1 if self._stream_acc is not None else 0)
        self.peak_buffered_updates = max(self.peak_buffered_updates, n)

    def has_received(self, client_idx: int) -> bool:
        return client_idx in self.flag_client_model_uploaded

    def add_local_trained_result(self, client_idx: int, params, sample_num: float,
                                 is_delta: bool = False) -> None:
        """Buffer one client's model (a flax-layout numpy tree off the wire);
        a delta is added to the round's global first."""
        if is_delta:
            params = pt.tree_map(_apply_delta, self._host_global(), params)
        self.model_dict[client_idx] = params
        self.sample_num_dict[client_idx] = sample_num
        self.flag_client_model_uploaded[client_idx] = True
        self._note_buffered()

    def fold(self, client_idx: int, msg, sample_num: float, is_delta: bool,
             scale: float = 1.0) -> bool:
        """Fold one reply's still-undecoded tensor frame into the running
        weighted sum with weight ``sample_num * scale``, leaf by leaf on the
        device.  False when the reply must take the dense buffer instead:
        stream mode off, tensors already restored, or a frame whose
        structure or shapes differ from the model's."""
        if not self.stream_mode:
            return False
        frame = msg.tensor_segments() if hasattr(msg, "tensor_segments") else None
        if frame is None:
            return False
        header, segments = frame
        tmpl, skel = self._stream_template()
        specs = header["leaves"]
        if header["treedef"] != skel or len(specs) != len(tmpl):
            log.warning("client %d frame structure mismatch; buffering densely", client_idx)
            return False
        for spec, t in zip(specs, tmpl):
            if tuple(spec["shape"]) != tuple(t.shape):
                log.warning("client %d leaf shape mismatch; buffering densely", client_idx)
                return False
        t0 = time.perf_counter()
        from ..parallel.stream_fold import DeviceStreamAccumulator, decode_leaf

        if self._stream_acc is None:
            self._stream_acc = DeviceStreamAccumulator(tmpl, self.device)
        # buffered now: the sum and this reply (and any dense fallbacks)
        self._note_buffered(inflight=1)
        w = float(sample_num) * float(scale)
        w32 = self._stream_acc.scalar(w)
        for i, spec, segs in segments:
            self._stream_acc.fold_leaf(i, w32, decode_leaf(spec, segs, self.device))
        self._stream_w += w
        if is_delta:
            self._stream_w_delta += w
        self._stream_folded += 1
        self.sample_num_dict[client_idx] = sample_num
        self.fold_time_s += time.perf_counter() - t0
        return True

    def ingest_streaming(self, client_idx: int, msg, sample_num: float, is_delta: bool) -> bool:
        """:meth:`fold` for the synchronous round: one contribution per
        client a round (a second delivery is swallowed, since a second fold
        would count it twice).  False when the reply must be buffered."""
        if not self.stream_mode:
            return False
        if client_idx in self.flag_client_model_uploaded:
            return True
        if not self.fold(client_idx, msg, sample_num, is_delta):
            return False
        self.flag_client_model_uploaded[client_idx] = True
        return True

    def fold_partial(self, msg, sources: dict, w_delta: float) -> bool:
        """Fold an edge aggregator's pre-folded partial (``cross_silo/
        edge.py``): its tensors carry ``sum_c w_c * x_c`` over the edge's
        children, so each leaf merges with a direct add, and the sources'
        masses land in the ledgers the flat path keeps (the all-receive
        count counts clients as flat).  A redelivery of folded sources is
        swallowed (True); False when stream mode is off, the frame does not
        match the model, or the sources overlap folded ones only in part
        (merged sums cannot be split): a partial has no dense fallback."""
        if not self.stream_mode:
            return False
        frame = msg.tensor_segments() if hasattr(msg, "tensor_segments") else None
        if frame is None:
            return False
        header, segments = frame
        tmpl, skel = self._stream_template()
        specs = header["leaves"]
        if header["treedef"] != skel or len(specs) != len(tmpl) or any(
                tuple(spec["shape"]) != tuple(t.shape) for spec, t in zip(specs, tmpl)):
            log.warning("edge partial frame does not match the model; dropping")
            return False
        fresh = {int(k): float(v) for k, v in sources.items()
                 if int(k) not in self.flag_client_model_uploaded}
        if not fresh:
            return True
        if len(fresh) != len(sources):
            log.warning("edge partial overlaps %d folded sources; dropping",
                        len(sources) - len(fresh))
            return False
        t0 = time.perf_counter()
        from ..parallel.stream_fold import DeviceStreamAccumulator, decode_leaf

        if self._stream_acc is None:
            self._stream_acc = DeviceStreamAccumulator(tmpl, self.device)
        self._note_buffered(inflight=1)
        for i, spec, segs in segments:
            self._stream_acc.fold_partial_leaf(i, decode_leaf(spec, segs, self.device))
        self._stream_w += sum(fresh.values())
        self._stream_w_delta += float(w_delta)
        self._stream_folded += 1
        for cid, w in fresh.items():
            self.sample_num_dict[cid] = w
            self.flag_client_model_uploaded[cid] = True
        self.fold_time_s += time.perf_counter() - t0
        return True

    def received_count(self) -> int:
        return len(self.flag_client_model_uploaded)

    def check_whether_all_receive(self, expected: int) -> bool:
        return self.received_count() >= expected

    def aggregate(self, round_idx: int):
        if self._stream_folded:
            return self._aggregate_streaming(round_idx)
        ids = sorted(self.model_dict)
        trees = [weights.to_torch(weights.flax_to_torch(self.model_dict[i]), self.device)
                 for i in ids]
        stacked = pt.tree_stack(trees)
        w = torch.tensor([self.sample_num_dict[i] for i in ids], dtype=torch.float32,
                         device=self.device)
        agg_override = None
        if self.trust is not None:
            sampled = np.asarray(ids, dtype=np.int32)  # host ids: no device sync
            stacked, w = self.trust.on_client_outputs(stacked, w, sampled, self.global_vars,
                                                      round_idx)
            stacked, w, agg_override = self.trust.on_aggregation(stacked, w, self.global_vars,
                                                                 round_idx)
        agg = agg_override if agg_override is not None else self.algorithm.aggregate(stacked, w)
        new_global, self.server_state = self.algorithm.server_update(
            self.global_vars, self.server_state, agg, round_idx)
        if self.trust is not None:
            new_global = self.trust.on_after_aggregation(new_global, self.global_vars, round_idx)
        self.global_vars = new_global
        self._reset_round()
        return self.global_vars

    def _aggregate_streaming(self, round_idx: int):
        """Finalize the running sum: dense fallbacks fold now, then one
        division (with the delta senders' base added back) per leaf and the
        algorithm's server step."""
        t0 = time.perf_counter()
        from ..parallel.stream_fold import host_to_device

        tmpl, skel = self._stream_template()
        for cid in sorted(self.model_dict):
            w = float(self.sample_num_dict[cid])
            w32 = self._stream_acc.scalar(w)
            _, leaves = wire.flatten_with_skeleton(
                {md.MSG_ARG_KEY_MODEL_PARAMS: self.model_dict[cid]})
            for i, leaf in enumerate(leaves):
                self._stream_acc.fold_leaf(i, w32, host_to_device(leaf, self.device))
            self._stream_w += w
        out = self._stream_acc.finalize(tmpl, self._stream_w_delta, max(self._stream_w, 1e-12))
        agg = weights.tensors_from_flax(
            wire.restore_skeleton(skel, out)[md.MSG_ARG_KEY_MODEL_PARAMS])
        new_global, self.server_state = self.algorithm.server_update(
            self.global_vars, self.server_state, agg, round_idx)
        if self.trust is not None:
            # central DP alone streams: its finalize hook fires once here, on
            # the aggregate the fold produced, with the round's draws
            new_global = self.trust.on_after_aggregation(new_global, self.global_vars, round_idx)
        self.global_vars = new_global
        self.finalize_time_s = time.perf_counter() - t0
        self._reset_round()
        return self.global_vars

    def _reset_round(self) -> None:
        self.model_dict.clear()
        self.sample_num_dict.clear()
        self.flag_client_model_uploaded.clear()
        self._stream_acc = None
        self._stream_w = self._stream_w_delta = 0.0
        self._stream_folded = 0
        # the global changed: its host copy and the fold's base are stale
        self._np_global = None
        self._stream_tmpl = None

    # -- recovery-journal state (cross_silo/journal.py) ----------------------
    def model_state(self) -> dict:
        """The round-resumable model tree: the global variables and the
        algorithm's server state."""
        return {"global_vars": self.global_vars, "server_state": self.server_state}

    def restore_model_state(self, state: dict) -> None:
        """Install a journaled :meth:`model_state` on the server's device."""
        self.global_vars = tree_to_device(state["global_vars"], self.device)
        self.server_state = tree_to_device(state["server_state"], self.device)
        self._np_global = None
        self._stream_tmpl = None

    def export_stream_state(self) -> tuple[dict, dict]:
        """``(protocol JSON, named arrays)`` of the streaming fold for the
        journal: empty at a round boundary, the partial sums (host f32,
        flax layout) mid-round.  Dense-buffered fallbacks are not listed
        among the folded clients: a resumed round collects them again."""
        proto = {
            "stream_w": float(self._stream_w),
            "stream_w_delta": float(self._stream_w_delta),
            "stream_folded": int(self._stream_folded),
            "stream_samples": {str(k): float(v) for k, v in sorted(self.sample_num_dict.items())},
            "stream_clients": sorted(set(self.flag_client_model_uploaded) - set(self.model_dict)),
        }
        sums = self._stream_acc.host_sums() if self._stream_acc is not None else []
        return proto, {f"stream_sum_{i}": a for i, a in enumerate(sums)}

    def restore_stream_state(self, proto: dict, arrays: dict) -> None:
        """Inverse of :meth:`export_stream_state`, after
        :meth:`restore_model_state`; the folded clients count as received,
        so the resumed round neither asks them again nor folds a resend."""
        if not proto.get("stream_folded"):
            return
        tmpl, _ = self._stream_template()
        try:
            sums = [np.asarray(arrays[f"stream_sum_{i}"], np.float32) for i in range(len(tmpl))]
        except KeyError:
            log.warning("journal: streaming partials incomplete; restarting the fold empty")
            return
        from ..parallel.stream_fold import DeviceStreamAccumulator

        self._stream_acc = DeviceStreamAccumulator(tmpl, self.device, sums=sums)
        self._stream_w = float(proto.get("stream_w", 0.0))
        self._stream_w_delta = float(proto.get("stream_w_delta", 0.0))
        self._stream_folded = int(proto.get("stream_folded", 0))
        for k, v in (proto.get("stream_samples") or {}).items():
            self.sample_num_dict[int(k)] = float(v)
        for c in proto.get("stream_clients") or []:
            self.flag_client_model_uploaded[int(c)] = True

    def round_metrics(self) -> dict:
        """Extra history fields of the round just aggregated: under the
        streaming fold, the host seconds of its folds and its finalize."""
        if not self.stream_mode:
            return {}
        out = {"fold_time_s": self.fold_time_s, "finalize_time_s": self.finalize_time_s}
        self.fold_time_s = self.finalize_time_s = 0.0
        return out

    def test_on_server(self) -> dict:
        return {k: float(v) for k, v in self._eval_fn(self.global_vars, *self._test).items()}

    def client_selection(self, round_idx: int, client_ids: list[int], per_round: int) -> list[int]:
        """Reference ``client_selection``: everyone when all fit, else the
        reference's round-seeded numpy choice."""
        if per_round >= len(client_ids):
            return list(client_ids)
        idx = rng.sample_clients_np(round_idx, len(client_ids), per_round)
        return [client_ids[i] for i in idx]


class FedMLServerManager(FedMLCommManager):
    #: a subclass whose recovery needs its own state first recovers at the
    #: end of its own ``__init__``
    _journal_recover_deferred = False
    #: whether ``finish`` waits for the timer thread to stop; False where
    #: ``finish`` can run under ``_agg_lock``, which a timer may be waiting on
    _join_runtime_on_finish = True

    def __init__(self, cfg, aggregator: FedMLAggregator, backend: Optional[str] = None,
                 logger: Optional[MetricsLogger] = None, secure: Optional[str] = None):
        refuse_unported_server(cfg, secure=secure)
        super().__init__(cfg, rank=0, size=cfg.client_num_in_total + 1, backend=backend)
        from .journal import journal_from_config
        from .runtime import ServerRuntime

        self.aggregator = aggregator
        self.round_idx = 0
        self.comm_round = cfg.comm_round
        self.client_ids = list(range(1, cfg.client_num_in_total + 1))
        self.per_round = min(cfg.client_num_per_round, len(self.client_ids))
        self.active_clients: set[int] = set()
        self.selected: list[int] = []
        # the aggregation tree (cross_silo/edge.py): dispatch goes to the
        # root's child aggregators and their tagged partials fold here; None
        # (the hier flags unset) is the flat protocol, its bytes unchanged
        from .edge import build_topology

        self.topology = build_topology(cfg)
        #: the tree's edge managers of the in-process group (``cross_silo.
        #: build_process_group`` sets them; started and stopped with the group)
        self.edges: list = []
        #: wire bytes of the model uploads that reached this server (partials
        #: under the tree), cumulative
        self.upload_ingress_bytes = 0
        self.done = threading.Event()
        self.history: list[dict] = []
        self.logger = logger or MetricsLogger(cfg.metrics_jsonl_path or None)
        self.straggler_timeout = float(cfg_extra(cfg, "straggler_timeout_s") or 0)
        self.quorum_frac = float(cfg_extra(cfg, "straggler_quorum_frac") or 0.5)
        self._runtime = ServerRuntime()
        self._agg_lock = threading.Lock()
        self._init_sent = False
        #: why the run cannot make progress; run_until_done raises with it
        self.failed: Optional[str] = None
        self._error: Optional[BaseException] = None
        self._round_t0 = 0.0
        self._round_payload_bytes = 0
        # recovery journal (extra.server_journal_dir): None = the journal-free
        # protocol, no epoch stamped
        self.journal = journal_from_config(cfg)
        # model publication for the serving fleet (extra.model_publish_dir):
        # None = no publish writes
        from ..serving.publisher import publisher_from_config

        self.publisher = publisher_from_config(cfg)
        self.session_epoch = 0
        #: the journal step this server resumed from (None: a fresh start)
        self.recovered_step: Optional[int] = None
        self.rejected_stale = 0
        self._journal_every = max(1, int(cfg_extra(cfg, "server_journal_every_rounds"))) \
            if self.journal else 1
        # exactly-once uploads: the recently folded idempotence keys per
        # client (journaled) and the dedup count
        self._folded_keys: dict[int, deque] = {}
        self.deduped_uploads = 0
        self._journal_every_folds = max(0, int(cfg_extra(cfg, "server_journal_every_folds"))) \
            if self.journal else 0
        self._last_model_step: Optional[int] = None
        if not type(self)._journal_recover_deferred:
            self._journal_recover()

    # -- protocol ------------------------------------------------------------
    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(md.MSG_TYPE_C2S_CLIENT_STATUS,
                                              self.handle_message_client_status)
        self.register_message_receive_handler(md.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER,
                                              self.handle_message_receive_model)
        self.register_message_receive_handler(md.MSG_TYPE_C2S_FINISHED,
                                              self.handle_message_client_finished)

    def receive_message(self, msg_type: int, msg: Message) -> None:
        try:
            super().receive_message(msg_type, msg)
        except OSError:
            raise  # a transport fault: the receive loop contains it
        except Exception as e:
            self.abort(f"handler of message type {msg_type} raised {e!r}", e)
            raise

    def abort(self, reason: str, error: Optional[BaseException] = None) -> None:
        """Fail the run now: record why, tell the clients to finish, wake
        ``run_until_done`` (which raises).  Client managers call it when
        their own handler raises."""
        if self.done.is_set():
            return
        log.error("cross-silo run failed: %s", reason)
        self.failed, self._error = reason, error
        self.send_finish()

    def _send_best_effort(self, msg: Message, what: str) -> None:
        """A send whose transport failure is logged, not raised: one
        unreachable peer must not stop the others' messages (status
        re-probes and the straggler timer recover it)."""
        try:
            self.send_message(msg)
        except OSError:
            log.warning("%s to client %d failed", what, msg.get_receiver_id(), exc_info=True)

    def start(self) -> None:
        """Ask every client for status; a re-probe timer retries the ranks
        still missing."""
        for cid in self.client_ids:
            self._send_best_effort(Message(md.MSG_TYPE_S2C_CHECK_CLIENT_STATUS, 0, cid),
                                   "status probe")
        self._arm_status_reprobe()

    def _arm_status_reprobe(self, attempt: int = 0) -> None:
        self._runtime.arm(
            self, "status_probe",
            backoff_delay(attempt, base=0.1, cap=1.0, purpose=BACKOFF_PURPOSE_STATUS_PROBE),
            lambda: self._on_status_reprobe(attempt))

    def _on_status_reprobe(self, attempt: int = 0) -> None:
        with self._agg_lock:
            if self._init_sent or self.done.is_set():
                return
            missing = [c for c in self.client_ids if c not in self.active_clients]
        for cid in missing:
            self._send_best_effort(Message(md.MSG_TYPE_S2C_CHECK_CLIENT_STATUS, 0, cid),
                                   "status re-probe")
        self._arm_status_reprobe(attempt + 1)

    def handle_message_client_status(self, msg: Message) -> None:
        with self._agg_lock:
            if msg.get(md.MSG_ARG_KEY_CLIENT_STATUS) == md.CLIENT_STATUS_ONLINE:
                self.active_clients.add(msg.get_sender_id())
            ready = len(self.active_clients) == len(self.client_ids)
        if ready:
            self.send_init_msg()

    def send_init_msg(self) -> None:
        """Global model + per-client index to every selected client, once.
        A recovered server enters here at the interrupted round and issues
        it again under its new epoch (or finishes, when the crash came after
        the last round's snapshot)."""
        with self._agg_lock:
            if self._init_sent:
                return
            self._init_sent = True
            if self.round_idx >= self.comm_round:
                self.send_finish()
                return
            # bootstrap publication: serving workers can come up on the
            # initial (or journal-recovered) global before round 1 closes
            self._publish_model()
            self._broadcast_model(md.MSG_TYPE_S2C_INIT_CONFIG)

    def handle_message_receive_model(self, msg: Message) -> None:
        with self._agg_lock:
            sender = int(msg.get_sender_id())
            # exactly-once: a key already folded is a redelivery (a chaos
            # duplicate, a reconnect resend, a resend after a client crash),
            # dropped before any other gate, since the journaled key table
            # outlives the round and a server crash
            upload_key = msg.get_control(md.MSG_ARG_KEY_UPLOAD_KEY)
            if upload_key is not None and self._is_duplicate_upload(sender, upload_key):
                self.deduped_uploads += 1
                return
            if self.journal is not None:
                # the session-epoch fence: work of a pre-crash dispatch is
                # redone under the new epoch, so its old reply is rejected
                epoch = int(msg.get_control(md.MSG_ARG_KEY_SESSION_EPOCH, self.session_epoch))
                if epoch != self.session_epoch:
                    self.rejected_stale += 1
                    log.info("rejecting stale-epoch upload from client %s (epoch %d, current "
                             "%d)", sender, epoch, self.session_epoch)
                    return
            if msg.get(md.MSG_ARG_KEY_ROUND_INDEX) != self.round_idx:
                return  # stale round (post-timeout arrival)
            self._round_payload_bytes += int(msg.wire_nbytes)
            self.upload_ingress_bytes += int(msg.wire_nbytes)
            hier_tag = msg.get_control(md.MSG_ARG_KEY_HIER_PARTIAL)
            if hier_tag is not None:
                # one pre-folded partial stands in for an edge's subtree
                if not self.aggregator.fold_partial(msg, hier_tag.get("sources") or {},
                                                    float(hier_tag.get("w_delta", 0.0))):
                    log.warning("dropping an unfoldable edge partial from %d (round %d)",
                                sender, self.round_idx)
                    return
            else:
                self._ingest_upload(msg, sender)
            self._note_upload_key(sender, upload_key)
            folded = self.aggregator._stream_folded
            if self._journal_every_folds and folded and folded % self._journal_every_folds == 0:
                self._journal_midround_snapshot()
            if self.aggregator.check_whether_all_receive(len(self.selected)):
                self._finish_round()

    def _ingest_upload(self, msg: Message, sender: int) -> None:
        """One client's reply: the streaming fold, else the dense buffer."""
        n_samples = float(msg.get(md.MSG_ARG_KEY_NUM_SAMPLES))
        # control-only read: a plain get() of the absent key would restore
        # the tensors and demote the streaming fold to the dense buffer
        is_delta = bool(msg.get_control(md.MSG_ARG_KEY_MODEL_IS_DELTA, False))
        if not self.aggregator.ingest_streaming(sender, msg, n_samples, is_delta):
            self.aggregator.add_local_trained_result(
                sender, msg.get(md.MSG_ARG_KEY_MODEL_PARAMS), n_samples, is_delta=is_delta)

    def _arm_straggler_timer(self) -> None:
        if self.straggler_timeout <= 0:
            return
        self._runtime.arm(self, "straggler", self.straggler_timeout, self._on_straggler_timeout)

    def _on_straggler_timeout(self) -> None:
        with self._agg_lock:
            need = max(1, int(math.ceil(self.quorum_frac * len(self.selected))))
            if self.aggregator.received_count() >= need:
                log.warning("round %d: straggler timeout, aggregating %d/%d clients",
                            self.round_idx, self.aggregator.received_count(), len(self.selected))
                self._finish_round()
            else:
                self._arm_straggler_timer()  # keep waiting for quorum

    def _finish_round(self) -> None:
        """Aggregate, evaluate, journal, then sync the next round or finish.
        Caller holds _agg_lock."""
        self._runtime.cancel(self, "straggler")
        t0 = time.perf_counter()
        self.aggregator.aggregate(self.round_idx)
        metrics = {"round": self.round_idx, **self.aggregator.round_metrics()}
        if self.cfg.frequency_of_the_test and (
            (self.round_idx + 1) % self.cfg.frequency_of_the_test == 0
            or self.round_idx == self.comm_round - 1
        ):
            metrics.update(self.aggregator.test_on_server())
        if self.aggregator.device.type == "cuda":
            torch.cuda.synchronize(self.aggregator.device)
        end = time.perf_counter()
        metrics.update(round_time_s=end - self._round_t0, aggregate_time_s=end - t0,
                       upload_bytes=self._round_payload_bytes)
        self.logger.log(metrics)
        self.history.append(metrics)
        self.round_idx += 1
        self._journal_snapshot()
        self._publish_model()
        if self.round_idx >= self.comm_round:
            self.send_finish()
            return
        self._broadcast_model(md.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT)

    def _publish_model(self) -> None:
        """Publish the current global as version ``round_idx`` (the async
        server mirrors its version into ``round_idx`` at every bump, so one
        site serves both servers).  Best effort, as the reference's:
        ``ModelPublisher.publish`` logs and skips a failed write.  Caller
        holds _agg_lock."""
        if self.publisher is None:
            return
        self.publisher.publish(
            self.round_idx, self.aggregator._host_global(),
            meta={"model": self.cfg.model,
                  "run_id": str(getattr(self.cfg, "run_id", "0")),
                  "session_epoch": self.session_epoch})

    def _broadcast_model(self, msg_type: int) -> None:
        """Select clients, send them the global model, arm the straggler
        timer.  A client whose fold a mid-round journal kept stays selected
        but is not asked again.  Caller holds _agg_lock."""
        self.selected = self.aggregator.client_selection(
            self.round_idx, self.client_ids, self.per_round)
        self._round_t0 = time.perf_counter()
        self._round_payload_bytes = 0
        params = self.aggregator.host_global_flax()
        if self.topology is not None:
            self._broadcast_model_hier(msg_type, params)
            return
        for cid in self.selected:
            if self.aggregator.has_received(cid):
                continue
            msg = Message(msg_type, 0, cid)
            msg.add_params(md.MSG_ARG_KEY_MODEL_PARAMS, params)
            msg.add_params(md.MSG_ARG_KEY_CLIENT_INDEX, cid - 1)
            msg.add_params(md.MSG_ARG_KEY_ROUND_INDEX, self.round_idx)
            if self.journal is not None:
                # clients echo the epoch, so a restarted server can tell
                # pre-crash work from current work
                msg.add_params(md.MSG_ARG_KEY_SESSION_EPOCH, self.session_epoch)
            self._send_best_effort(msg, "broadcast")
        self._arm_straggler_timer()

    def _broadcast_model_hier(self, msg_type: int, params) -> None:
        """The tree's dispatch: one message per child aggregator of the root,
        the global and that subtree's plan (``MSG_ARG_KEY_HIER_CHILDREN``);
        clients whose fold a journal kept are left out of the plan.  Caller
        holds _agg_lock."""
        skip = [cid for cid in self.selected if self.aggregator.has_received(cid)]
        for agg_rank, spec in sorted(self.topology.dispatch_plan(self.selected,
                                                                 skip=skip).items()):
            msg = Message(msg_type, 0, agg_rank)
            msg.add_params(md.MSG_ARG_KEY_MODEL_PARAMS, params)
            msg.add_params(md.MSG_ARG_KEY_ROUND_INDEX, self.round_idx)
            msg.add_params(md.MSG_ARG_KEY_HIER_CHILDREN, spec)
            if self.journal is not None:
                msg.add_params(md.MSG_ARG_KEY_SESSION_EPOCH, self.session_epoch)
            self._send_best_effort(msg, "hier dispatch")
        self._arm_straggler_timer()

    # -- exactly-once upload dedup ---------------------------------------------
    def _is_duplicate_upload(self, sender: int, key: str) -> bool:
        dq = self._folded_keys.get(sender)
        return dq is not None and key in dq

    def _note_upload_key(self, sender: int, key: Optional[str]) -> None:
        if key is None:
            return
        dq = self._folded_keys.get(sender)
        if dq is None:
            dq = self._folded_keys[sender] = deque(maxlen=DEDUP_KEYS_PER_CLIENT)
        dq.append(key)

    def _export_folded_keys(self) -> dict:
        return {str(c): list(dq) for c, dq in sorted(self._folded_keys.items())}

    def _restore_folded_keys(self, proto: dict) -> None:
        for c, keys in (proto.get("folded_keys") or {}).items():
            self._folded_keys[int(c)] = deque([str(k) for k in keys],
                                              maxlen=DEDUP_KEYS_PER_CLIENT)
        self.deduped_uploads = int(proto.get("deduped", 0))

    # -- recovery journal -------------------------------------------------------
    def _journal_recover(self) -> None:
        """Install the newest intact snapshot at construction: round index,
        model and server state, streaming partials (a mid-round snapshot
        resumes its round), the dedup table; the session epoch goes up by
        one."""
        if self.journal is None:
            return
        snap = self.journal.restore()
        if snap is None:
            return
        proto = snap["protocol"]
        self.session_epoch = int(proto.get("session_epoch", 0)) + 1
        self.round_idx = int(proto.get("round_idx", 0))
        self.recovered_step = int(snap["step"])
        self._last_model_step = snap.get("model_step")
        if snap["model"] is not None:
            self.aggregator.restore_model_state(snap["model"])
        self.aggregator.restore_stream_state(proto, snap["arrays"])
        self._restore_folded_keys(proto)
        log.info("recovered from journal step %d (round %d, session epoch %d, %d folds carried)",
                 self.recovered_step, self.round_idx, self.session_epoch,
                 self.aggregator._stream_folded)

    def _journal_protocol_state(self) -> dict:
        return {"kind": "sync", "session_epoch": self.session_epoch,
                "round_idx": self.round_idx, "rejected_stale": self.rejected_stale,
                "deduped": self.deduped_uploads, "folded_keys": self._export_folded_keys(),
                "health": {}}

    def _journal_snapshot(self) -> None:
        """Commit the protocol state at a round boundary (every
        ``server_journal_every_rounds``, and the final round).  Caller
        holds _agg_lock."""
        if self.journal is None:
            return
        step = self.round_idx
        if (step % self._journal_every) and step < self.comm_round:
            return
        stream_proto, arrays = self.aggregator.export_stream_state()
        self.journal.snapshot(step, {**self._journal_protocol_state(), **stream_proto}, arrays,
                              model_state=self.aggregator.model_state())
        self._last_model_step = step

    def _journal_midround_snapshot(self) -> None:
        """Commit the round's partial streaming fold; the sidecar names the
        boundary step whose model holds the round's starting global."""
        stream_proto, arrays = self.aggregator.export_stream_state()
        self.journal.snapshot(self.round_idx, {**self._journal_protocol_state(), **stream_proto},
                              arrays, model_step=self._last_model_step)

    def hard_kill(self) -> None:
        """Crash simulation: stop the receive loop and the timers at once,
        with no FINISH, no journal write, no teardown; what the journal does
        not hold is lost, as under SIGKILL."""
        self._runtime.cancel(self)
        self.com_manager.stop_receive_message()

    def send_finish(self) -> None:
        # the tree's aggregators stop on the same broadcast
        ranks = self.client_ids + (self.topology.aggregator_ranks if self.topology else [])
        for cid in ranks:
            self._send_best_effort(Message(md.MSG_TYPE_S2C_FINISH, 0, cid), "FINISH")
        self.done.set()
        self._prune_retired_client_journals()
        self.finish()

    def _prune_retired_client_journals(self) -> None:
        """Reclaim the journal directories of clients no longer in the fleet
        (``client_journal_keep_retired`` kept); a failure costs nothing."""
        root = cfg_extra(self.cfg, "client_journal_dir")
        if not root:
            return
        from .client_journal import prune_retired_client_dirs

        try:
            prune_retired_client_dirs(root, self.client_ids,
                                      keep=int(cfg_extra(self.cfg, "client_journal_keep_retired")))
        except Exception:
            log.warning("retired-client journal prune failed", exc_info=True)

    def handle_message_client_finished(self, msg: Message) -> None:
        pass  # bookkeeping only

    def finish(self) -> None:
        self._runtime.cancel(self)
        super().finish()
        self._runtime.close(wait=self._join_runtime_on_finish)

    def run_until_done(self, timeout: float = 600.0) -> list[dict]:
        thread = self.run_in_thread()
        self.start()
        if not self.done.wait(timeout):
            self.finish()
            raise TimeoutError(f"cross-silo run did not finish in {timeout}s "
                               f"(round {self.round_idx})")
        thread.join(timeout=5.0)
        if self.failed:
            raise RuntimeError(f"cross-silo run failed: {self.failed}") from self._error
        return self.history
