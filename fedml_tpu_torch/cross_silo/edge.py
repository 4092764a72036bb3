"""The hierarchical aggregation tree: edge aggregators over the plain
protocol (the port of ``fedml_tpu/cross_silo/edge.py``).

::

    client -> edge aggregator -> (optional region) -> root

- :func:`build_topology` turns ``extra.hier_fanout`` / ``extra.hier_depth``
  (or an explicit ``extra.hier_topology``) into a :class:`HierTopology`, a
  pure rank map the root (dispatch routing), every client (upload
  destination) and the edges share.  Flags unset: None, and every party
  runs the flat protocol, its bytes unchanged.
- :class:`EdgeAggregatorManager` is a server-shaped relay on the same
  message types: it re-dispatches the global down its subtree, folds its
  children's model replies as they land (the running sum and one decode:
  peak buffered <= 2) and ships one pre-folded weighted partial upward,
  tagged ``MSG_ARG_KEY_HIER_PARTIAL`` with the folded sample mass.  The
  root's fan-in drops from O(clients) uploads to O(edges) partials.
- :class:`EdgePartialFold` is the fold itself, without a transport, so the
  bitwise pins and the simulator bridge (``sim/hierarchical.py``'s
  ``segment_group_sums``) can drive it.

The fold runs on the edge's device: a child's wire leaf is decoded there
(``parallel/stream_fold.decode_leaf``: a ``qsgd8`` leaf through the
dequantize kernel) and folded as ``sums[i] += f32(w) * x``, the root's op
sequence; a child partial (a region's child edge) is a direct add
(``fold_partial_leaf``), no unit-weight multiply.  So the tree runs no
arithmetic the flat fold does not: a prefix tree under a fixed arrival
order, or exactly representable payloads, fold bitwise the flat fold.

``extra.hier_hop_codec`` (``qsgd8`` | ``topk``) re-encodes the shipped
partial (``comm/codecs.compress_pytree`` on the edge's device, qsgd8
through the quantize kernel), so the edge-to-root hop costs compressed
bytes; the partial is a weighted sum of the children's payloads (deltas
under a client codec), and the root adds the round's base back at
finalize from the tag's ``w_delta``.  The codec's draw is keyed
``fold_in(root_key(0), leaf)`` as the reference keys it; a
``hop_noise(round, rank, leaf, shape, device)`` hook on the manager can
supply it instead.

A killed edge recovers from its own ``ServerJournal`` under
``<server_journal_dir>/edge_<rank>`` (partial sums and the wire template in
the sidecar: no model is needed to restore) and drains the child uploads
that queued while it was dead; the journaled upload keys dedup the ones the
partial already holds.

The reference's hop metrics (its registry), health ledger and flight
recorder are not ported: ``folds``, ``relays``, ``deduped_uploads``,
``partials_sent`` and ``upload_ingress_bytes`` are plain attributes.  The
reference starts edges only inside its in-process group, so the port does
too (``cross_silo/__init__.py``): the tree has no role of its own.
"""

from __future__ import annotations

import logging
import math
import os
import threading
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from ..comm import codecs, wire
from ..comm.comm_manager import FedMLCommManager
from ..comm.message import Message
from ..core.flags import cfg_extra
from ..sched.seq_scheduler import round_robin_groups
from . import message_define as md

log = logging.getLogger("fedml_tpu_torch.cross_silo.edge")

__all__ = ["EdgeAggregatorManager", "EdgePartialFold", "HierTopology", "build_topology",
           "edge_fold_supported", "hop_codec_from_config", "round_robin_groups"]

#: idempotence keys remembered per child at an aggregator (the root's bound)
DEDUP_KEYS_PER_CHILD = 16

_VALID_HOP_CODECS = ("qsgd8", "topk")

#: the message that names what ``hier_*`` flags need (the reference starts
#: edges only in its in-process group)
EDGES_IN_PROCESS_ONLY = (
    "the aggregation tree (extra.hier_fanout / hier_topology) runs its edge aggregators "
    "inside the in-process group alone (role 'server' over INPROC, or TCP with "
    "tcp_base_port 0), as the reference does; a server or silo process of its own would "
    "wait for edges no process starts")


class HierTopology:
    """The aggregation tree over the cross-silo rank space: root 0, clients
    1..N, edges N+1..N+E, regions (depth 3) N+E+1..N+E+R.  ``edges`` are
    client-rank groups (each client in one); ``regions`` optionally group
    edge ordinals (0-based into ``edges``)."""

    def __init__(self, n_clients: int, edges: list, regions: Optional[list] = None):
        n = int(n_clients)
        groups = [[int(c) for c in grp] for grp in edges]
        if any(not grp for grp in groups):
            raise ValueError("hier topology: empty edge group")
        flat = sorted(c for grp in groups for c in grp)
        if flat != list(range(1, n + 1)):
            raise ValueError(f"hier topology: edge groups must partition client ranks "
                             f"1..{n} exactly once (got {flat})")
        self.n_clients = n
        n_edges = len(groups)
        self.edge_ranks = [n + 1 + i for i in range(n_edges)]
        self.children_of: dict[int, list[int]] = {
            self.edge_ranks[i]: groups[i] for i in range(n_edges)}
        self.parent_of: dict[int, int] = {}
        for i, grp in enumerate(groups):
            for c in grp:
                self.parent_of[c] = self.edge_ranks[i]
        self.region_ranks: list[int] = []
        if regions:
            rgroups = [[int(o) for o in grp] for grp in regions]
            if any(not grp for grp in rgroups):
                raise ValueError("hier topology: empty region group")
            ords = sorted(o for grp in rgroups for o in grp)
            if ords != list(range(n_edges)):
                raise ValueError(f"hier topology: region groups must partition edge "
                                 f"ordinals 0..{n_edges - 1} exactly once (got {ords})")
            base = n + 1 + n_edges
            self.region_ranks = [base + j for j in range(len(rgroups))]
            for j, grp in enumerate(rgroups):
                members = [self.edge_ranks[o] for o in grp]
                self.children_of[self.region_ranks[j]] = members
                for m in members:
                    self.parent_of[m] = self.region_ranks[j]
            for r in self.region_ranks:
                self.parent_of[r] = 0
        else:
            for e in self.edge_ranks:
                self.parent_of[e] = 0
        self.aggregator_ranks = self.edge_ranks + self.region_ranks
        #: the root's direct children: O(edges) where the flat root had O(clients)
        self.root_children = list(self.region_ranks or self.edge_ranks)
        self.depth = 3 if self.region_ranks else 2
        # 0-based client index -> edge ordinal (the simulator's group map)
        g = np.empty(n, np.int32)
        for i, grp in enumerate(groups):
            for c in grp:
                g[c - 1] = i
        self.group_of = g
        self.world_size = 1 + n + len(self.aggregator_ranks)

    def parent(self, rank: int) -> int:
        """Upload destination of ``rank`` (0 for the root's children and for
        an unknown rank: the flat default)."""
        return self.parent_of.get(int(rank), 0)

    def max_fanout(self) -> int:
        return max([len(self.root_children)] + [len(v) for v in self.children_of.values()])

    def dispatch_plan(self, selected, skip=()) -> dict:
        """One round's dispatch routed down the tree: ``{root child rank:
        spec}`` over ``selected`` less ``skip`` (clients whose fold the root
        already holds).  Edge spec ``{"clients": {rank: client_index}}``,
        region spec ``{"aggs": {edge_rank: edge_spec}}``, string keys (the
        spec rides the JSON control section); an aggregator with no wanted
        client is left out."""
        drop = set(int(s) for s in skip)
        per_edge: dict[int, dict] = {}
        for c in selected:
            c = int(c)
            if c in drop:
                continue
            e = self.parent_of[c]
            per_edge.setdefault(e, {"clients": {}})["clients"][str(c)] = c - 1
        if not self.region_ranks:
            return per_edge
        plan: dict[int, dict] = {}
        for e, spec in per_edge.items():
            plan.setdefault(self.parent_of[e], {"aggs": {}})["aggs"][str(e)] = spec
        return plan


def build_topology(cfg) -> Optional[HierTopology]:
    """``extra.hier_*`` -> :class:`HierTopology`, or None when unset.  From
    ``hier_fanout``: ``ceil(N / fanout)`` edges of round-robin membership,
    and at ``hier_depth`` 3 one more round-robin tier of regions;
    ``hier_topology`` (``{"edges": [...], "regions": [...]}``) overrides."""
    explicit = cfg_extra(cfg, "hier_topology")
    fanout = int(cfg_extra(cfg, "hier_fanout") or 0)
    if not explicit and fanout <= 0:
        return None
    if getattr(cfg, "enable_secagg", False) or getattr(cfg, "enable_fhe", False):
        raise NotImplementedError(
            "hierarchical aggregation does not compose with the secure-aggregation/FHE "
            "protocols (the reference's per-cohort SecAgg partial folds do not exist yet); "
            "unset hier_fanout/hier_topology for these modes")
    n = int(cfg.client_num_in_total)
    if explicit:
        return HierTopology(n, explicit["edges"], explicit.get("regions"))
    depth = int(cfg_extra(cfg, "hier_depth") or 2)
    if depth not in (2, 3):
        raise ValueError(f"hier_depth must be 2 or 3, got {depth}")
    n_edges = max(1, math.ceil(n / fanout))
    g = round_robin_groups(n, n_edges)
    edges = [[i + 1 for i in range(n) if g[i] == e] for e in range(n_edges)]
    regions = None
    if depth == 3:
        n_regions = max(1, math.ceil(n_edges / fanout))
        rg = round_robin_groups(n_edges, n_regions)
        regions = [[e for e in range(n_edges) if rg[e] == r] for r in range(n_regions)]
    return HierTopology(n, edges, regions)


def hop_codec_from_config(cfg) -> Optional[str]:
    """``extra.hier_hop_codec`` -> the codec name, or None (the raw f32
    partial: the hop that keeps the tree fold bitwise the flat fold)."""
    name = str(cfg_extra(cfg, "hier_hop_codec") or "").strip().lower()
    if name in ("", "no", "off", "none", "raw"):
        return None
    if name not in _VALID_HOP_CODECS:
        raise ValueError(f"unknown hier_hop_codec {name!r}; known: {_VALID_HOP_CODECS}")
    return name


def edge_fold_supported(cfg) -> bool:
    """Whether aggregators may fold child uploads for ``cfg``: the root's
    streaming-fold gate (``FedMLAggregator.stream_mode``) without a model.
    False: every aggregator relays child uploads unchanged (the tree then
    thins the root's connections, not its bytes)."""
    if not (codecs.codec_from_config(cfg) or cfg_extra(cfg, "streaming_aggregation")
            or cfg_extra(cfg, "async_aggregation")):
        return False
    from ..trust.pipeline import build_trust_pipeline

    trust = build_trust_pipeline(cfg)
    if trust is not None and not trust.supports_streaming():
        return False
    from ..fl.algorithm import config_supports_associative_fold

    return config_supports_associative_fold(cfg)


class EdgePartialFold:
    """One aggregator's fold of a round on ``device``: the dispatched
    global's wire template (host numpy, flax layout), the running f32 sums,
    the folded masses and sources.  Peak buffered: the sum and one decode."""

    def __init__(self, host_global_tree=None, *, template: Optional[list] = None,
                 skeleton=None, sums: Optional[list] = None, device="cpu"):
        if template is None:
            skeleton, leaves = wire.flatten_with_skeleton(
                {md.MSG_ARG_KEY_MODEL_PARAMS: host_global_tree})
            template = [np.asarray(leaf) for leaf in leaves]
        self.tmpl = template
        self.skel = skeleton
        self.device = torch.device(device)
        self._acc = None
        if sums is not None:
            from ..parallel.stream_fold import DeviceStreamAccumulator

            self._acc = DeviceStreamAccumulator(self.tmpl, self.device, sums=sums)
        self.w = 0.0
        self.w_delta = 0.0
        self.sources: dict[int, float] = {}
        self.folded = 0
        self.peak_buffered = 0

    def _admit(self, msg):
        """The message's still-undecoded leaf segments when its frame
        matches the template, else None (the caller relays instead)."""
        frame = msg.tensor_segments() if hasattr(msg, "tensor_segments") else None
        if frame is None:
            return None
        header, segments = frame
        specs = header["leaves"]
        if header["treedef"] != self.skel or len(specs) != len(self.tmpl):
            return None
        for spec, t in zip(specs, self.tmpl):
            if tuple(spec["shape"]) != t.shape:
                return None
        return segments

    def _ensure_acc(self):
        if self._acc is None:
            from ..parallel.stream_fold import DeviceStreamAccumulator

            self._acc = DeviceStreamAccumulator(self.tmpl, self.device)
        # buffered now: the running sum (once a fold landed) and this decode
        self.peak_buffered = max(self.peak_buffered, (1 if self.folded else 0) + 1)

    def fold_child(self, child_rank: int, msg, sample_num: float, is_delta: bool) -> bool:
        """Fold one child model reply with weight ``sample_num``, leaf by leaf
        off the undecoded frame (the root fold's arithmetic).  False: the
        structure differs, relay it."""
        segments = self._admit(msg)
        if segments is None:
            return False
        from ..parallel.stream_fold import decode_leaf

        self._ensure_acc()
        w = float(sample_num)
        w32 = self._acc.scalar(w)
        for i, spec, segs in segments:
            self._acc.fold_leaf(i, w32, decode_leaf(spec, segs, self.device))
        self.w += w
        if is_delta:
            self.w_delta += w
        self.sources[int(child_rank)] = w
        self.folded += 1
        return True

    def fold_partial(self, msg, sources: dict, w_delta: float) -> bool:
        """Merge a child aggregator's partial with direct adds; ``sources``
        (client rank -> folded weight, string keys fine) join this node's
        masses."""
        segments = self._admit(msg)
        if segments is None:
            return False
        from ..parallel.stream_fold import decode_leaf

        self._ensure_acc()
        for i, spec, segs in segments:
            self._acc.fold_partial_leaf(i, decode_leaf(spec, segs, self.device))
        for k, v in sources.items():
            self.sources[int(k)] = float(v)
            self.w += float(v)
        self.w_delta += float(w_delta)
        self.folded += 1
        return True

    def partial_tree(self, on_device: bool = False):
        """The accumulated sums in the model's tree shape (f32 leaves): host
        numpy (the raw hop's payload), or the tensors on the device
        (``on_device``, for the hop codec)."""
        if self._acc is None:
            sums = [np.zeros(np.shape(t), np.float32) for t in self.tmpl]
        else:
            sums = self._acc.sums() if on_device else self._acc.host_sums()
        return wire.restore_skeleton(self.skel, sums)[md.MSG_ARG_KEY_MODEL_PARAMS]

    def control_tag(self) -> dict:
        """The ``MSG_ARG_KEY_HIER_PARTIAL`` payload (string keys: it rides the
        JSON section)."""
        return {"sources": {str(k): float(v) for k, v in sorted(self.sources.items())},
                "w_delta": float(self.w_delta)}

    def export_state(self) -> tuple[dict, dict]:
        """``(protocol JSON, named arrays)`` for the edge journal: the
        template leaves ride with the partial sums, so a restarted edge
        restores without a model."""
        proto = {"skel": self.skel, "w": float(self.w), "w_delta": float(self.w_delta),
                 "folded": int(self.folded), "peak": int(self.peak_buffered),
                 "sources": {str(k): float(v) for k, v in sorted(self.sources.items())}}
        arrays = {f"tmpl_{i}": t for i, t in enumerate(self.tmpl)}
        if self._acc is not None:
            for i, s in enumerate(self._acc.host_sums()):
                arrays[f"sum_{i}"] = s
        return proto, arrays

    @classmethod
    def from_state(cls, proto: dict, arrays: dict, device="cpu") -> "EdgePartialFold":
        tmpl = []
        while f"tmpl_{len(tmpl)}" in arrays:
            tmpl.append(np.asarray(arrays[f"tmpl_{len(tmpl)}"]))
        sums = None
        if "sum_0" in arrays:
            sums = [np.asarray(arrays[f"sum_{j}"], np.float32) for j in range(len(tmpl))]
        fold = cls(template=tmpl, skeleton=proto["skel"], sums=sums, device=device)
        fold.w = float(proto.get("w", 0.0))
        fold.w_delta = float(proto.get("w_delta", 0.0))
        fold.folded = int(proto.get("folded", 0))
        fold.peak_buffered = int(proto.get("peak", 0))
        fold.sources = {int(k): float(v) for k, v in (proto.get("sources") or {}).items()}
        return fold


class EdgeAggregatorManager(FedMLCommManager):
    """A server-shaped relay at one tree node (edge or region: the tier
    decides whether its children are clients or aggregators).

    The parent's INIT / SYNC arrives with the global and this node's plan
    (``MSG_ARG_KEY_HIER_CHILDREN``); the node re-dispatches to each child,
    folds their replies as they land (or relays them when the config does
    not fold) and ships one tagged partial upward once every expected child
    is in, or when its straggler timer (half the root's
    ``straggler_timeout_s``) fires with at least one fold.  With
    ``extra.server_journal_dir`` it journals the round after every accepted
    child; a manager rebuilt at the same rank resumes the round."""

    def __init__(self, cfg, topology: HierTopology, rank: int, device="cpu",
                 backend: Optional[str] = None):
        super().__init__(cfg, rank=rank, size=topology.world_size, backend=backend)
        from .runtime import ServerRuntime

        self.topology = topology
        self.parent_rank = topology.parent(rank)
        self.tier = "region" if rank in topology.region_ranks else "edge"
        self.device = torch.device(device)
        self.done = threading.Event()
        self._lock = threading.Lock()
        self._runtime = ServerRuntime()
        self.relay_only = not edge_fold_supported(cfg)
        self.hop_codec = hop_codec_from_config(cfg)
        self._hop_ratio = float(cfg_extra(cfg, "comm_topk_ratio") or 0.01)
        self._hop_residuals = None
        #: ``fn(round, rank, leaf, shape, device)``: the hop codec's uniform
        #: draws in place of the reference's fixed key (module docstring)
        self.hop_noise: Optional[Callable] = None
        #: ``fn(reason, error)`` told when a handler raises (the in-process
        #: group points it at the server's ``abort``)
        self.on_error: Optional[Callable] = None
        self.straggler_timeout = float(cfg_extra(cfg, "straggler_timeout_s") or 0) * 0.5
        # round state, under _lock
        self._fold: Optional[EdgePartialFold] = None
        self._round_idx: Optional[int] = None
        self._epoch = None
        self._expect: dict[int, object] = {}
        self._arrived: set[int] = set()
        self._shipped = False
        self._folded_keys: dict[int, deque] = {}
        self._attempts: dict[str, int] = {}
        self.folds = 0
        self.relays = 0
        self.deduped_uploads = 0
        self.partials_sent = 0
        #: wire bytes of the child uploads that reached this node
        self.upload_ingress_bytes = 0
        self.resumed_from_journal = False
        self.journal = None
        root_dir = cfg_extra(cfg, "server_journal_dir")
        if root_dir:
            from .journal import ServerJournal

            self.journal = ServerJournal(os.path.join(str(root_dir), f"edge_{rank}"),
                                         keep=int(cfg_extra(cfg, "server_journal_keep")))
            self._journal_recover()

    # -- protocol ----------------------------------------------------------------
    def register_message_receive_handlers(self) -> None:
        for t in (md.MSG_TYPE_S2C_INIT_CONFIG, md.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT):
            self.register_message_receive_handler(t, self.handle_message_dispatch)
        self.register_message_receive_handler(md.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER,
                                              self.handle_message_child_upload)
        self.register_message_receive_handler(md.MSG_TYPE_S2C_FINISH, self.handle_message_finish)

    def receive_message(self, msg_type: int, msg: Message) -> None:
        try:
            super().receive_message(msg_type, msg)
        except OSError:
            raise  # a transport fault: the receive loop contains it
        except Exception as e:
            if self.on_error is not None:
                self.on_error(f"edge {self.rank}: handler of message type {msg_type} raised "
                              f"{e!r}", e)
            raise

    def handle_message_dispatch(self, msg: Message) -> None:
        """The parent's dispatch: install the round, relay the global down
        the subtree, arm the straggler timer."""
        with self._lock:
            round_idx = int(msg.get_control(md.MSG_ARG_KEY_ROUND_INDEX))
            epoch = msg.get_control(md.MSG_ARG_KEY_SESSION_EPOCH)
            plan = msg.get_control(md.MSG_ARG_KEY_HIER_CHILDREN) or {}
            same_round = round_idx == self._round_idx and epoch == self._epoch
            if same_round and self._shipped:
                # a duplicate dispatch of a shipped round: re-ship under the
                # same upload key (the parent dedups) instead of redoing it
                self._ship_locked(resend=True)
                return
            if same_round and self._fold is not None and self._fold.folded:
                # a journal-recovered round: ask only the children not folded
                pending = {c: s for c, s in self._expect.items() if c not in self._arrived}
                self._relay_dispatch(msg, pending, round_idx, epoch)
                self._arm_straggler()
                return
            params = msg.get(md.MSG_ARG_KEY_MODEL_PARAMS)
            self._round_idx, self._epoch = round_idx, epoch
            self._expect = self._parse_plan(plan)
            self._arrived = set()
            self._shipped = False
            self._fold = None if self.relay_only else EdgePartialFold(params, device=self.device)
            self._relay_dispatch(msg, self._expect, round_idx, epoch, params=params)
            self._arm_straggler()

    @staticmethod
    def _parse_plan(plan: dict) -> dict:
        """The plan -> ``{child rank: spec}``: a client index at the edge
        tier, the child edge's own plan at a region."""
        if "aggs" in plan:
            return {int(r): spec for r, spec in plan["aggs"].items()}
        return {int(r): int(idx) for r, idx in (plan.get("clients") or {}).items()}

    def _relay_dispatch(self, msg: Message, children: dict, round_idx: int, epoch,
                        params=None) -> None:
        if not children:
            return
        if params is None:
            params = msg.get(md.MSG_ARG_KEY_MODEL_PARAMS)
        for child, spec in sorted(children.items()):
            relay = Message(msg.get_type(), self.rank, child)
            relay.add_params(md.MSG_ARG_KEY_MODEL_PARAMS, params)
            relay.add_params(md.MSG_ARG_KEY_ROUND_INDEX, round_idx)
            if epoch is not None:
                relay.add_params(md.MSG_ARG_KEY_SESSION_EPOCH, int(epoch))
            if self.tier == "region":
                relay.add_params(md.MSG_ARG_KEY_HIER_CHILDREN, spec)
            else:
                relay.add_params(md.MSG_ARG_KEY_CLIENT_INDEX, int(spec))
            try:
                self.send_message(relay)
            except OSError:
                # best effort per child: the straggler timer owns progress
                log.warning("edge %d: dispatch to child %d failed; continuing", self.rank,
                            child, exc_info=True)

    def handle_message_child_upload(self, msg: Message) -> None:
        """One child's reply (or, at a region, a child edge's partial):
        dedup, fold or relay, account, ship when complete; the root's gate
        order."""
        with self._lock:
            sender = int(msg.get_sender_id())
            upload_key = msg.get_control(md.MSG_ARG_KEY_UPLOAD_KEY)
            if upload_key is not None and upload_key in self._folded_keys.get(sender, ()):
                self.deduped_uploads += 1
                return
            if self._round_idx is None or int(
                    msg.get_control(md.MSG_ARG_KEY_ROUND_INDEX, -1)) != self._round_idx:
                return  # stale round
            epoch = msg.get_control(md.MSG_ARG_KEY_SESSION_EPOCH, self._epoch)
            if self._epoch is not None and epoch != self._epoch:
                return  # a pre-restart dispatch's work
            if sender in self._arrived:
                self.deduped_uploads += 1
                return  # a keyless redelivery within the round
            self.upload_ingress_bytes += int(getattr(msg, "wire_nbytes", 0) or 0)
            child_tag = msg.get_control(md.MSG_ARG_KEY_HIER_PARTIAL)
            folded = False
            if self._fold is not None:
                if child_tag is not None:
                    folded = self._fold.fold_partial(msg, child_tag.get("sources") or {},
                                                     float(child_tag.get("w_delta", 0.0)))
                else:
                    folded = self._fold.fold_child(
                        sender, msg, float(msg.get(md.MSG_ARG_KEY_NUM_SAMPLES)),
                        bool(msg.get_control(md.MSG_ARG_KEY_MODEL_IS_DELTA, False)))
                if folded:
                    self.folds += 1
            if not folded:
                self._relay_upload(msg, sender)
            if upload_key is not None:
                self._folded_keys.setdefault(
                    sender, deque(maxlen=DEDUP_KEYS_PER_CHILD)).append(upload_key)
            self._arrived.add(sender)
            self._journal_snapshot_locked()
            if set(self._expect) <= self._arrived:
                self._ship_locked()

    def _relay_upload(self, msg: Message, sender: int) -> None:
        """Forward one child upload unchanged to the parent, the child kept
        as the wire sender (the fallback of every config the fold does not
        cover)."""
        fwd = Message(md.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER, sender, self.parent_rank)
        fwd.add_params(md.MSG_ARG_KEY_MODEL_PARAMS, msg.get(md.MSG_ARG_KEY_MODEL_PARAMS))
        for key in (md.MSG_ARG_KEY_NUM_SAMPLES, md.MSG_ARG_KEY_ROUND_INDEX,
                    md.MSG_ARG_KEY_SESSION_EPOCH, md.MSG_ARG_KEY_UPLOAD_KEY,
                    md.MSG_ARG_KEY_MODEL_IS_DELTA, md.MSG_ARG_KEY_HIER_PARTIAL):
            val = msg.get_control(key)
            if val is not None:
                fwd.add_params(key, val)
        self.relays += 1
        try:
            self.send_message(fwd)
        except OSError:
            log.warning("edge %d: relay of child %d's upload failed", self.rank, sender,
                        exc_info=True)

    def _ship_locked(self, resend: bool = False) -> None:
        """Ship the round's one partial upward (nothing in relay mode, or
        when nothing was folded)."""
        self._runtime.cancel(self, "straggler")
        if self._fold is None or not self._fold.folded:
            self._shipped = True
            return
        if self._shipped and not resend:
            return
        if self.hop_codec is not None:
            uniform = None
            if self.hop_noise is not None:
                def uniform(i, shape, device, hook=self.hop_noise, r=self._round_idx):
                    return hook(r, self.rank, i, shape, device)
            # the low-rank floor: the partial is the subtree's whole upward
            # traffic, so leaves of a few hundred elements are worth encoding
            tree, self._hop_residuals, _ = codecs.compress_pytree(
                self._fold.partial_tree(on_device=True), self.hop_codec,
                residuals=self._hop_residuals, ratio=self._hop_ratio,
                min_elems=codecs.LOW_RANK_MIN_COMPRESS_ELEMS, uniform=uniform)
        else:
            tree = self._fold.partial_tree()
        up = Message(md.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER, self.rank, self.parent_rank)
        up.add_params(md.MSG_ARG_KEY_MODEL_PARAMS, tree)
        up.add_params(md.MSG_ARG_KEY_NUM_SAMPLES, float(self._fold.w))
        up.add_params(md.MSG_ARG_KEY_ROUND_INDEX, self._round_idx)
        if self._epoch is not None:
            up.add_params(md.MSG_ARG_KEY_SESSION_EPOCH, int(self._epoch))
        up.add_params(md.MSG_ARG_KEY_HIER_PARTIAL, self._fold.control_tag())
        if self.journal is not None:
            # the attempt is journaled before the send, so a resend after a
            # crash carries the same key and dedups at the parent
            attempt = self._next_attempt_locked(resend)
            up.add_params(md.MSG_ARG_KEY_UPLOAD_KEY,
                          f"edge{self.rank}:{self._round_idx}:"
                          f"{-1 if self._epoch is None else int(self._epoch)}:{attempt}")
        self._shipped = True
        self._journal_snapshot_locked()
        self.partials_sent += 1
        try:
            self.send_message(up)
        except OSError:
            log.warning("edge %d: partial ship to %d failed", self.rank, self.parent_rank,
                        exc_info=True)

    def _next_attempt_locked(self, resend: bool) -> int:
        k = f"{self._round_idx}:{-1 if self._epoch is None else int(self._epoch)}"
        if resend:
            # the same bytes under the journaled attempt's key
            return max(0, self._attempts.get(k, 1) - 1)
        n = self._attempts.get(k, 0)
        self._attempts[k] = n + 1
        while len(self._attempts) > 64:
            self._attempts.pop(next(iter(self._attempts)))
        return n

    # -- straggler timer ---------------------------------------------------------
    def _arm_straggler(self) -> None:
        if self.straggler_timeout > 0:
            self._runtime.arm(self, "straggler", self.straggler_timeout,
                              self._on_straggler_timeout)

    def _on_straggler_timeout(self) -> None:
        with self._lock:
            if self._shipped or self._fold is None:
                return
            if self._fold.folded:
                log.warning("edge %d round %s: straggler timeout, shipping the partial of "
                            "%d/%d children", self.rank, self._round_idx, len(self._arrived),
                            len(self._expect))
                self._ship_locked()
            else:
                self._arm_straggler()  # nothing folded yet: keep waiting

    # -- recovery journal --------------------------------------------------------
    def _journal_snapshot_locked(self) -> None:
        """Commit the round's fold after every accepted child and at ship
        (model-less: the template leaves ride with the sums)."""
        if self.journal is None or self._round_idx is None:
            return
        proto = {
            "kind": "edge", "rank": int(self.rank), "round_idx": int(self._round_idx),
            "epoch": None if self._epoch is None else int(self._epoch),
            "expect": {str(c): s for c, s in sorted(self._expect.items())},
            "arrived": sorted(self._arrived), "shipped": bool(self._shipped),
            "folds": int(self.folds), "relays": int(self.relays),
            "deduped": int(self.deduped_uploads), "attempts": dict(self._attempts),
            "folded_keys": {str(c): list(dq) for c, dq in sorted(self._folded_keys.items())},
        }
        arrays = {}
        if self._fold is not None:
            proto["fold"], arrays = self._fold.export_state()
        self.journal.snapshot(self._round_idx, proto, arrays)

    def _journal_recover(self) -> None:
        """Resume the interrupted round from the newest intact sidecar; child
        uploads that landed while this node was dead are still queued and
        drain through the handler (their keys dedup what the sums hold)."""
        snap = self.journal.restore()
        if snap is None:
            return
        self.resumed_from_journal = True
        proto = snap["protocol"]
        self._round_idx = int(proto["round_idx"])
        self._epoch = proto.get("epoch")
        self._expect = {int(c): s for c, s in (proto.get("expect") or {}).items()}
        self._arrived = set(int(c) for c in proto.get("arrived") or [])
        self._shipped = bool(proto.get("shipped"))
        self.folds = int(proto.get("folds", 0))
        self.relays = int(proto.get("relays", 0))
        self.deduped_uploads = int(proto.get("deduped", 0))
        self._attempts = {str(k): int(v) for k, v in (proto.get("attempts") or {}).items()}
        for c, keys in (proto.get("folded_keys") or {}).items():
            self._folded_keys[int(c)] = deque([str(k) for k in keys],
                                              maxlen=DEDUP_KEYS_PER_CHILD)
        if proto.get("fold") is not None:
            self._fold = EdgePartialFold.from_state(proto["fold"], snap["arrays"],
                                                    device=self.device)
        log.info("edge %d: recovered journal step %d (round %d, %d/%d children folded, "
                 "shipped=%s)", self.rank, snap["step"], self._round_idx, len(self._arrived),
                 len(self._expect), self._shipped)

    def recovery_resume(self) -> None:
        """After a restart, once the receive loop runs: ship a recovered
        round that was complete but not shipped, else re-arm its timer."""
        with self._lock:
            if self._round_idx is None or self._shipped:
                return
            if self._fold is not None and set(self._expect) <= self._arrived:
                self._ship_locked()
            else:
                self._arm_straggler()

    # -- lifecycle ---------------------------------------------------------------
    def handle_message_finish(self, msg: Message) -> None:
        self.done.set()
        self.finish()

    def hard_kill(self) -> None:
        """Crash simulation: stop the receive loop and the timers at once, no
        ship, no journal write; what the journal holds survives."""
        self._runtime.cancel(self)
        self.com_manager.stop_receive_message()

    def finish(self) -> None:
        self._runtime.cancel(self)
        super().finish()
        self._runtime.close(wait=False)
