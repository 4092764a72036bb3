"""LightSecAgg cross-silo protocol: masked aggregation over the wire (the
port of ``fedml_tpu/cross_silo/lightsecagg.py``).

The message flow is the reference's::

    INIT / SYNC (global)                          server -> all clients
    ENCODED_MASK share for peer j                 client i -> server -> j
    --- all N shares held: client trains ---
    masked model  (field vector + z_i, u32 ring)  client -> server
    ACTIVE_CLIENTS (first-round survivors)        server -> survivors
    aggregate encoded mask over survivors         client -> server
    --- >= U aggregates held: decode the sum of masks, unmask ---
    SYNC (new global)                             server -> clients

The server only sees ``quantize(x_i) + z_i (mod p)``; the sum of the
survivors' masks comes back in one shot from any ``U`` of their Lagrange-
coded aggregates (``trust/secagg/lightsecagg.py``).  The global is the
uniform mean of the survivors' models (the reference's semantic: a
sample-weighted sum would leak the weights).  Message types 10-13 extend
the flat cross-silo namespace as the reference's do; the masked upload
rides ``pack_ring`` as little-endian u32, declared in control meta
(``masked_ring``), and the server still takes a legacy raw int64 upload.

Stragglers: the server's timer (``extra.straggler_timeout_s``) bounds both
phases.  In the model phase it proceeds once ``max(U, ceil(quorum_frac *
N))`` masked models are in, and asks those survivors for their aggregate
masks; in the mask phase it decodes as soon as ``U`` aggregates are in.
With ``extra.secagg_stream`` each masked upload folds into a running field
total as it arrives.

Every flat vector is the reference's (``weights.flatten_reference``: flax
layout, JAX leaf order); the field math is numpy int64 on the host, one
device-to-host copy of the trained model per upload and one host-to-device
copy of the mean per round.  A client's mask seed is an argument
(``mask_seed``); the default is 256 bits of ``os.urandom``, as in the
reference: masks cancel exactly in the field, so the final global does not
depend on them.

The group runs over the in-process fabric or TCP, and the server and each
silo run alone as ``role: server`` / ``role: client`` processes.  The
client journal (``extra.client_journal_dir``) is taken and holds nothing,
as in the reference (its upload path does not journal): a restarted silo
joins the next round's fresh mask exchange.  The server journal is refused
(``server.LSA_SERVER_JOURNAL_REFUSAL``: the reference's recovered server
stalls on a crash inside a round).

Refused as the reference refuses them (``secagg_params``): T and U out of
range (``ValueError``), attacks, defenses, DP, contribution and FHE, any
optimizer but FedAvg (``NotImplementedError``), partial participation
(``ValueError``).
"""

from __future__ import annotations

import logging
import math
import os
import threading
import time
from typing import Optional

import numpy as np
import torch

from .. import weights
from ..comm.message import Message
from ..core import pytree as pt
from ..core.flags import cfg_extra
from ..trust.secagg.field import dequantize_from_field, quantize_to_field
from ..trust.secagg.lightsecagg import LightSecAggProtocol
from ..trust.secagg.stream import DENSE_RING_BITS, FieldStreamAccumulator, pack_ring, unpack_ring
from . import message_define as md
from .client import ClientMasterManager, FedMLTrainer
from .server import FedMLAggregator, FedMLServerManager

log = logging.getLogger("fedml_tpu_torch.cross_silo.lightsecagg")

MSG_TYPE_C2S_SEND_ENCODED_MASK = 10
MSG_TYPE_S2C_ENCODED_MASK = 11
MSG_TYPE_S2C_ACTIVE_CLIENTS = 12
MSG_TYPE_C2S_SEND_AGG_MASK = 13

MSG_ARG_KEY_ENCODED_MASK = "encoded_mask"
MSG_ARG_KEY_AGG_ENCODED_MASK = "aggregate_encoded_mask"
MSG_ARG_KEY_MASK_SOURCE = "client_id"
MSG_ARG_KEY_ACTIVE_CLIENTS = "active_clients"
#: control-plane descriptor of a ring-packed masked upload: ``{"ring_bits",
#: "length"}``; absent for a legacy raw int64 upload
MSG_ARG_KEY_MASKED_RING = "masked_ring"


def secagg_params(cfg) -> tuple[int, int, int]:
    """``(T, U, q_bits)`` from the config (reference L77): ``T = floor(N/2)``
    and ``U = T + 1`` unless ``extra.secagg_privacy_t`` / ``secagg_target_u``
    say otherwise; raises for what LightSecAgg cannot serve."""
    n = cfg.client_num_in_total
    t = int(cfg_extra(cfg, "secagg_privacy_t", max(1, n // 2)))
    u = int(cfg_extra(cfg, "secagg_target_u", t + 1))
    q_bits = int(cfg_extra(cfg, "secagg_q_bits"))
    if not (0 < t < u <= n):
        raise ValueError(f"LightSecAgg needs 0 < T({t}) < U({u}) <= N({n})")
    incompatible = [f for f in ("enable_attack", "enable_defense", "enable_dp",
                                "enable_contribution", "enable_fhe") if getattr(cfg, f, False)]
    if incompatible:
        raise NotImplementedError(
            f"trust features {incompatible} operate on individual client updates, which "
            "LightSecAgg hides from the server by design; disable them or enable_secagg")
    if getattr(cfg, "federated_optimizer", "FedAvg") not in ("FedAvg", "fedavg", "FedAvg_seq"):
        raise NotImplementedError(
            "LightSecAgg reconstruction yields only the uniform mean of the survivors' "
            f"updates; server optimizer {cfg.federated_optimizer!r} needs per-client updates "
            "- use FedAvg with enable_secagg")
    return t, u, q_bits


def masked_upload(flat: np.ndarray, mask: np.ndarray, p: int,
                  q_bits: int) -> tuple[np.ndarray, dict, np.ndarray]:
    """``(u32 wire array, masked_ring meta, field vector)`` of a flat f32
    model: ``quantize(x) + z (mod p)`` over the mask's padded length."""
    field_vec = quantize_to_field(flat, p=p, bits=q_bits)
    padded = np.zeros(mask.shape[0], dtype=np.int64)
    padded[: flat.size] = field_vec
    masked = (padded + mask) % p
    return (pack_ring(masked, DENSE_RING_BITS),
            {"ring_bits": DENSE_RING_BITS, "length": int(masked.size)}, field_vec)


def masked_model_message(rank: int, payload: np.ndarray, meta: dict, n_samples: float,
                         round_idx: int) -> Message:
    """The masked-model upload, its params in the reference's order."""
    msg = Message(md.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER, rank, 0)
    msg.add_params(md.MSG_ARG_KEY_MODEL_PARAMS, payload)
    msg.add_params(MSG_ARG_KEY_MASKED_RING, meta)
    msg.add_params(md.MSG_ARG_KEY_NUM_SAMPLES, n_samples)
    msg.add_params(md.MSG_ARG_KEY_ROUND_INDEX, round_idx)
    return msg


def model_size(params) -> int:
    """Elements of a variable tree (numpy or tensors)."""
    return sum(math.prod(leaf.shape) for leaf in pt.tree_leaves(params))


class LSAAggregator(FedMLAggregator):
    """Server-side LightSecAgg state: masked field vectors in place of
    models; reconstruction in place of the weighted mean."""

    def __init__(self, cfg, model, test_arrays, device, global_vars=None):
        super().__init__(cfg, model, test_arrays, device, global_vars=global_vars)
        # masked uploads never take the f32 fold, whatever the comm flags say
        self.stream_mode = False
        t, u, self.q_bits = secagg_params(cfg)
        self.protocol = LightSecAggProtocol(cfg.client_num_in_total, t, u)
        self.model_dim = model_size(self.global_vars)
        self.d_pad = self.protocol.pad_len(self.model_dim)
        self.agg_mask_dict: dict[int, np.ndarray] = {}
        self.field_stream = bool(cfg_extra(cfg, "secagg_stream"))
        self._facc: Optional[FieldStreamAccumulator] = None
        self._facc_folded = 0
        #: host seconds of the last decode, unmask, dequantize and unravel
        self.last_finalize_s = 0.0

    def add_local_trained_result(self, client_idx: int, masked_vec, sample_num: float) -> None:
        vec = np.asarray(masked_vec, dtype=np.int64)
        if vec.shape != (self.d_pad,):
            raise ValueError(f"masked vector shape {vec.shape} != ({self.d_pad},)")
        if not self.field_stream:
            super().add_local_trained_result(client_idx, vec, sample_num)
            return
        if self._facc is None:
            self._facc = FieldStreamAccumulator([np.zeros(self.d_pad, np.int64)],
                                                self.protocol.p)
        # buffered now: the running total (once anything folded) and this one
        self.peak_buffered_updates = max(self.peak_buffered_updates,
                                         (1 if self._facc_folded else 0) + 1)
        self._facc.fold_leaf(0, vec)
        self._facc_folded += 1
        self.sample_num_dict[client_idx] = sample_num
        self.flag_client_model_uploaded[client_idx] = True

    def survivor_ids(self) -> list[int]:
        """Clients whose masked vector is in this round's sum."""
        return sorted(self.flag_client_model_uploaded)

    def add_aggregate_encoded_mask(self, client_idx: int, agg_mask) -> None:
        self.agg_mask_dict[client_idx] = np.asarray(agg_mask, dtype=np.int64)

    def mask_count(self) -> int:
        return len(self.agg_mask_dict)

    def aggregate(self, round_idx: int):
        """Field-sum the survivors' masked vectors, decode the sum of their
        masks from the aggregate encoded masks, subtract, dequantize and
        take the uniform mean (reference L177)."""
        t0 = time.perf_counter()
        active = self.survivor_ids()
        p = self.protocol.p
        if self._facc is not None:
            total = self._facc.host_sums()[0]
        else:
            total = np.zeros(self.d_pad, dtype=np.int64)
            for i in active:
                total = (total + self.model_dict[i]) % p
        # aggregate encoded masks are indexed by 0-based client index
        agg_shares = {cid - 1: v for cid, v in self.agg_mask_dict.items()}
        mask_sum = self.protocol.decode_aggregate_mask(agg_shares, self.d_pad)
        unmasked = (total - mask_sum) % p
        avg = dequantize_from_field(unmasked[: self.model_dim], len(active), bits=self.q_bits)
        avg = avg / max(len(active), 1)
        # the reference's f64 -> f32 rounding, then one copy to the device
        flat = torch.from_numpy(avg.astype(np.float32)).to(self.device)
        self.global_vars = weights.flatten_reference(self.global_vars)[1](flat)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.last_finalize_s = time.perf_counter() - t0
        self._reset_round()
        self.agg_mask_dict.clear()
        self._facc = None
        self._facc_folded = 0
        return self.global_vars

    def round_metrics(self) -> dict:
        return {"finalize_time_s": self.last_finalize_s}


class LSAServerManager(FedMLServerManager):
    """Relays the mask shares, collects masked models, asks the survivors
    for their aggregate masks and reconstructs once U are in."""

    def __init__(self, cfg, aggregator: LSAAggregator, backend: Optional[str] = None,
                 logger=None):
        super().__init__(cfg, aggregator, backend=backend, logger=logger, secure="lightsecagg")
        if self.per_round != len(self.client_ids):
            raise ValueError(
                "LightSecAgg requires full participation per round "
                f"(client_num_per_round={self.per_round} != N={len(self.client_ids)}); "
                "the mask-share topology is over all N clients")
        self.active_first: list[int] = []
        self._phase = "model"  # model -> mask

    def register_message_receive_handlers(self) -> None:
        super().register_message_receive_handlers()
        self.register_message_receive_handler(MSG_TYPE_C2S_SEND_ENCODED_MASK,
                                              self.handle_message_encoded_mask)
        self.register_message_receive_handler(MSG_TYPE_C2S_SEND_AGG_MASK,
                                              self.handle_message_agg_mask)

    def handle_message_encoded_mask(self, msg: Message) -> None:
        """Relay a mask share from its source client to its destination."""
        relay = Message(MSG_TYPE_S2C_ENCODED_MASK, 0, int(msg.get(md.MSG_ARG_KEY_CLIENT_INDEX)))
        relay.add_params(MSG_ARG_KEY_ENCODED_MASK, msg.get(MSG_ARG_KEY_ENCODED_MASK))
        relay.add_params(MSG_ARG_KEY_MASK_SOURCE, msg.get_sender_id())
        relay.add_params(md.MSG_ARG_KEY_ROUND_INDEX, msg.get(md.MSG_ARG_KEY_ROUND_INDEX))
        self.send_message(relay)

    def handle_message_receive_model(self, msg: Message) -> None:
        with self._agg_lock:
            if msg.get(md.MSG_ARG_KEY_ROUND_INDEX) != self.round_idx or self._phase != "model":
                return
            self._round_payload_bytes += int(msg.wire_nbytes)
            vec = msg.get(md.MSG_ARG_KEY_MODEL_PARAMS)
            meta = msg.get_control(MSG_ARG_KEY_MASKED_RING)
            if meta is not None:
                vec = unpack_ring(np.asarray(vec), int(meta["ring_bits"]), int(meta["length"]))
            self.aggregator.add_local_trained_result(
                msg.get_sender_id(), vec, float(msg.get(md.MSG_ARG_KEY_NUM_SAMPLES)))
            if self.aggregator.check_whether_all_receive(len(self.selected)):
                self._request_aggregate_masks()

    def _request_aggregate_masks(self) -> None:
        """Freeze the first-round survivors and ask them for their aggregate
        encoded masks.  Caller holds _agg_lock."""
        self._runtime.cancel(self, "straggler")
        self._phase = "mask"
        self.active_first = self.aggregator.survivor_ids()
        for cid in self.active_first:
            msg = Message(MSG_TYPE_S2C_ACTIVE_CLIENTS, 0, cid)
            msg.add_params(MSG_ARG_KEY_ACTIVE_CLIENTS, [int(c) for c in self.active_first])
            msg.add_params(md.MSG_ARG_KEY_ROUND_INDEX, self.round_idx)
            self.send_message(msg)
        self._arm_straggler_timer()

    def handle_message_agg_mask(self, msg: Message) -> None:
        with self._agg_lock:
            if msg.get(md.MSG_ARG_KEY_ROUND_INDEX) != self.round_idx or self._phase != "mask":
                return
            self.aggregator.add_aggregate_encoded_mask(msg.get_sender_id(),
                                                       msg.get(MSG_ARG_KEY_AGG_ENCODED_MASK))
            if self.aggregator.mask_count() >= len(self.active_first):
                self._phase = "model"
                self._finish_round()

    def _on_straggler_timeout(self) -> None:
        """Model phase: proceed with a quorum of masked models (at least U);
        mask phase: decode as soon as U aggregates are in."""
        with self._agg_lock:
            if self._phase == "model":
                need = max(self.aggregator.protocol.u,
                           int(math.ceil(self.quorum_frac * len(self.selected))))
                if self.aggregator.received_count() >= need:
                    log.warning("round %d: straggler timeout, proceeding with %d/%d masked "
                                "models", self.round_idx, self.aggregator.received_count(),
                                len(self.selected))
                    self._request_aggregate_masks()
                    return
            elif self.aggregator.mask_count() >= self.aggregator.protocol.u:
                log.warning("round %d: mask-phase timeout, decoding from %d/%d aggregates",
                            self.round_idx, self.aggregator.mask_count(), len(self.active_first))
                self._phase = "model"
                self._finish_round()
                return
            self._arm_straggler_timer()


class LSAClientManager(ClientMasterManager):
    """Offline mask exchange, then train, then upload ``quantize(x) + z
    (mod p)``; one aggregate mask on request."""

    def __init__(self, cfg, trainer: FedMLTrainer, rank: int, backend: Optional[str] = None,
                 mask_seed: Optional[int] = None):
        super().__init__(cfg, trainer, rank=rank, backend=backend)
        t, u, self.q_bits = secagg_params(cfg)
        self.n = cfg.client_num_in_total
        # never derivable from the run's config: a server that could replay
        # the mask stream would unmask individual updates (256 bits, so the
        # seed cannot be enumerated either)
        if mask_seed is None:
            mask_seed = int.from_bytes(os.urandom(32), "little")
        self.protocol = LightSecAggProtocol(self.n, t, u, seed=mask_seed)
        self.encoded_mask_dict: dict[int, np.ndarray] = {}
        self._early_shares: dict[tuple[int, int], np.ndarray] = {}  # (round, src)
        self._share_round = -1
        self._mask: Optional[np.ndarray] = None
        self._pending_msg: Optional[Message] = None
        self._lock = threading.Lock()
        #: the last upload's field-quantized model before its mask, kept for
        #: inspection
        self.last_field_vec: Optional[np.ndarray] = None

    def register_message_receive_handlers(self) -> None:
        super().register_message_receive_handlers()
        self.register_message_receive_handler(MSG_TYPE_S2C_ENCODED_MASK,
                                              self.handle_message_encoded_mask)
        self.register_message_receive_handler(MSG_TYPE_S2C_ACTIVE_CLIENTS,
                                              self.handle_message_active_clients)

    def _train_and_send(self, msg: Message) -> None:
        """INIT / SYNC: the offline phase first: draw z_i, encode it, send
        one share a peer through the server."""
        round_idx = int(msg.get(md.MSG_ARG_KEY_ROUND_INDEX))
        with self._lock:
            self._pending_msg = msg
            self._share_round = round_idx
            self.encoded_mask_dict.clear()
            # adopt shares that raced ahead of this INIT / SYNC; drop stale ones
            for (r, src), v in list(self._early_shares.items()):
                if r == round_idx:
                    self.encoded_mask_dict[src] = v
                    del self._early_shares[(r, src)]
                elif r < round_idx:
                    del self._early_shares[(r, src)]
            self._mask = self.protocol.gen_mask(model_size(msg.get(md.MSG_ARG_KEY_MODEL_PARAMS)))
            encoded = self.protocol.encode_mask(self._mask)  # row j -> peer j + 1
        for j in range(1, self.n + 1):
            share = Message(MSG_TYPE_C2S_SEND_ENCODED_MASK, self.rank, 0)
            share.add_params(md.MSG_ARG_KEY_CLIENT_INDEX, j)  # destination rank
            share.add_params(MSG_ARG_KEY_ENCODED_MASK, encoded[j - 1])
            share.add_params(md.MSG_ARG_KEY_ROUND_INDEX, round_idx)
            self.send_message(share)

    def handle_message_encoded_mask(self, msg: Message) -> None:
        with self._lock:
            src = int(msg.get(MSG_ARG_KEY_MASK_SOURCE))
            share = np.asarray(msg.get(MSG_ARG_KEY_ENCODED_MASK), dtype=np.int64)
            r = msg.get(md.MSG_ARG_KEY_ROUND_INDEX)
            if r is not None and int(r) != self._share_round:
                self._early_shares[(int(r), src)] = share
                return
            self.encoded_mask_dict[src] = share
            ready = len(self.encoded_mask_dict) == self.n and self._pending_msg is not None
        if ready:
            self._train_masked()

    def _train_masked(self) -> None:
        with self._lock:
            msg, self._pending_msg = self._pending_msg, None
            mask = self._mask
        if msg is None:
            return
        round_idx = int(msg.get(md.MSG_ARG_KEY_ROUND_INDEX))
        params = msg.get(md.MSG_ARG_KEY_MODEL_PARAMS)
        client_idx = int(msg.get(md.MSG_ARG_KEY_CLIENT_INDEX, self.rank - 1))
        new_vars, n_samples = self.trainer.train(self.to_device(params), round_idx,
                                                 self.seed_key, client_idx)
        self.rounds_trained += 1
        flat = weights.flatten_reference(new_vars)[0].cpu().numpy()  # the one d2h copy
        payload, meta, self.last_field_vec = masked_upload(flat, mask, self.protocol.p,
                                                           self.q_bits)
        self.send_message(masked_model_message(self.rank, payload, meta, n_samples, round_idx))

    def handle_message_active_clients(self, msg: Message) -> None:
        """Sum the held sub-masks of the surviving sources; send ONE
        aggregate."""
        active = [int(c) for c in msg.get(MSG_ARG_KEY_ACTIVE_CLIENTS)]
        with self._lock:
            shares = [self.encoded_mask_dict[c] for c in active if c in self.encoded_mask_dict]
        if len(shares) != len(active):
            log.warning("client %d missing shares for active set %s", self.rank, active)
            return
        reply = Message(MSG_TYPE_C2S_SEND_AGG_MASK, self.rank, 0)
        reply.add_params(MSG_ARG_KEY_AGG_ENCODED_MASK,
                         LightSecAggProtocol.aggregate_encoded_masks(shares))
        reply.add_params(md.MSG_ARG_KEY_ROUND_INDEX, int(msg.get(md.MSG_ARG_KEY_ROUND_INDEX)))
        self.send_message(reply)


# -- builders ------------------------------------------------------------------

def build_lsa_server(cfg, dataset, model, device, backend: Optional[str] = None,
                     global_vars=None, logger=None) -> LSAServerManager:
    from ..data.dataset import pad_eval_set
    from .server import eval_batch_size

    test_arrays = pad_eval_set(dataset.test_x, dataset.test_y, eval_batch_size(cfg))
    aggregator = LSAAggregator(cfg, model, test_arrays, device, global_vars=global_vars)
    return LSAServerManager(cfg, aggregator, backend=backend, logger=logger)


def build_lsa_client(cfg, dataset, model, rank: int, device, backend: Optional[str] = None,
                     perms=None, mask_seed: Optional[int] = None) -> LSAClientManager:
    ix = dataset.client_idx[rank - 1]
    trainer = FedMLTrainer(cfg, model, dataset.train_x[ix], dataset.train_y[ix], device,
                           perms=perms)
    return LSAClientManager(cfg, trainer, rank=rank, backend=backend, mask_seed=mask_seed)


def build_lightsecagg_process_group(cfg, dataset, model, device, backend: str = "INPROC",
                                    drop_ranks: frozenset = frozenset(), global_vars=None,
                                    perms=None, logger=None, mask_seeds=None):
    """``(server, clients)``: 1 server + N LightSecAgg clients on the
    in-process fabric (or loopback TCP), not started.  ``drop_ranks``
    clients complete the mask exchange (their masks are in the survivors'
    share tables) but never upload a model: the hard dropout case.  ``mask_seeds`` maps a
    rank to its mask seed (default: OS entropy)."""
    from ..comm.inproc import InProcRouter
    from ..comm.tcp_backend import link_ports

    InProcRouter.reset(str(getattr(cfg, "run_id", "0")))
    server = build_lsa_server(cfg, dataset, model, device, backend=backend,
                              global_vars=global_vars, logger=logger)
    clients = []
    for r in range(1, cfg.client_num_in_total + 1):
        c = build_lsa_client(cfg, dataset, model, r, device, backend=backend, perms=perms,
                             mask_seed=(mask_seeds or {}).get(r))
        if r in drop_ranks:
            c._train_masked = lambda: None  # drops out before its model upload
        clients.append(c)
    link_ports([server, *clients])
    return server, clients


def run_lightsecagg_process_group(cfg, dataset, model, device, backend: str = "INPROC",
                                  timeout: float = 600.0, drop_ranks: frozenset = frozenset(),
                                  **hooks):
    """1 server + N LightSecAgg clients on threads over the in-process
    fabric; returns ``(history, server)``.  ``hooks``: ``global_vars``,
    ``perms``, ``logger``, ``mask_seeds``."""
    from . import run_group

    server, clients = build_lightsecagg_process_group(cfg, dataset, model, device, backend,
                                                      drop_ranks=drop_ranks, **hooks)
    return run_group(server, clients, timeout), server
