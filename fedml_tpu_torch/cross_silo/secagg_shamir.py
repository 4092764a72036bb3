"""Shamir pairwise-mask SecAgg with the streaming field fold and central DP
(the port of ``fedml_tpu/cross_silo/secagg_shamir.py``).

The protocol, its message flow and its wire are the reference's::

    PK           (c_pk, s_pk)                       client -> server    (setup)
    PK TABLE     all public keys                    server -> clients   (setup)
    SHARES       Shamir shares of (b_u, s_sk_u)     client -> server -> peers
    INIT/SYNC    global model                       server -> clients
    masked model quantize(x_u) + PRG(b_u)
                 + sum_{v<u} PRG(s_uv) - sum_{v>u} PRG(s_uv)   client -> server
    ACTIVE SET   first-round survivors              server -> survivors
    REVEAL       b-share of survivors,
                 s_sk-share of dropped              survivor -> server

With ``extra.secagg_stream`` each masked upload folds into a running field
total as it arrives (peak buffered <= 2) and the masks come out once, at
finalize; without it the server buffers every masked vector (the historical
int64 wire).  Central DP (``enable_dp`` + ``dp_solution_type: cdp``, only
under ``secagg_stream``) lands once per round at finalize: the aggregate's
round delta is clipped on the device and the Gaussian noise goes through
the CUDA kernel of ``ops/noise.py``.

Every flat vector is the reference's flat vector (``weights.
flatten_reference``: flax layout, JAX leaf order), so element *i* is the
same parameter in both packages and the masked field vectors, the ring
packing and the noise draw line up element for element.  The host boundary
is the reference's: one device-to-host copy of the flat model per upload
(the field math is float64 / int64 numpy) and one host-to-device copy of
the unmasked mean per round.

The DH secrets come from ``os.urandom``, as in the reference; the masks
cancel exactly in the field, so the final global does not depend on them.
The central-DP draw comes from a sampler object on the aggregator
(``noise_sampler.gaussian(round, shape, device)``; the default keys it
``fold_in(round_key(root, r), 0xCD9)`` as the reference does), so tests can
hand in the reference's draw.

Quantize-then-mask (``comm_compression: qsgd8`` under ``secagg_stream``):
a client uploads its round **delta** against the global it received (f64 on
the host), stochastically rounded to the int8 grid at
``secagg_q8_frac_bits`` (numpy, seeded ``[seed, round, rank]``: bitwise the
reference's) and masked in the cohort-sized ring (11 bits, a u16 wire, at 4
clients); the server adds the unmasked mean delta back onto the old global
at finalize, before central DP.  Without ``secagg_stream`` the codec is
ignored (the buffer-all dense wire), as in the reference.

The group runs over the in-process fabric or TCP, and the server and each
silo run alone as ``role: server`` / ``role: client`` processes.  The
server journal (``extra.server_journal_dir``) recovers a crash at a round
boundary or inside a round, the round redone (the secure handlers take no
mid-round snapshot, as the reference's take none); a recovered server drops
an upload that reaches it before its first dispatch (its predecessor's,
drained from the queue) or a second one a round, where the reference counts
them (ROADMAP Queue 3).  The client journal is refused: the reference's
journals none of the keys, so a restarted silo re-keys.

Refused as the reference refuses them: LDP and every other trust feature,
CDP without ``secagg_stream``, partial participation and non-FedAvg
optimizers.
"""

from __future__ import annotations

import hashlib
import logging
import math
import os
import threading
import time
from typing import Optional

import numpy as np
import torch

from .. import weights
from ..comm import codecs
from ..comm.message import Message
from ..core.flags import cfg_extra
from ..ops import noise as noise_ops
from ..trust.dp.dp import (FedMLDifferentialPrivacy, NoiseSampler, add_laplace_noise,
                           laplace_scale)
from ..trust.secagg import stream as secagg_stream
from ..trust.secagg.field import DEFAULT_PRIME, dequantize_from_field, quantize_to_field
from ..trust.secagg.shamir import masked_input, shamir_reconstruct, shamir_share, unmask_sum
from . import message_define as md
from .client import ClientMasterManager, FedMLTrainer
from .server import FedMLAggregator, FedMLServerManager

log = logging.getLogger("fedml_tpu_torch.cross_silo.secagg_shamir")

# protocol constants: the reference's flat cross-silo namespace
MSG_TYPE_C2S_PUBLIC_KEY = 14
MSG_TYPE_S2C_PUBLIC_KEYS = 15
MSG_TYPE_C2S_SECRET_SHARES = 16
MSG_TYPE_S2C_PEER_SHARES = 17
MSG_TYPE_S2C_ACTIVE_SET = 18
MSG_TYPE_C2S_SHARE_REVEAL = 19

MSG_ARG_KEY_C_PK = "c_pk"
MSG_ARG_KEY_S_PK = "s_pk"
MSG_ARG_KEY_PK_TABLE = "pk_table"
MSG_ARG_KEY_B_SHARES = "b_shares_enc"
MSG_ARG_KEY_SK_SHARES = "sk_shares_enc"
MSG_ARG_KEY_ACTIVE_SET = "active_set"
MSG_ARG_KEY_B_REVEALS = "b_reveals"
MSG_ARG_KEY_SK_REVEALS = "sk_reveals"
#: control-plane descriptor of a streaming masked upload (codec, ring_bits,
#: frac_bits, length, delta); present only under extra.secagg_stream
MSG_ARG_KEY_SECAGG_META = "secagg_meta"

P = DEFAULT_PRIME
DH_G = 5


def dh_keypair() -> tuple[int, int]:
    sk = int.from_bytes(os.urandom(16), "little") % (P - 3) + 2
    return sk, pow(DH_G, sk, P)


def dh_agree(sk: int, peer_pk: int) -> int:
    return pow(int(peer_pk), int(sk), P)


def derive_round_seed(seed: int, round_idx: int) -> int:
    """Fresh 31-bit PRG seed per (secret, round)."""
    h = hashlib.sha256(f"sa:{int(seed)}:{int(round_idx)}".encode()).digest()
    return int.from_bytes(h[:4], "little") % (2**31)


def _share_pad(c_key: int, src: int, dst: int) -> tuple[int, int]:
    """Keystream hiding a (b, s_sk) share pair in server transit, bound to the
    direction and the share kind."""
    def h(kind: str) -> int:
        d = hashlib.sha256(f"pad:{int(c_key)}:{int(src)}:{int(dst)}:{kind}".encode()).digest()
        return int.from_bytes(d[:8], "little") % P

    return h("b"), h("sk")


def mask_upload(flat: np.ndarray, rank: int, peer_seeds: dict, self_seed: int, q_bits: int,
                ring: Optional[secagg_stream.MaskedRing], base: Optional[np.ndarray] = None,
                seed=None) -> tuple:
    """``(wire array, secagg meta or None)`` of one client's flat f32 model
    (the reference's flat vector): fixed point in the field, masked; with a
    streaming ``ring`` packed to its wire width, else the buffer-all int64
    vector.  A ``qsgd8`` ring takes the delta ``flat - base`` in f64 onto
    its int8 grid instead, rounded with ``np.random.default_rng(seed)``."""
    if ring is not None and ring.codec == "qsgd8":
        delta = np.asarray(flat, np.float64) - np.asarray(base, np.float64)
        q = secagg_stream.quantize_stochastic_int8(delta, ring.frac_bits, seed)
        x_field = np.mod(q, ring.modulus)
    else:
        x_field = quantize_to_field(flat, bits=q_bits)
    if ring is None:
        return masked_input(x_field, rank, peer_seeds, self_seed), None
    masked = secagg_stream.mask_vector(x_field, rank, peer_seeds, self_seed, ring.modulus)
    packed = secagg_stream.pack_ring(masked, ring.bits)
    codecs.note_masked_payload(f"secagg_{ring.codec}", packed.nbytes, flat.nbytes)
    return packed, dict(ring.meta(int(x_field.size)), delta=ring.codec == "qsgd8")


def shamir_secagg_params(cfg) -> tuple[int, int]:
    """``(T, q_bits)``: reconstruction needs T+1 shares (T defaults to N // 2).
    Raises for every composition the reference refuses."""
    n = cfg.client_num_in_total
    t = int(cfg_extra(cfg, "secagg_privacy_t", max(1, n // 2)))
    q_bits = int(cfg_extra(cfg, "secagg_q_bits"))
    if not (0 < t < n):
        raise ValueError(f"Shamir SecAgg needs 0 < T({t}) < N({n})")
    # central DP composes with the streaming fold: the noise lands once on
    # the unmasked aggregate.  LDP and the rest need individual updates.
    streaming_cdp_ok = bool(cfg_extra(cfg, "secagg_stream")) and (
        getattr(cfg, "dp_solution_type", "ldp").lower() == "cdp")
    incompatible = [
        f for f in ("enable_attack", "enable_defense", "enable_dp", "enable_contribution",
                    "enable_fhe")
        if getattr(cfg, f, False) and not (f == "enable_dp" and streaming_cdp_ok)
    ]
    if incompatible:
        raise NotImplementedError(
            f"trust features {incompatible} operate on individual client updates, which "
            "SecAgg hides from the server by design; disable them or disable enable_secagg "
            "(central DP composes when secagg_stream is set)")
    if getattr(cfg, "federated_optimizer", "FedAvg") not in ("FedAvg", "fedavg", "FedAvg_seq"):
        raise NotImplementedError(
            "SecAgg reconstruction yields only the uniform mean of the survivors' updates; "
            f"{cfg.federated_optimizer!r} needs per-client updates")
    return t, q_bits


class SAAggregator(FedMLAggregator):
    """Server-side state: the masked field sum (or buffered masked vectors)
    and the revealed shares."""

    def __init__(self, cfg, model, test_arrays, device, global_vars=None,
                 noise_sampler: Optional[NoiseSampler] = None):
        super().__init__(cfg, model, test_arrays, device, global_vars=global_vars)
        # masked uploads never take the f32 fold, whatever the comm flags say
        self.stream_mode = False
        self.t, self.q_bits = shamir_secagg_params(cfg)
        self.model_dim = int(weights.flatten_reference(self.global_vars)[0].numel())
        self.n = cfg.client_num_in_total
        self.field_stream = bool(cfg_extra(cfg, "secagg_stream"))
        self.ring = secagg_stream.ring_for(
            codecs.codec_from_config(cfg), self.n, q_bits=self.q_bits,
            q8_frac_bits=int(cfg_extra(cfg, "secagg_q8_frac_bits")))
        self._msum: Optional[secagg_stream.StreamingMaskedSum] = None
        # the round's masked uploads are deltas against the broadcast global
        self._stream_is_delta = False
        self._dp = FedMLDifferentialPrivacy(cfg) if getattr(cfg, "enable_dp", False) else None
        #: source of the central-DP draws (``gaussian`` / ``laplace``)
        self.noise_sampler = noise_sampler or NoiseSampler(cfg.random_seed)
        self.s_pk_table: dict[int, int] = {}
        # reveals[v] = (b_reveals {u: y}, sk_reveals {u: y}) from survivor v
        self.reveals: dict[int, tuple[dict, dict]] = {}
        # clients whose s_sk was reconstructed after a dropout are excluded
        # for good: a rejoin would let the server unmask their upload
        self.compromised: set[int] = set()
        #: host seconds of the last finalize (unmask + dequantize + the
        #: clip and noise enqueued on the device)
        self.last_finalize_s = 0.0
        #: the last CDP finalize's round delta before its clip (the
        #: aggregate minus the old global, flat) and its clipped flat model
        #: before its noise (the reference's ``old + clip(delta)``), kept
        #: for inspection
        self.dp_delta: Optional[torch.Tensor] = None
        self.dp_pre_noise: Optional[torch.Tensor] = None

    def add_local_trained_result(self, client_idx: int, masked_vec, sample_num: float) -> None:
        if client_idx in self.compromised:
            log.warning("client %d rejoined after its s_sk was reconstructed; refusing its "
                        "upload", client_idx)
            return
        vec = np.asarray(masked_vec, dtype=np.int64)
        if vec.shape != (self.model_dim,):
            raise ValueError(f"masked vector shape {vec.shape} != ({self.model_dim},)")
        super().add_local_trained_result(client_idx, vec, sample_num)

    def add_masked_upload(self, client_idx: int, packed, sample_num: float, meta: dict) -> None:
        """Streaming path: unpack the wire-width masked vector and fold it into
        the running field total at once."""
        if client_idx in self.compromised:
            log.warning("client %d rejoined after its s_sk was reconstructed; refusing its "
                        "upload", client_idx)
            return
        if not self.ring.matches(meta):
            log.warning("client %d masked upload ring %s != server %s; rejecting",
                        client_idx, meta, self.ring.meta(0))
            return
        vec = secagg_stream.unpack_ring(packed, self.ring.bits,
                                        int(meta.get("length", self.model_dim)))
        if vec.shape != (self.model_dim,):
            raise ValueError(f"masked vector shape {vec.shape} != ({self.model_dim},)")
        if self._msum is None:
            self._msum = secagg_stream.StreamingMaskedSum(self.model_dim, self.ring)
        self._stream_is_delta = bool(meta.get("delta"))
        self._msum.fold(vec)
        self.sample_num_dict[client_idx] = sample_num
        self.flag_client_model_uploaded[client_idx] = True
        self.peak_buffered_updates = max(self.peak_buffered_updates, self._msum.peak_buffered)

    def survivor_ids(self) -> list[int]:
        """Clients whose masked upload is in this round's sum."""
        return sorted(self.flag_client_model_uploaded)

    def add_reveal(self, sender: int, b_reveals: dict, sk_reveals: dict) -> None:
        self.reveals[int(sender)] = ({int(u): int(y) for u, y in b_reveals.items()},
                                     {int(u): int(y) for u, y in sk_reveals.items()})

    def reveal_count(self) -> int:
        return len(self.reveals)

    def aggregate(self, round_idx: int):
        """Decode the survivors' b_u (subtract self-masks) and the dropped
        clients' s_sk (cancel orphaned pair masks), dequantize, average,
        then central DP when configured.  The streamed and buffer-all paths
        give the same mean: the field math is exact."""
        t0 = time.perf_counter()
        active = self.survivor_ids()
        dropped = [u for u in range(1, self.n + 1) if u not in active]
        self_seeds = {}
        for u in active:
            shares = [(v, self.reveals[v][0][u]) for v in self.reveals if u in self.reveals[v][0]]
            if len(shares) < self.t + 1:
                raise RuntimeError(f"not enough b-shares for survivor {u}: {len(shares)}")
            self_seeds[u] = derive_round_seed(shamir_reconstruct(shares[: self.t + 1]), round_idx)
        dropped_pair_seeds = {}
        for u in dropped:
            shares = [(v, self.reveals[v][1][u]) for v in self.reveals if u in self.reveals[v][1]]
            if len(shares) < self.t + 1:
                raise RuntimeError(f"not enough s_sk-shares for dropped {u}: {len(shares)}")
            s_sk_u = shamir_reconstruct(shares[: self.t + 1])
            self.compromised.add(u)  # its pairwise seeds are now server-known
            for v in active:
                dropped_pair_seeds[(u, v)] = derive_round_seed(dh_agree(s_sk_u, self.s_pk_table[v]),
                                                               round_idx)
        if self._msum is not None:
            total = self._msum.finalize(self_seeds, dropped_pair_seeds)
            avg = dequantize_from_field(total, len(active), p=self.ring.modulus,
                                        bits=self.ring.frac_bits)
        else:
            masked = {u: self.model_dict[u] for u in active}
            total = unmask_sum(masked, self_seeds, dropped_pair_seeds)
            avg = dequantize_from_field(total, len(active), bits=self.q_bits)
        avg = avg / max(len(active), 1)
        old_flat, unravel = weights.flatten_reference(self.global_vars)
        if self._msum is not None and self._stream_is_delta:
            # quantize-then-mask uploads are deltas against the broadcast
            # global: the unmasked mean delta lands on it, in f64
            avg = old_flat.cpu().numpy().astype(np.float64) + avg
        # the reference's f64 -> f32 rounding, then one copy to the device
        flat = torch.from_numpy(avg.astype(np.float32)).to(self.device)
        self.global_vars = unravel(self._apply_central_dp(flat, old_flat, round_idx))
        self.last_finalize_s = time.perf_counter() - t0
        self._reset_round()
        self.reveals.clear()
        self._msum = None
        self._stream_is_delta = False
        return self.global_vars

    def _apply_central_dp(self, avg: torch.Tensor, old_flat: torch.Tensor,
                          round_idx: int) -> torch.Tensor:
        """Central DP once, at finalize: clip the aggregate's round delta and
        add the calibrated noise (Gaussian through the CUDA kernel)."""
        if self._dp is None or not self._dp.is_cdp_enabled():
            return avg
        self.dp_delta = avg - old_flat
        flat = old_flat + self._dp.global_clip(self.dp_delta)
        self.dp_pre_noise = flat
        if self._dp.mechanism == "gaussian":
            noise = self.noise_sampler.gaussian(round_idx, noise_ops.noise_shape(flat.numel()),
                                                flat.device)
            return noise_ops.apply_gaussian_noise(flat, noise, self._dp.sigma())
        noise = self.noise_sampler.laplace(round_idx, tuple(flat.shape), flat.device)
        return add_laplace_noise(flat, noise, laplace_scale(self._dp.epsilon,
                                                            self._dp.sensitivity))

    def round_metrics(self) -> dict:
        return {"finalize_time_s": self.last_finalize_s}


class SAServerManager(FedMLServerManager):
    """PK collection and broadcast, encrypted share relay, active-set
    announcement, reveal collection."""

    def __init__(self, cfg, aggregator: SAAggregator, backend: Optional[str] = None, logger=None):
        super().__init__(cfg, aggregator, backend=backend, logger=logger, secure="shamir")
        if self.per_round != len(self.client_ids):
            raise ValueError(
                "Shamir SecAgg requires full participation per round "
                f"(client_num_per_round={self.per_round} != N={len(self.client_ids)}); "
                "the pairwise-mask topology is over all N clients")
        self.n = cfg.client_num_in_total
        self.pk_table: dict[int, tuple[int, int]] = {}
        # share_box[dest] = {src: (b_share_enc, sk_share_enc)}
        self.share_box: dict[int, dict[int, tuple[int, int]]] = {v: {} for v in self.client_ids}
        self.active_first: list[int] = []
        self._phase = "model"  # model -> reveal

    def register_message_receive_handlers(self) -> None:
        super().register_message_receive_handlers()
        self.register_message_receive_handler(MSG_TYPE_C2S_PUBLIC_KEY, self.handle_message_public_key)
        self.register_message_receive_handler(MSG_TYPE_C2S_SECRET_SHARES,
                                              self.handle_message_secret_shares)
        self.register_message_receive_handler(MSG_TYPE_C2S_SHARE_REVEAL, self.handle_message_reveal)

    def handle_message_public_key(self, msg: Message) -> None:
        """Collect every client's (c_pk, s_pk); broadcast the table once
        complete."""
        with self._agg_lock:
            self.pk_table[msg.get_sender_id()] = (int(msg.get(MSG_ARG_KEY_C_PK)),
                                                  int(msg.get(MSG_ARG_KEY_S_PK)))
            self.aggregator.s_pk_table = {u: pk[1] for u, pk in self.pk_table.items()}
            complete = len(self.pk_table) == self.n
        if complete:
            table = {str(u): [int(c), int(s)] for u, (c, s) in self.pk_table.items()}
            for cid in self.client_ids:
                out = Message(MSG_TYPE_S2C_PUBLIC_KEYS, 0, cid)
                out.add_params(MSG_ARG_KEY_PK_TABLE, table)
                self.send_message(out)

    def handle_message_secret_shares(self, msg: Message) -> None:
        """Store and forward: client u's encrypted share for peer v goes to v
        only."""
        src = msg.get_sender_id()
        b_enc = np.asarray(msg.get(MSG_ARG_KEY_B_SHARES), dtype=np.int64)
        sk_enc = np.asarray(msg.get(MSG_ARG_KEY_SK_SHARES), dtype=np.int64)
        with self._agg_lock:
            for v in self.client_ids:
                self.share_box[v][src] = (int(b_enc[v - 1]), int(sk_enc[v - 1]))
            ready = all(len(self.share_box[v]) == self.n for v in self.client_ids)
        if ready:
            for v in self.client_ids:
                out = Message(MSG_TYPE_S2C_PEER_SHARES, 0, v)
                out.add_params(MSG_ARG_KEY_B_SHARES,
                               {str(u): b for u, (b, _) in self.share_box[v].items()})
                out.add_params(MSG_ARG_KEY_SK_SHARES,
                               {str(u): s for u, (_, s) in self.share_box[v].items()})
                self.send_message(out)

    def handle_message_receive_model(self, msg: Message) -> None:
        with self._agg_lock:
            if msg.get(md.MSG_ARG_KEY_ROUND_INDEX) != self.round_idx or self._phase != "model":
                return
            sender = int(msg.get_sender_id())
            if self.recovered_step is not None and (
                    not self._init_sent or self.aggregator.has_received(sender)):
                # a server rebuilt from its journal: an upload this life did
                # not ask for (its predecessor's, drained from the queue
                # before the first dispatch), or a second one a round, would
                # close the round early or fold its masks twice.  A server
                # never recovered counts them, as the reference's does
                return
            self._round_payload_bytes += int(msg.wire_nbytes)
            meta = msg.get_control(MSG_ARG_KEY_SECAGG_META)
            if meta is not None:
                self.aggregator.add_masked_upload(
                    msg.get_sender_id(), msg.get(md.MSG_ARG_KEY_MODEL_PARAMS),
                    float(msg.get(md.MSG_ARG_KEY_NUM_SAMPLES)), meta)
            else:
                self.aggregator.add_local_trained_result(
                    msg.get_sender_id(), msg.get(md.MSG_ARG_KEY_MODEL_PARAMS),
                    float(msg.get(md.MSG_ARG_KEY_NUM_SAMPLES)))
            # permanently excluded clients never count toward the expectation
            expected = len([c for c in self.selected if c not in self.aggregator.compromised])
            if self.aggregator.check_whether_all_receive(expected):
                self._request_reveals()

    def _request_reveals(self) -> None:
        """Freeze the survivor set, announce it, collect reveals.  Caller
        holds _agg_lock."""
        self._runtime.cancel(self, "straggler")
        self._phase = "reveal"
        self.active_first = self.aggregator.survivor_ids()
        for cid in self.active_first:
            out = Message(MSG_TYPE_S2C_ACTIVE_SET, 0, cid)
            out.add_params(MSG_ARG_KEY_ACTIVE_SET, [int(c) for c in self.active_first])
            out.add_params(md.MSG_ARG_KEY_ROUND_INDEX, self.round_idx)
            self.send_message(out)
        self._arm_straggler_timer()

    def handle_message_reveal(self, msg: Message) -> None:
        with self._agg_lock:
            if msg.get(md.MSG_ARG_KEY_ROUND_INDEX) != self.round_idx or self._phase != "reveal":
                return
            self.aggregator.add_reveal(msg.get_sender_id(), msg.get(MSG_ARG_KEY_B_REVEALS),
                                       msg.get(MSG_ARG_KEY_SK_REVEALS))
            if self.aggregator.reveal_count() >= len(self.active_first):
                self._phase = "model"
                self._finish_round()

    def _on_straggler_timeout(self) -> None:
        """Model phase: advance with a quorum; reveal phase: reconstruct as
        soon as T+1 reveals arrived."""
        with self._agg_lock:
            if self._phase == "model":
                eligible = [c for c in self.selected if c not in self.aggregator.compromised]
                if len(eligible) < self.aggregator.t + 1:
                    self.failed = (
                        f"only {len(eligible)} eligible clients remain but reconstruction needs "
                        f"T+1={self.aggregator.t + 1}; the run cannot make progress")
                    log.error(self.failed)
                    self.send_finish()
                    return
                need = max(self.aggregator.t + 1, int(math.ceil(self.quorum_frac * len(eligible))))
                if self.aggregator.received_count() >= need:
                    log.warning("round %d: straggler timeout, proceeding with %d/%d masked models",
                                self.round_idx, self.aggregator.received_count(),
                                len(self.selected))
                    self._request_reveals()
                    return
            elif self.aggregator.reveal_count() >= self.aggregator.t + 1:
                log.warning("round %d: reveal-phase timeout, reconstructing from %d/%d reveals",
                            self.round_idx, self.aggregator.reveal_count(), len(self.active_first))
                self._phase = "model"
                self._finish_round()
                return
            self._arm_straggler_timer()


class SAClientManager(ClientMasterManager):
    """Key generation and share-out once, then per round: train, mask,
    upload; reveal on request."""

    def __init__(self, cfg, trainer: FedMLTrainer, rank: int, backend: Optional[str] = None):
        super().__init__(cfg, trainer, rank=rank, backend=backend)
        self.t, self.q_bits = shamir_secagg_params(cfg)
        self.n = cfg.client_num_in_total
        self.stream = bool(cfg_extra(cfg, "secagg_stream"))
        self.ring = secagg_stream.ring_for(
            codecs.codec_from_config(cfg), self.n, q_bits=self.q_bits,
            q8_frac_bits=int(cfg_extra(cfg, "secagg_q8_frac_bits")))
        self.c_sk, self.c_pk = dh_keypair()
        self.s_sk, self.s_pk = dh_keypair()
        self.b_u = int.from_bytes(os.urandom(8), "little") % (2**31)
        self.pk_table: dict[int, tuple[int, int]] = {}
        # held_shares[u] = (b_share_y, sk_share_y) with x = own rank
        self.held_shares: dict[int, tuple[int, int]] = {}
        self._setup_done = threading.Event()
        self._pending_msg: Optional[Message] = None
        self._lock = threading.Lock()
        self._shared_out = False

    def register_message_receive_handlers(self) -> None:
        super().register_message_receive_handlers()
        self.register_message_receive_handler(MSG_TYPE_S2C_PUBLIC_KEYS, self.handle_message_pk_table)
        self.register_message_receive_handler(MSG_TYPE_S2C_PEER_SHARES,
                                              self.handle_message_peer_shares)
        self.register_message_receive_handler(MSG_TYPE_S2C_ACTIVE_SET,
                                              self.handle_message_active_set)

    def _train_and_send(self, msg: Message) -> None:
        """INIT/SYNC: run the setup on the first round, then train and mask."""
        with self._lock:
            self._pending_msg = msg
        if not self._setup_done.is_set():
            if not self.pk_table:
                out = Message(MSG_TYPE_C2S_PUBLIC_KEY, self.rank, 0)
                out.add_params(MSG_ARG_KEY_C_PK, int(self.c_pk))
                out.add_params(MSG_ARG_KEY_S_PK, int(self.s_pk))
                self.send_message(out)
            # else the peer shares are in flight; their handler trains
            return
        self._train_masked()

    def handle_message_pk_table(self, msg: Message) -> None:
        """Share b_u and s_sk once, each share encrypted for its peer."""
        with self._lock:
            # re-sharing under a fresh polynomial would leave peers with
            # shares of different polynomials: share out exactly once
            if self._shared_out:
                return
            self._shared_out = True
        try:
            self._share_out(msg)
        except Exception:
            with self._lock:
                self._shared_out = False
            raise

    def _share_out(self, msg: Message) -> None:
        table = msg.get(MSG_ARG_KEY_PK_TABLE)
        self.pk_table = {int(u): (int(v[0]), int(v[1])) for u, v in table.items()}
        rs = np.random.RandomState(int.from_bytes(os.urandom(4), "little"))
        b_shares = shamir_share(self.b_u, self.n, self.t + 1, rs)
        sk_shares = shamir_share(self.s_sk, self.n, self.t + 1, rs)
        b_enc = np.zeros(self.n, dtype=np.int64)
        sk_enc = np.zeros(self.n, dtype=np.int64)
        for v in range(1, self.n + 1):
            pad_b, pad_sk = _share_pad(dh_agree(self.c_sk, self.pk_table[v][0]), self.rank, v)
            b_enc[v - 1] = (b_shares[v - 1][1] + pad_b) % P
            sk_enc[v - 1] = (sk_shares[v - 1][1] + pad_sk) % P
        out = Message(MSG_TYPE_C2S_SECRET_SHARES, self.rank, 0)
        out.add_params(MSG_ARG_KEY_B_SHARES, b_enc)
        out.add_params(MSG_ARG_KEY_SK_SHARES, sk_enc)
        self.send_message(out)

    def handle_message_peer_shares(self, msg: Message) -> None:
        b_enc = msg.get(MSG_ARG_KEY_B_SHARES)
        sk_enc = msg.get(MSG_ARG_KEY_SK_SHARES)
        with self._lock:
            for u_str, b in b_enc.items():
                u = int(u_str)
                pad_b, pad_sk = _share_pad(dh_agree(self.c_sk, self.pk_table[u][0]), u, self.rank)
                self.held_shares[u] = ((int(b) - pad_b) % P, (int(sk_enc[u_str]) - pad_sk) % P)
            ready = len(self.held_shares) == self.n
        if ready:
            self._setup_done.set()
            self._train_masked()

    def masked_upload(self, new_vars: dict, round_idx: int, global_vars: dict) -> tuple:
        """``(wire array, secagg meta or None)`` of the trained variables
        (under the qsgd8 ring, of their delta against ``global_vars``, the
        received global)."""
        flat = weights.flatten_reference(new_vars)[0].cpu().numpy()  # the one d2h copy
        peer_seeds = {v: derive_round_seed(dh_agree(self.s_sk, self.pk_table[v][1]), round_idx)
                      for v in self.pk_table if v != self.rank}
        ring = self.ring if self.stream else None
        base = seed = None
        if ring is not None and ring.codec == "qsgd8":
            base = weights.flatten_reference(global_vars)[0].cpu().numpy()
            seed = [int(self.cfg.random_seed), int(round_idx), int(self.rank)]
        return mask_upload(flat, self.rank, peer_seeds, derive_round_seed(self.b_u, round_idx),
                           self.q_bits, ring, base=base, seed=seed)

    def _train_masked(self) -> None:
        with self._lock:
            msg, self._pending_msg = self._pending_msg, None
        if msg is None:
            return
        round_idx = int(msg.get(md.MSG_ARG_KEY_ROUND_INDEX))
        params = msg.get(md.MSG_ARG_KEY_MODEL_PARAMS)
        client_idx = int(msg.get(md.MSG_ARG_KEY_CLIENT_INDEX, self.rank - 1))
        global_vars = self.to_device(params)
        new_vars, n_samples = self.trainer.train(global_vars, round_idx, self.seed_key,
                                                 client_idx)
        self.rounds_trained += 1
        payload, meta = self.masked_upload(new_vars, round_idx, global_vars)
        reply = Message(md.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER, self.rank, 0)
        reply.add_params(md.MSG_ARG_KEY_MODEL_PARAMS, payload)
        if meta is not None:
            reply.add_params(MSG_ARG_KEY_SECAGG_META, meta)
        reply.add_params(md.MSG_ARG_KEY_NUM_SAMPLES, n_samples)
        reply.add_params(md.MSG_ARG_KEY_ROUND_INDEX, round_idx)
        self.send_message(reply)

    def handle_message_active_set(self, msg: Message) -> None:
        """Reveal b-shares of survivors and s_sk-shares of the dropped, never
        both for one peer."""
        active = {int(c) for c in msg.get(MSG_ARG_KEY_ACTIVE_SET)}
        with self._lock:
            b_rev = {str(u): y[0] for u, y in self.held_shares.items() if u in active}
            sk_rev = {str(u): y[1] for u, y in self.held_shares.items() if u not in active}
        reply = Message(MSG_TYPE_C2S_SHARE_REVEAL, self.rank, 0)
        reply.add_params(MSG_ARG_KEY_B_REVEALS, b_rev)
        reply.add_params(MSG_ARG_KEY_SK_REVEALS, sk_rev)
        reply.add_params(md.MSG_ARG_KEY_ROUND_INDEX, int(msg.get(md.MSG_ARG_KEY_ROUND_INDEX)))
        self.send_message(reply)


# -- builders ------------------------------------------------------------------

def build_sa_server(cfg, dataset, model, device, backend: Optional[str] = None,
                    global_vars=None, noise_sampler=None, logger=None) -> SAServerManager:
    from ..data.dataset import pad_eval_set
    from .server import eval_batch_size

    test_arrays = pad_eval_set(dataset.test_x, dataset.test_y, eval_batch_size(cfg))
    aggregator = SAAggregator(cfg, model, test_arrays, device, global_vars=global_vars,
                              noise_sampler=noise_sampler)
    return SAServerManager(cfg, aggregator, backend=backend, logger=logger)


def build_sa_client(cfg, dataset, model, rank: int, device, backend: Optional[str] = None,
                    perms=None) -> SAClientManager:
    ix = dataset.client_idx[rank - 1]
    trainer = FedMLTrainer(cfg, model, dataset.train_x[ix], dataset.train_y[ix], device,
                           perms=perms)
    return SAClientManager(cfg, trainer, rank=rank, backend=backend)


def build_shamir_secagg_process_group(cfg, dataset, model, device, backend: str = "INPROC",
                                      drop_ranks: frozenset = frozenset(), global_vars=None,
                                      perms=None, noise_sampler=None, logger=None):
    """``(server, clients)``: 1 server + N Shamir-SecAgg clients on the
    in-process fabric (or loopback TCP), not started.  ``drop_ranks``
    clients complete the setup (their pair masks are in the survivors'
    uploads) but never upload a model: the dropout case that reconstructs
    s_sk."""
    from ..comm.comm_manager import reset_in_memory_fabric
    from ..comm.tcp_backend import link_ports

    reset_in_memory_fabric(getattr(cfg, "run_id", "0"))
    server = build_sa_server(cfg, dataset, model, device, backend=backend,
                             global_vars=global_vars, noise_sampler=noise_sampler, logger=logger)
    clients = []
    for r in range(1, cfg.client_num_in_total + 1):
        c = build_sa_client(cfg, dataset, model, r, device, backend=backend, perms=perms)
        if r in drop_ranks:
            c._train_masked = lambda: None  # drops out before its model upload
        clients.append(c)
    link_ports([server, *clients])
    return server, clients


def run_shamir_secagg_process_group(cfg, dataset, model, device, backend: str = "INPROC",
                                    timeout: float = 600.0, drop_ranks: frozenset = frozenset(),
                                    **hooks):
    """1 server + N Shamir-SecAgg clients on threads over the in-process
    fabric; returns ``(history, server)``.  ``hooks``: ``global_vars``,
    ``perms``, ``noise_sampler``, ``logger``."""
    from . import run_group

    server, clients = build_shamir_secagg_process_group(cfg, dataset, model, device, backend,
                                                        drop_ranks=drop_ranks, **hooks)
    return run_group(server, clients, timeout), server
