"""Cross-silo FL client (the port of ``fedml_tpu/cross_silo/client.py``).

Handles check-status / init / sync messages, trains the local shard with the
port's local SGD on the device, uploads weights + sample count, honours the
finish protocol.  Models arrive and leave as numpy trees in flax layout.

Compressed uploads (``extra.comm_compression: qsgd8 | topk``): the reply
carries the **delta** against the global model it received, computed on
the device in f32 and cast back, relaid to flax layout on the device and
compressed leaf by leaf on the wire-v2 format (``comm/codecs.py``; qsgd8
through the quantize kernel, so only int8 values and f32 scales leave the
card), with ``model_is_delta`` set.  The draw is keyed
``fold_in(client_key(round_key(seed_key, r), rank), 0x5157)``, leaf ``i``
from ``fold_in(key, i)``, as the reference keys it; an ``upload_noise(round,
rank, i, shape, device)`` hook can supply it instead (tests hand in the
reference's).  The top-k residuals carry across rounds.  A codec failure
raises and fails the run: the reference uploads the raw model instead,
which here would hide a failed kernel (ROADMAP Queue 3).

:class:`FedMLTrainer` keeps its cyclic-padded shard on the device (in the
compute dtype, as the simulator does).  Its local SGD is keyed
``client_key(round_key(seed_key, r), client_idx)`` as the reference's is;
the per-epoch permutations can come from a ``perms(round_idx, client_idx,
epochs, cap)`` hook instead, so tests hand in the reference's.

Recovery (``extra.client_journal_dir``, ``cross_silo/client_journal.py``):
before each upload the client journals its state (residuals, round, epoch,
attempt counts) and then sends under the idempotence key
``<rank>:<round>:<epoch>:<attempt>``; a client built over an existing
journal resumes from it.  A server dispatch's session epoch is echoed in
the reply, and an epoch change counts a server restart.  An upload whose
send fails is retried on a capped exponential backoff with deterministic
jitter (``RECONNECT_TRIES``) before it is abandoned to the server's
straggler handling.  :meth:`ClientMasterManager.hard_kill` simulates a
crash.

Under the aggregation tree (``extra.hier_fanout`` / ``hier_topology``) a
model reply goes to the client's edge aggregator (``cross_silo/edge.py``);
status, FINISH and the rest stay with the root.

Refused with ``NotImplementedError`` when flagged: remote observability,
the flight recorder, the AOT store, and the client journal under Shamir
SecAgg (the reference's loses the keys) and FHE.  Under LightSecAgg the
client journal is taken and, as in the reference, holds nothing: its
client overrides the upload path that journals, and a restarted silo
joins the next round's fresh mask exchange.
"""

from __future__ import annotations

import logging
import math
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from .. import weights
from ..algorithms import hparams_from_config
from ..comm import codecs
from ..comm.comm_manager import FedMLCommManager
from ..comm.message import Message
from ..core import pytree as pt
from ..core import rng
from ..core.flags import cfg_extra
from ..fl.local_sgd import make_local_train_fn
from . import message_define as md

log = logging.getLogger("fedml_tpu_torch.cross_silo.client")

_UNPORTED_CLIENT_FLAGS = ("enable_remote_obs", "flight_recorder", "aot_programs")


#: the fold of the client key that seeds the upload codec's draws (a stream
#: apart from the training keys'; the reference's constant)
UPLOAD_NOISE_TAG = 0x5157

#: an upload whose send fails is retried this often, on a capped exponential
#: backoff from RECONNECT_BASE_S (the reference's values)
RECONNECT_TRIES = 5
RECONNECT_BASE_S = 0.05
RECONNECT_CAP_S = 2.0


def refuse_unported_client(cfg) -> None:
    """Raise for a client feature this slice does not serve (and for an
    unknown codec name, as the reference does)."""
    codecs.codec_from_config(cfg)
    for flag in _UNPORTED_CLIENT_FLAGS:
        if cfg_extra(cfg, flag):
            raise NotImplementedError(f"extra.{flag} is not ported to the cross-silo client yet")
    if cfg_extra(cfg, "client_journal_dir"):
        if getattr(cfg, "enable_secagg", False) and secagg_method(cfg) == "shamir":
            raise NotImplementedError(SHAMIR_CLIENT_JOURNAL_REFUSAL)


#: the reference's Shamir SecAgg client journals none of its key material (a
#: decided difference, ROADMAP Queue 3)
SHAMIR_CLIENT_JOURNAL_REFUSAL = (
    "extra.client_journal_dir under Shamir SecAgg: the reference's SecAgg client journals "
    "none of its key material (DH secrets, b_u, the peers' shares), so a silo restarted "
    "over its journal draws new keys and re-shares, and the survivors' pairwise masks no "
    "longer cancel: the reference's run completes with a wrong global; refused until the "
    "client journal carries the keys")


def secagg_method(cfg) -> str:
    """``"lightsecagg"`` or ``"shamir"``, from ``extra.secagg_method``."""
    method = str(cfg_extra(cfg, "secagg_method")).lower()
    if method in ("lightsecagg", "lsa"):
        return "lightsecagg"
    if method in ("shamir", "secagg", "pairwise"):
        return "shamir"
    raise ValueError(f"unknown secagg_method {method!r}; use 'lightsecagg' or 'shamir'")


def _leaf_delta(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """new - old per leaf: float leaves in f32, cast back; integer leaves
    natively, so the server's add-back reconstructs them exactly."""
    if new.is_floating_point():
        return (new.to(torch.float32) - old.to(torch.float32)).to(new.dtype)
    return new - old


class FedMLTrainer:
    """Local training operator (reference ``FedMLTrainer``) on ``device``."""

    def __init__(self, cfg, model, x: np.ndarray, y: np.ndarray, device,
                 perms: Optional[Callable] = None):
        cap = ((x.shape[0] + cfg.batch_size - 1) // cfg.batch_size) * cfg.batch_size
        reps = np.resize(np.arange(x.shape[0]), cap)
        tx = torch.from_numpy(np.ascontiguousarray(x[reps]))
        if cfg.compute_dtype == "bfloat16" and tx.is_floating_point():
            tx = tx.to(torch.bfloat16)  # the simulator's device-resident shard form
        self.x = tx.to(device)
        self.y = torch.from_numpy(np.ascontiguousarray(y[reps])).to(device, torch.long)
        self.count = int(x.shape[0])
        self.hp = hparams_from_config(cfg, steps_per_epoch=max(1, math.ceil(cap / cfg.batch_size)))
        self.perms = perms
        self._train = make_local_train_fn(model, self.hp)

    @property
    def trained_samples(self) -> int:
        """Samples a round's local SGD goes through (steps x batch)."""
        return self.hp.epochs * math.ceil(self.count / self.hp.batch_size) * self.hp.batch_size

    def train(self, global_vars: dict, round_idx: int, seed_key, client_idx: int = 0) -> tuple:
        """``(new variables on the device, sample count)`` from the global
        variables (the port's tree on the device)."""
        key = rng.client_key(rng.round_key(seed_key, round_idx), client_idx)
        perms = (self.perms(round_idx, client_idx, self.hp.epochs, self.x.shape[0])
                 if self.perms is not None else None)
        new_vars, _ = self._train(global_vars, self.x, self.y, self.count, key, perms=perms)
        return new_vars, float(self.count)


class ClientMasterManager(FedMLCommManager):
    def __init__(self, cfg, trainer: FedMLTrainer, rank: int, backend: Optional[str] = None):
        refuse_unported_client(cfg)
        super().__init__(cfg, rank=rank, size=cfg.client_num_in_total + 1, backend=backend)
        self.trainer = trainer
        self.device = trainer.x.device
        self.seed_key = rng.root_key(cfg.random_seed)
        self.done = threading.Event()
        self.rounds_trained = 0
        #: ``fn(reason, error)`` told when a handler raises (the process-group
        #: runner points it at the server's ``abort``)
        self.on_error: Optional[Callable] = None
        self.comm_codec = codecs.codec_from_config(cfg)
        self._comm_residuals = None
        # the aggregation tree (cross_silo/edge.py): model replies go to this
        # client's edge aggregator; status, FINISH and the rest stay with the
        # root.  Flat: 0, the bytes unchanged.
        from .edge import build_topology

        topo = build_topology(cfg)
        self._upload_dest = 0 if topo is None else topo.parent(rank)
        self._comm_ratio = float(cfg_extra(
            cfg, "comm_topk_ratio", getattr(cfg, "compression_ratio", 0.01) or 0.01))
        # an explicit comm_compress_min_size wins, then the trainer's own
        # floor (a low-rank tree), then the model-scale default
        min_elems = cfg_extra(cfg, "comm_compress_min_size", None)
        if min_elems is None:
            min_elems = getattr(trainer, "comm_compress_min_elems", None)
        self._comm_min_elems = int(
            min_elems if min_elems is not None else codecs.DEFAULT_MIN_COMPRESS_ELEMS)
        #: ``fn(round, rank, leaf, shape, device)``: the codec's uniform draws
        #: in place of the port's generators (module docstring)
        self.upload_noise: Optional[Callable] = None
        #: ``compress_pytree``'s stats of the last compressed upload
        self.last_upload_stats: Optional[dict] = None
        # the server's session epoch of the last dispatch, and the restarts
        # its changes revealed
        self._last_epoch: Optional[int] = None
        self.server_restarts_seen = 0
        from .client_journal import client_journal_from_config

        self.client_journal = client_journal_from_config(cfg, rank)
        self.resumed_from_journal = False
        #: "<round>:<epoch>" -> uploads sent for it (bounded, journaled)
        self._upload_attempts: dict[str, int] = {}
        #: crash-simulation latch: a killed client sends and journals nothing
        self._killed = False
        if self.client_journal is not None:
            self._client_journal_recover()

    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(md.MSG_TYPE_S2C_CHECK_CLIENT_STATUS,
                                              self.handle_message_check_status)
        self.register_message_receive_handler(md.MSG_TYPE_S2C_INIT_CONFIG,
                                              self.handle_message_init)
        self.register_message_receive_handler(md.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT,
                                              self.handle_message_receive_model)
        self.register_message_receive_handler(md.MSG_TYPE_S2C_FINISH,
                                              self.handle_message_finish)

    def receive_message(self, msg_type: int, msg: Message) -> None:
        try:
            super().receive_message(msg_type, msg)
        except OSError:
            raise  # a transport fault: the receive loop contains it
        except Exception as e:
            if self.on_error is not None:
                self.on_error(f"client {self.rank}: handler of message type {msg_type} "
                              f"raised {e!r}", e)
            raise

    def handle_message_check_status(self, msg: Message) -> None:
        reply = Message(md.MSG_TYPE_C2S_CLIENT_STATUS, self.rank, 0)
        reply.add_params(md.MSG_ARG_KEY_CLIENT_STATUS, md.CLIENT_STATUS_ONLINE)
        reply.add_params(md.MSG_ARG_KEY_CLIENT_OS, md.CLIENT_OS_PYTHON)
        self.send_message(reply)

    def handle_message_init(self, msg: Message) -> None:
        self._train_and_send(msg)

    def handle_message_receive_model(self, msg: Message) -> None:
        self._train_and_send(msg)

    def to_device(self, params) -> dict:
        """A flax-layout numpy tree off the wire -> the port's tree on the
        trainer's device."""
        return weights.to_torch(weights.flax_to_torch(params), self.device)

    def _train_and_send(self, msg: Message) -> None:
        if self._killed:
            return
        round_idx = int(msg.get(md.MSG_ARG_KEY_ROUND_INDEX))
        # control-only read (absent without the server's journal), echoed
        # back so the server's recovery fence can place the upload
        epoch = msg.get_control(md.MSG_ARG_KEY_SESSION_EPOCH)
        if epoch is not None:
            if self._last_epoch is not None and int(epoch) != self._last_epoch:
                self.server_restarts_seen += 1
                log.info("client %d: server session epoch %s -> %s (server restarted; "
                         "resuming)", self.rank, self._last_epoch, epoch)
            self._last_epoch = int(epoch)
        params = msg.get(md.MSG_ARG_KEY_MODEL_PARAMS)
        client_idx = int(msg.get(md.MSG_ARG_KEY_CLIENT_INDEX, self.rank - 1))
        global_vars = self.to_device(params)
        new_vars, n_samples = self.trainer.train(global_vars, round_idx, self.seed_key,
                                                 client_idx)
        self.rounds_trained += 1
        reply = Message(md.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER, self.rank, self._upload_dest)
        payload, is_delta = self.upload_payload(new_vars, global_vars, round_idx)
        reply.add_params(md.MSG_ARG_KEY_MODEL_PARAMS, payload)
        if is_delta:
            reply.add_params(md.MSG_ARG_KEY_MODEL_IS_DELTA, True)
        reply.add_params(md.MSG_ARG_KEY_NUM_SAMPLES, n_samples)
        reply.add_params(md.MSG_ARG_KEY_ROUND_INDEX, round_idx)
        if epoch is not None:
            reply.add_params(md.MSG_ARG_KEY_SESSION_EPOCH, int(epoch))
        if self.client_journal is not None:
            # journal before the send: each distinct piece of work ships
            # under its own key, every redelivery of it under the same
            attempt = self._next_upload_attempt(round_idx, epoch)
            self._client_journal_snapshot(round_idx)
            reply.add_params(md.MSG_ARG_KEY_UPLOAD_KEY,
                             f"{self.rank}:{round_idx}:{-1 if epoch is None else int(epoch)}:"
                             f"{attempt}")
        self._send_with_reconnect(reply, seed_extra=round_idx)

    # -- crash-recovery journal -------------------------------------------------
    def _next_upload_attempt(self, round_idx: int, epoch) -> int:
        """The ordinal of this (round, epoch)'s upload; the oldest entries
        go past ``MAX_ATTEMPT_ENTRIES``."""
        from .client_journal import MAX_ATTEMPT_ENTRIES

        k = f"{round_idx}:{-1 if epoch is None else int(epoch)}"
        n = self._upload_attempts.get(k, 0)
        self._upload_attempts[k] = n + 1
        while len(self._upload_attempts) > MAX_ATTEMPT_ENTRIES:
            self._upload_attempts.pop(next(iter(self._upload_attempts)))
        return n

    def _client_journal_snapshot(self, round_idx: int) -> None:
        """Commit the state this upload depends on (the codec's residual
        carry, round, epoch, attempt counts)."""
        if self.client_journal is None or self._killed:
            return
        from .client_journal import pack_client_state

        proto, arrays = pack_client_state(
            rank=self.rank, round_idx=round_idx, session_epoch=self._last_epoch,
            rounds_trained=self.rounds_trained, server_restarts_seen=self.server_restarts_seen,
            upload_attempts=self._upload_attempts, residuals=self._comm_residuals)
        try:
            self.client_journal.snapshot_state(proto, arrays)
        except OSError:
            # durability lost (disk full): the client trains on, and would
            # rejoin cold after a crash
            log.warning("client %d: journal snapshot failed; continuing without durability",
                        self.rank, exc_info=True)

    def _client_journal_recover(self) -> None:
        """Install the newest intact client snapshot: residuals (on the
        device), epoch, attempt counts."""
        from .client_journal import unpack_client_state

        snap = self.client_journal.restore_state()
        if snap is None:
            return
        state = unpack_client_state(snap)
        res = state["residuals"]
        self._comm_residuals = None if res is None else [
            None if r is None else torch.from_numpy(np.array(r)).to(self.device) for r in res]
        self._last_epoch = state["session_epoch"]
        self.rounds_trained = state["rounds_trained"]
        self.server_restarts_seen = state["server_restarts_seen"]
        self._upload_attempts = state["upload_attempts"]
        self.resumed_from_journal = True
        log.info("client %d: resumed from journal step %d (round %s, epoch %s, %d rounds "
                 "trained)", self.rank, snap["step"], state["round_idx"], state["session_epoch"],
                 state["rounds_trained"])

    def hard_kill(self) -> None:
        """Crash simulation: stop the receive loop and go silent, with no
        FINISH handshake and no journal write; a handler mid-train finishes
        its step but sends and journals nothing."""
        self._killed = True
        self.com_manager.stop_receive_message()

    def _send_with_reconnect(self, reply: Message, seed_extra: int = 0) -> None:
        """Send an upload, retrying a failed send on a capped exponential
        backoff with jitter seeded by the client and round; after
        ``RECONNECT_TRIES`` the upload is abandoned to the server's
        straggler handling."""
        from ..comm.base import BACKOFF_PURPOSE_RECONNECT, backoff_delay

        for attempt in range(RECONNECT_TRIES):
            if self._killed:
                return
            try:
                self.send_message(reply)
                return
            except OSError:
                if attempt + 1 >= RECONNECT_TRIES:
                    break
                delay = backoff_delay(attempt, base=RECONNECT_BASE_S, cap=RECONNECT_CAP_S,
                                      seed=self.rank * 1_000_003 + int(seed_extra),
                                      purpose=BACKOFF_PURPOSE_RECONNECT)
                log.warning("client %d: upload send failed (attempt %d/%d); reconnecting in "
                            "%.3fs", self.rank, attempt + 1, RECONNECT_TRIES, delay,
                            exc_info=True)
                time.sleep(delay)
        log.error("client %d: upload abandoned after %d reconnect attempts", self.rank,
                  RECONNECT_TRIES)

    def upload_payload(self, new_vars: dict, global_vars: dict, round_idx: int) -> tuple:
        """``(payload, is_delta)`` of a model reply: without a codec the
        trained variables (flax-layout numpy, the v1 bytes); with one the
        compressed delta against ``global_vars`` (the received global on the
        device).  The reference's ``_maybe_compress``, less its raw
        fallback: a codec failure raises."""
        if not self.comm_codec:
            return weights.torch_to_flax(weights.to_numpy(new_vars)), False
        delta = weights.tensors_to_flax(pt.tree_map(_leaf_delta, new_vars, global_vars))
        key = rng.fold_in(rng.client_key(rng.round_key(self.seed_key, round_idx), self.rank),
                          UPLOAD_NOISE_TAG)
        uniform = None
        if self.upload_noise is not None:
            def uniform(i, shape, device, hook=self.upload_noise):
                return hook(round_idx, self.rank, i, shape, device)
        payload, self._comm_residuals, self.last_upload_stats = codecs.compress_pytree(
            delta, self.comm_codec, key=key, residuals=self._comm_residuals,
            ratio=self._comm_ratio, min_elems=self._comm_min_elems, uniform=uniform)
        return payload, True

    def handle_message_finish(self, msg: Message) -> None:
        try:
            self.send_message(Message(md.MSG_TYPE_C2S_FINISHED, self.rank, 0))
        except OSError:
            # the ack is bookkeeping; over sockets the server may already be
            # gone
            log.debug("client %d: FINISHED ack undeliverable", self.rank)
        self.done.set()
        self.finish()
