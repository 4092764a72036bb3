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

Refused with ``NotImplementedError`` when flagged: the client journal,
remote observability, the flight recorder, the AOT store and silo DP
(``enable_dp`` with ``dp_solution_type`` ``ldp`` on a plain client).
"""

from __future__ import annotations

import logging
import math
import threading
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

_UNPORTED_CLIENT_FLAGS = ("client_journal_dir", "enable_remote_obs", "flight_recorder",
                          "aot_programs")


#: the fold of the client key that seeds the upload codec's draws (a stream
#: apart from the training keys'; the reference's constant)
UPLOAD_NOISE_TAG = 0x5157


def refuse_unported_client(cfg) -> None:
    """Raise for a client feature this slice does not serve (and for an
    unknown codec name, as the reference does)."""
    codecs.codec_from_config(cfg)
    for flag in _UNPORTED_CLIENT_FLAGS:
        if cfg_extra(cfg, flag):
            raise NotImplementedError(f"extra.{flag} is not ported to the cross-silo client yet")


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
        round_idx = int(msg.get(md.MSG_ARG_KEY_ROUND_INDEX))
        params = msg.get(md.MSG_ARG_KEY_MODEL_PARAMS)
        client_idx = int(msg.get(md.MSG_ARG_KEY_CLIENT_INDEX, self.rank - 1))
        global_vars = self.to_device(params)
        new_vars, n_samples = self.trainer.train(global_vars, round_idx, self.seed_key,
                                                 client_idx)
        self.rounds_trained += 1
        reply = Message(md.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER, self.rank, 0)
        payload, is_delta = self.upload_payload(new_vars, global_vars, round_idx)
        reply.add_params(md.MSG_ARG_KEY_MODEL_PARAMS, payload)
        if is_delta:
            reply.add_params(md.MSG_ARG_KEY_MODEL_IS_DELTA, True)
        reply.add_params(md.MSG_ARG_KEY_NUM_SAMPLES, n_samples)
        reply.add_params(md.MSG_ARG_KEY_ROUND_INDEX, round_idx)
        self.send_message(reply)

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
        self.send_message(Message(md.MSG_TYPE_C2S_FINISHED, self.rank, 0))
        self.done.set()
        self.finish()
