"""FHE-encrypted cross-silo aggregation (the port of
``fedml_tpu/cross_silo/fhe.py``, FedML-HE).

Clients encrypt their 1/n-scaled models under a shared RLWE context
(``trust/fhe/rlwe.py``), the server adds the ciphertexts, never holding an
individual plaintext update, and decrypts only the aggregate.  The message
flow is the plain FedAvg protocol; only the upload's form changes::

    INIT(plaintext global)           server -> clients
    enc(model_i / n)                 client -> server     (int64 (B, 2, N) blocks)
    SYNC(plaintext mean)             server -> clients

The flat vector is the reference's (``weights.flatten_reference``: flax
layout, JAX leaf order), moved to the host once per upload and encrypted
in float64 there; the decrypted mean goes back to the server's device once
a round.  The RLWE arithmetic is host numpy, as in the reference (it has no
kernel).  The key comes from ``extra.fhe_key_seed`` (default
``random_seed * 7919 + 17``): the reference's shared-context threat model,
where the server sees aggregates only.

The round takes every client (the 1/n scaling assumes all n); when the
straggler quorum closes a round on k < n, the mean is rescaled by n/k after
decryption.  No streaming fold: ciphertexts are not foldable f32 trees.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from .. import weights
from ..comm.message import Message
from ..core.flags import cfg_extra
from ..trust.fhe.rlwe import RLWECipher, RLWEParams, add_ciphertexts
from . import message_define as md
from .client import ClientMasterManager, FedMLTrainer
from .server import FedMLAggregator, FedMLServerManager

log = logging.getLogger("fedml_tpu_torch.cross_silo.fhe")


def fhe_cipher(cfg) -> RLWECipher:
    """The run's shared cipher (its encryption draws from OS entropy)."""
    key_seed = int(cfg_extra(cfg, "fhe_key_seed", cfg.random_seed * 7919 + 17))
    params = RLWEParams(n=int(cfg_extra(cfg, "fhe_ring_dim")),
                        frac_bits=int(cfg_extra(cfg, "fhe_frac_bits")))
    return RLWECipher(params, key_seed=key_seed)


def check_fhe_compatible(cfg) -> None:
    """The reference's refusals: trust features need individual updates,
    and FHE yields only the uniform mean."""
    incompatible = [f for f in ("enable_attack", "enable_defense", "enable_dp",
                                "enable_contribution", "enable_secagg")
                    if getattr(cfg, f, False)]
    if incompatible:
        raise NotImplementedError(
            f"trust features {incompatible} need individual client updates, which FHE "
            "aggregation hides from the server; disable them or disable enable_fhe")
    if getattr(cfg, "federated_optimizer", "FedAvg") not in ("FedAvg", "fedavg", "FedAvg_seq"):
        raise NotImplementedError(
            "FHE aggregation yields only the uniform mean of updates (the reference scales "
            f"by 1/n before encryption); server optimizer {cfg.federated_optimizer!r} needs "
            "plaintext updates")


class FHEAggregator(FedMLAggregator):
    """Holds the round's ciphertext stacks; the aggregate is their
    homomorphic sum, decrypted."""

    def __init__(self, cfg, model, test_arrays, device, global_vars=None):
        check_fhe_compatible(cfg)
        super().__init__(cfg, model, test_arrays, device, global_vars=global_vars)
        self.stream_mode = False  # ciphertexts never take the f32 fold
        self.cipher = fhe_cipher(cfg)
        flat, self._unravel = weights.flatten_reference(self.global_vars)
        self.model_dim = int(flat.numel())

    def add_local_trained_result(self, client_idx: int, blocks, sample_num: float,
                                 is_delta: bool = False) -> None:
        arr = np.asarray(blocks, dtype=np.int64)  # (B, 2, N)
        if arr.ndim != 3 or arr.shape[1] != 2 or arr.shape[2] != self.cipher.params.n:
            raise ValueError(f"bad ciphertext stack shape {arr.shape}")
        self.model_dict[client_idx] = arr
        self.sample_num_dict[client_idx] = sample_num
        self.flag_client_model_uploaded[client_idx] = True

    def aggregate(self, round_idx: int):
        ids = sorted(self.model_dict)
        summed = add_ciphertexts([list(self.model_dict[i]) for i in ids], self.cipher.params.q)
        mean = self.cipher.decrypt_vector(summed, self.model_dim)
        n = self.cfg.client_num_in_total
        if len(ids) != n:
            # the clients scaled by 1/n: a quorum of k gives sum / n
            log.warning("FHE round %d: %d/%d survivors, rescaling by n/k", round_idx, len(ids), n)
            mean = mean * (n / max(len(ids), 1))
        self.global_vars = self._unravel(
            torch.from_numpy(mean.astype(np.float32)).to(self.device))
        self._reset_round()
        return self.global_vars


class FHEServerManager(FedMLServerManager):
    def __init__(self, cfg, aggregator: FHEAggregator, backend: Optional[str] = None,
                 logger=None):
        super().__init__(cfg, aggregator, backend=backend, logger=logger, secure="fhe")
        if self.per_round != len(self.client_ids):
            raise ValueError(
                "FHE aggregation requires full participation per round: the 1/n scaling "
                f"clients apply before encryption assumes all n={len(self.client_ids)} "
                f"contribute (client_num_per_round={self.per_round})")


class FHEClientManager(ClientMasterManager):
    """Trains, then uploads ``enc(flat / n)`` (float64 on the host).

    Its upload is the reference's FHE client's: the ciphertexts, the sample
    count and the round, with no session epoch, no upload key and no client
    journal write (``extra.client_journal_dir`` is taken and holds nothing,
    so a restarted silo joins the next dispatch); a failed send is retried
    as the base client's upload is."""

    def __init__(self, cfg, trainer: FedMLTrainer, rank: int, backend: Optional[str] = None):
        check_fhe_compatible(cfg)
        super().__init__(cfg, trainer, rank=rank, backend=backend)
        self.cipher = fhe_cipher(cfg)
        self.n = cfg.client_num_in_total

    def _train_and_send(self, msg: Message) -> None:
        if self._killed:
            return
        round_idx = int(msg.get(md.MSG_ARG_KEY_ROUND_INDEX))
        params = msg.get(md.MSG_ARG_KEY_MODEL_PARAMS)
        client_idx = int(msg.get(md.MSG_ARG_KEY_CLIENT_INDEX, self.rank - 1))
        global_vars = self.to_device(params)
        new_vars, n_samples = self.trainer.train(global_vars, round_idx, self.seed_key,
                                                 client_idx)
        self.rounds_trained += 1
        reply = Message(md.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER, self.rank, 0)
        reply.add_params(md.MSG_ARG_KEY_MODEL_PARAMS,
                         self.upload_payload(new_vars, global_vars, round_idx)[0])
        reply.add_params(md.MSG_ARG_KEY_NUM_SAMPLES, n_samples)
        reply.add_params(md.MSG_ARG_KEY_ROUND_INDEX, round_idx)
        self._send_with_reconnect(reply, seed_extra=round_idx)

    def upload_payload(self, new_vars: dict, global_vars: dict, round_idx: int) -> tuple:
        """``enc(flat / n)`` as int64 ``(B, 2, N)`` blocks, never a delta."""
        flat = weights.flatten_reference(new_vars)[0].cpu().numpy()
        blocks = self.cipher.encrypt_vector(np.asarray(flat, np.float64) / self.n)
        return np.stack(blocks), False


# -- builders ------------------------------------------------------------------

def build_fhe_server(cfg, dataset, model, device, backend: Optional[str] = None,
                     global_vars=None, logger=None) -> FHEServerManager:
    from ..data.dataset import pad_eval_set
    from .server import eval_batch_size

    test_arrays = pad_eval_set(dataset.test_x, dataset.test_y, eval_batch_size(cfg))
    aggregator = FHEAggregator(cfg, model, test_arrays, device, global_vars=global_vars)
    return FHEServerManager(cfg, aggregator, backend=backend, logger=logger)


def build_fhe_client(cfg, dataset, model, rank: int, device, backend: Optional[str] = None,
                     perms=None) -> FHEClientManager:
    ix = dataset.client_idx[rank - 1]
    trainer = FedMLTrainer(cfg, model, dataset.train_x[ix], dataset.train_y[ix], device,
                           perms=perms)
    return FHEClientManager(cfg, trainer, rank=rank, backend=backend)


def build_fhe_process_group(cfg, dataset, model, device, backend: str = "INPROC",
                            global_vars=None, perms=None, logger=None):
    """``(server, clients)``: 1 server + N FHE clients, not started."""
    from ..comm.comm_manager import reset_in_memory_fabric
    from ..comm.tcp_backend import link_ports

    reset_in_memory_fabric(getattr(cfg, "run_id", "0"))
    server = build_fhe_server(cfg, dataset, model, device, backend=backend,
                              global_vars=global_vars, logger=logger)
    clients = [build_fhe_client(cfg, dataset, model, r, device, backend=backend, perms=perms)
               for r in range(1, cfg.client_num_in_total + 1)]
    link_ports([server, *clients])
    return server, clients


def run_fhe_process_group(cfg, dataset, model, device, backend: str = "INPROC",
                          timeout: float = 600.0, **hooks):
    """1 server + N FHE clients on threads; returns ``(history, server)``.
    ``hooks``: ``global_vars``, ``perms``, ``logger``."""
    from . import run_group

    server, clients = build_fhe_process_group(cfg, dataset, model, device, backend, **hooks)
    return run_group(server, clients, timeout), server
