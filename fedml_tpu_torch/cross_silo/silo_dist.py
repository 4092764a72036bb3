"""A silo that spans processes (the port of
``fedml_tpu/cross_silo/silo_dist.py``).

The reference's silo trains data-parallel over every process of a
``jax.distributed`` runtime while only its master (process 0) speaks the FL
protocol; GSPMD shards each minibatch over the global ``data`` axis and
inserts the gradient all-reduce.  Here the silo's processes are the ranks
of the gloo process group (``parallel/multihost.py``, one card may hold
them all), and the same is done by hand (``fl/local_sgd.make_local_train_fn``
with ``data_parallel``):

- every rank draws the same minibatch and trains on its contiguous
  ``batch / world`` rows of it;
- its loss is its rows' share of the global batch's mean, and the
  gradients are summed over the ranks (an all-reduce over host copies);
- BatchNorm takes its moments over the global batch: each rank's
  per-channel ``sum x``, ``sum x^2`` are summed by an autograd-aware
  all-reduce, so the fused backward (kernels 3-4) sees the global
  statistics (``models/resnet.global_batch_stats``).

So the spanning silo's numbers are the one-process silo's up to the order
of the f32 sums.

Only the master builds a client manager and speaks the protocol.  Before
each local train it broadcasts ``(TRAIN, round, client_idx)``, the global
variables and the permutation table (the ``perms`` hook's, or None) to the
followers, which run :func:`run_silo_follower`, the same local train in
lockstep; ``finish`` broadcasts ``FINISH`` once (idempotent: the followers
have gone after the first).  ``batch_size % world`` raises the reference's
``ValueError``; the secure protocols refuse a spanning silo with its
``NotImplementedError`` (``cross_silo/__init__.py``).
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

import numpy as np
import torch

from .. import weights
from ..core import rng
from ..fl.local_sgd import make_local_train_fn
from ..parallel import multihost
from .client import FedMLTrainer

log = logging.getLogger("fedml_tpu_torch.cross_silo.silo_dist")

CMD_TRAIN = 1
CMD_FINISH = 2

#: the reference's refusal of a spanning silo under SecAgg or FHE
SECURE_SPANNING_REFUSAL = ("multi-process silos are not wired into the secure-"
                           "aggregation clients; run the silo as one process")


def _batch_refusal(batch_size: int, world: int) -> Optional[str]:
    if batch_size % world != 0:
        return (f"distributed silo needs batch_size ({batch_size}) "
                f"divisible by the global device count ({world})")
    return None


def check_spanning_silo(cfg, secure: bool) -> None:
    """Raise for a spanning silo that cannot run, before its data is
    loaded: under a secure protocol, without its process count and id, or
    with a batch its processes do not split."""
    if secure:
        raise NotImplementedError(SECURE_SPANNING_REFUSAL)
    world = (multihost.process_count() if multihost.is_initialized()
             else multihost.configured_processes(cfg)[0])
    refusal = _batch_refusal(cfg.batch_size, world)
    if refusal:
        raise ValueError(refusal)


class DistributedSiloTrainer(FedMLTrainer):
    """The silo master's trainer (and each follower's): ``train()`` as
    :class:`FedMLTrainer`'s, over this rank's rows of every minibatch, the
    master first broadcasting the call to the followers."""

    def __init__(self, cfg, model, x: np.ndarray, y: np.ndarray, device,
                 perms: Optional[Callable] = None):
        if not multihost.is_multiprocess():
            raise RuntimeError(
                "DistributedSiloTrainer requires an initialized multi-process "
                "process group (call multihost.ensure_initialized)")
        world = multihost.process_count()
        refusal = _batch_refusal(cfg.batch_size, world)
        if refusal:
            raise ValueError(refusal)
        super().__init__(cfg, model, x, y, device, perms=perms)
        self._train = make_local_train_fn(
            model, self.hp, data_parallel=(multihost.process_index(), world))
        self._finished = False

    def train(self, global_vars: dict, round_idx: int, seed_key, client_idx: int = 0) -> tuple:
        perms = (self.perms(round_idx, client_idx, self.hp.epochs, self.x.shape[0])
                 if self.perms is not None else None)
        multihost.broadcast_one_to_all({
            "cmd": CMD_TRAIN, "round": int(round_idx), "client": int(client_idx),
            "variables": weights.to_numpy(global_vars),
            "perms": None if perms is None else np.asarray(perms)})
        return self._train_round(global_vars, round_idx, seed_key, client_idx, perms)

    def _train_round(self, global_vars, round_idx, seed_key, client_idx, perms) -> tuple:
        key = rng.client_key(rng.round_key(seed_key, round_idx), client_idx)
        if perms is not None:
            perms = torch.as_tensor(np.asarray(perms))
        new_vars, _ = self._train(global_vars, self.x, self.y, self.count, key, perms=perms)
        return new_vars, float(self.count)

    def finish(self) -> None:
        """Release the followers (the master, once the FL run has ended).
        Idempotent: the followers have left after the first ``FINISH``."""
        if self._finished:
            return
        self._finished = True
        multihost.broadcast_one_to_all({"cmd": CMD_FINISH})


def run_silo_follower(cfg, model, x: np.ndarray, y: np.ndarray, device) -> int:
    """A follower rank's loop: the master's local train in lockstep, on
    this rank's rows, until ``FINISH``.  Returns the rounds trained."""
    trainer = DistributedSiloTrainer(cfg, model, x, y, device)
    seed_key = rng.root_key(cfg.random_seed)
    rounds = 0
    while True:
        cmd = multihost.broadcast_one_to_all(None)
        if cmd["cmd"] == CMD_FINISH:
            log.info("silo follower: finish after %d rounds", rounds)
            return rounds
        global_vars = weights.to_torch(cmd["variables"], device)
        trainer._train_round(global_vars, cmd["round"], seed_key, cmd["client"], cmd["perms"])
        rounds += 1
