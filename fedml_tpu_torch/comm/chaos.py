"""Deterministic chaos injection at the comm boundary (the port of
``fedml_tpu/comm/chaos.py``).

A :class:`ChaosCommManager` wraps a comm manager (in-process or TCP) and
applies a seeded fault schedule to every send:

====================  =====================================================
fault                 observable effect
====================  =====================================================
``drop``              the frame vanishes (the sender sees success)
``delay``             delivered late (uniform in (0, chaos_delay_max_s])
``duplicate``         delivered twice
``reorder``           held back, delivered after the next frame to the peer
``corrupt``           ships truncated: dies in the receive loop's drop path
``reset``             ``ConnectionResetError`` at the sender
``partition``         every send in a timed window fails like ``reset``
====================  =====================================================

Each decision draws from numpy's ``default_rng([seed, sender, receiver,
nonce])``, ``nonce`` the per-receiver send ordinal, six rolls in a fixed
order: the same seed over the same message sequence gives the reference's
schedule bit for bit.  Every injection lands in :attr:`schedule` (``(fault,
receiver, nonce)``, the reference's record) and :attr:`injected`;
:attr:`schedule_types` holds the message type of each entry, and
:attr:`sends` counts the sends that passed (the reference's
``fedml_chaos_sends_total``).

Gated on the ``extra.chaos_*`` flags: every probability zero and no
partition window returns the inner manager itself from
:func:`wrap_with_chaos`.  The nonce counter and the hold-back slots change
under a lock; the transport sends run outside it.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Optional

import numpy as np

from ..core.flags import cfg_extra
from .base import BaseCommunicationManager
from .message import Message

log = logging.getLogger("fedml_tpu_torch.comm.chaos")

__all__ = ["ChaosConfig", "ChaosCommManager", "chaos_from_config", "wrap_with_chaos"]

#: faults whose frame reaches no handler
SILENT_LOSS_FAULTS = ("drop", "corrupt", "partition_lost")


class ChaosConfig:
    """Parsed ``extra.chaos_*`` flags; :meth:`from_config` returns ``None``
    when no fault is enabled."""

    __slots__ = ("seed", "drop", "delay", "delay_max_s", "duplicate", "reorder", "corrupt",
                 "reset", "partition")

    def __init__(self, *, seed: int = 0, drop: float = 0.0, delay: float = 0.0,
                 delay_max_s: float = 0.05, duplicate: float = 0.0, reorder: float = 0.0,
                 corrupt: float = 0.0, reset: float = 0.0,
                 partition: Optional[tuple[float, float]] = None):
        self.seed = int(seed)
        self.drop = float(drop)
        self.delay = float(delay)
        self.delay_max_s = float(delay_max_s)
        self.duplicate = float(duplicate)
        self.reorder = float(reorder)
        self.corrupt = float(corrupt)
        self.reset = float(reset)
        self.partition = partition  # (start_s, duration_s) after the wrapper's start

    @classmethod
    def from_config(cls, cfg: Any) -> Optional["ChaosConfig"]:
        if cfg is None:
            return None
        part_spec = cfg_extra(cfg, "chaos_partition")
        partition = None
        if part_spec:
            try:
                start_s, dur_s = (float(x) for x in str(part_spec).split(":"))
                partition = (start_s, dur_s)
            except ValueError:
                raise ValueError(f"chaos_partition must be 'start_s:duration_s', got "
                                 f"{part_spec!r}") from None
        obj = cls(seed=int(cfg_extra(cfg, "chaos_seed")),
                  drop=float(cfg_extra(cfg, "chaos_drop_prob")),
                  delay=float(cfg_extra(cfg, "chaos_delay_prob")),
                  delay_max_s=float(cfg_extra(cfg, "chaos_delay_max_s")),
                  duplicate=float(cfg_extra(cfg, "chaos_duplicate_prob")),
                  reorder=float(cfg_extra(cfg, "chaos_reorder_prob")),
                  corrupt=float(cfg_extra(cfg, "chaos_corrupt_prob")),
                  reset=float(cfg_extra(cfg, "chaos_reset_prob")),
                  partition=partition)
        return obj if obj.active() else None

    def active(self) -> bool:
        return bool(self.partition) or any(
            p > 0.0 for p in (self.drop, self.delay, self.duplicate, self.reorder,
                              self.corrupt, self.reset))


class ChaosCommManager(BaseCommunicationManager):
    """Seeded fault-injecting wrapper over a comm manager; other attributes
    go to the inner manager."""

    def __init__(self, inner: BaseCommunicationManager, chaos: ChaosConfig, rank: int):
        self.inner = inner
        self.chaos = chaos
        self.rank = int(rank)
        self._lock = threading.Lock()
        self._nonce: dict[int, int] = {}
        self._held: dict[int, Message] = {}
        self._t0 = time.monotonic()
        #: (fault, receiver, nonce) of every injection, in order
        self.schedule: list[tuple[str, int, int]] = []
        #: the message type of each :attr:`schedule` entry
        self.schedule_types: list[int] = []
        self.injected: dict[str, int] = {}
        self.sends = 0

    def _note(self, fault: str, rid: int, nonce: int, msg: Message) -> None:
        with self._lock:
            self.schedule.append((fault, rid, nonce))
            self.schedule_types.append(int(msg.get_type()))
            self.injected[fault] = self.injected.get(fault, 0) + 1

    def injected_of_type(self, fault: str, msg_type: int) -> int:
        """Injections of ``fault`` on messages of ``msg_type``."""
        with self._lock:
            return sum(1 for (f, _, _), t in zip(self.schedule, self.schedule_types)
                       if f == fault and t == msg_type)

    def silent_losses(self) -> int:
        """Frames no handler will see (drop, corrupt, partition-lost)."""
        with self._lock:
            return sum(self.injected.get(f, 0) for f in SILENT_LOSS_FAULTS)

    def _in_partition(self) -> bool:
        if not self.chaos.partition:
            return False
        start_s, dur_s = self.chaos.partition
        dt = time.monotonic() - self._t0
        return start_s <= dt < start_s + dur_s

    def send_message(self, msg: Message) -> None:
        rid = int(msg.get_receiver_id())
        with self._lock:
            self._nonce[rid] = nonce = self._nonce.get(rid, 0) + 1
            held = self._held.pop(rid, None)
            self.sends += 1
        rng = np.random.default_rng([self.chaos.seed, self.rank, rid, nonce])
        # one roll per fault class, in a fixed order: the schedule is a pure
        # function of (seed, sender, receiver, nonce)
        rolls = rng.random(6)
        try:
            if self._in_partition():
                # the network is down: the held frame is lost silently, the
                # current send fails loudly
                if held is not None:
                    self._note("partition_lost", rid, nonce, held)
                self._note("partition", rid, nonce, msg)
                raise ConnectionResetError(f"chaos: partition window active (peer {rid})")
            if rolls[0] < self.chaos.reset:
                self._note("reset", rid, nonce, msg)
                raise ConnectionResetError(f"chaos: connection reset (peer {rid})")
            if rolls[1] < self.chaos.drop:
                self._note("drop", rid, nonce, msg)
                return
            if rolls[2] < self.chaos.corrupt:
                self._note("corrupt", rid, nonce, msg)
                self._send_corrupt(msg, rid, rng)
                return
            if rolls[3] < self.chaos.duplicate:
                self._note("duplicate", rid, nonce, msg)
                self.inner.send_message(msg)
                self.inner.send_message(msg)
                return
            if rolls[4] < self.chaos.reorder:
                self._note("reorder", rid, nonce, msg)
                with self._lock:
                    if self._held.get(rid) is None:
                        self._held[rid] = msg
                        return
                # the hold-back slot is taken: deliver normally
                self.inner.send_message(msg)
                return
            if rolls[5] < self.chaos.delay:
                self._note("delay", rid, nonce, msg)
                delay_s = float(rng.random()) * self.chaos.delay_max_s
                t = threading.Timer(delay_s, self._send_late, args=(msg,))
                t.daemon = True
                t.start()
                return
            self.inner.send_message(msg)
        finally:
            # the held-back frame goes out after the current one (that is
            # the reorder), unless the partition claimed it
            if held is not None and not self._in_partition():
                try:
                    self.inner.send_message(held)
                except Exception:
                    log.warning("chaos: flushing held frame to %d failed", rid, exc_info=True)

    def _send_corrupt(self, msg: Message, rid: int, rng) -> None:
        """Ship a truncated encoding, so the receiver's decode dies in its
        receive loop's drop path; a backend without a raw send drops it."""
        send_raw = getattr(self.inner, "send_raw", None)
        if send_raw is None:
            return
        data = msg.encode()
        cut = max(1, int(len(data) * (0.25 + 0.5 * float(rng.random()))))
        try:
            send_raw(rid, bytes(data[:cut]))
        except Exception:
            log.warning("chaos: corrupt-frame send to %d failed", rid, exc_info=True)

    def _send_late(self, msg: Message) -> None:
        try:
            self.inner.send_message(msg)
        except Exception:
            log.warning("chaos: delayed send failed", exc_info=True)

    def add_observer(self, observer) -> None:
        self.inner.add_observer(observer)

    def handle_receive_message(self) -> None:
        self.inner.handle_receive_message()

    def stop_receive_message(self) -> None:
        # flush the hold-backs, so a clean shutdown strands no frame
        with self._lock:
            held = list(self._held.items())
            self._held.clear()
        for _rid, msg in held:
            try:
                self.inner.send_message(msg)
            except Exception:
                pass
        self.inner.stop_receive_message()

    def __getattr__(self, name: str):
        return getattr(self.inner, name)


def chaos_from_config(cfg: Any) -> Optional[ChaosConfig]:
    return ChaosConfig.from_config(cfg)


def wrap_with_chaos(inner: BaseCommunicationManager, cfg: Any,
                    rank: int) -> BaseCommunicationManager:
    """``inner`` itself when no ``chaos_*`` fault is set, else the seeded
    wrapper."""
    chaos = chaos_from_config(cfg)
    if chaos is None:
        return inner
    log.info("chaos: wrapping %s (rank %d, seed %d)", type(inner).__name__, rank, chaos.seed)
    return ChaosCommManager(inner, chaos, rank)
