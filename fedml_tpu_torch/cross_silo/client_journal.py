"""Durable client recovery journal (the port of
``fedml_tpu/cross_silo/client_journal.py``).

- :class:`ClientJournal` is a :class:`~.journal.ServerJournal` scoped to
  ``<root>/client_<rank>`` with a local step sequence (the round is state
  inside the snapshot, not its address); its model half stays unused.
- Snapshot before send is the exactly-once protocol: the client commits
  ``(residuals, round, epoch, attempts)`` and only then sends the upload
  under the idempotence key ``<rank>:<round>:<epoch>:<attempt>``, so any
  redelivery of the same bytes (a chaos duplicate, a reconnect resend, a
  resend after a crash past the snapshot) carries the same key and the
  server folds it once.
- The error-feedback residuals are stored leaf by leaf exactly as the codec
  returned them (host numpy, f32), so a restarted client's next upload is
  bitwise its uncrashed twin's.

Gated on ``extra.client_journal_dir``: unset, no journal exists, no key is
stamped and the wire bytes are the journal-free ones.  The reference counts
resumes in its metrics registry (not ported): the client manager's
``resumed_from_journal`` says it here.
"""

from __future__ import annotations

import logging
import os
import re
import shutil
from typing import Any, Optional

import numpy as np

from ..core.flags import cfg_extra
from .journal import ServerJournal

log = logging.getLogger("fedml_tpu_torch.cross_silo.client_journal")

__all__ = ["ClientJournal", "client_journal_from_config", "pack_client_state",
           "unpack_client_state", "prune_retired_client_dirs"]

#: upload-attempt entries kept per client (only the current round and epoch
#: can be dispatched again)
MAX_ATTEMPT_ENTRIES = 8


class ClientJournal(ServerJournal):
    def __init__(self, root: str, rank: int, keep: int = 2):
        super().__init__(os.path.join(str(root), f"client_{int(rank)}"), keep=keep)
        self.rank = int(rank)
        steps = self.steps()
        self._seq = steps[-1] if steps else 0

    def snapshot_state(self, protocol: dict, arrays: Optional[dict] = None) -> None:
        """Commit the next step of this client's sequence."""
        self._seq += 1
        self.snapshot(self._seq, protocol, arrays)

    def restore_state(self) -> Optional[dict]:
        """The newest intact snapshot, or None; later snapshots continue
        past it."""
        snap = self.restore()
        if snap is not None:
            self._seq = max(self._seq, int(snap["step"]))
        return snap


def _host(a) -> np.ndarray:
    """A residual or state leaf as host numpy (a tensor leaves its device)."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def pack_client_state(*, rank: int, round_idx: Optional[int], session_epoch: Optional[int],
                      rounds_trained: int, server_restarts_seen: int, upload_attempts: dict,
                      residuals: Optional[list], trainer_state: Any = None) -> tuple[dict, dict]:
    """Client protocol state -> ``(JSON protocol, named numpy arrays)``: the
    present residual entries as ``resid_<i>`` (the list's length and
    indices ride the JSON), a trainer's local state flattened through the
    wire skeleton as ``local_<i>``."""
    from ..comm import wire

    proto: dict = {
        "kind": "client",
        "rank": int(rank),
        "round_idx": None if round_idx is None else int(round_idx),
        "session_epoch": None if session_epoch is None else int(session_epoch),
        "rounds_trained": int(rounds_trained),
        "server_restarts_seen": int(server_restarts_seen),
        "upload_attempts": {str(k): int(v) for k, v in upload_attempts.items()},
    }
    arrays: dict = {}
    if residuals is not None:
        idx = [i for i, r in enumerate(residuals) if r is not None]
        proto["residual_len"] = len(residuals)
        proto["residual_idx"] = idx
        for i in idx:
            arrays[f"resid_{i}"] = _host(residuals[i])
    if trainer_state is not None:
        skel, leaves = wire.flatten_with_skeleton(trainer_state)
        proto["trainer_skel"] = skel
        for i, leaf in enumerate(leaves):
            arrays[f"local_{i}"] = _host(leaf)
    return proto, arrays


def unpack_client_state(snap: dict) -> dict:
    """Inverse of :func:`pack_client_state` over a journal snapshot (host
    numpy arrays)."""
    from ..comm import wire

    proto, arrays = snap["protocol"], snap["arrays"]
    residuals = None
    if proto.get("residual_len") is not None:
        residuals = [None] * int(proto["residual_len"])
        for i in proto.get("residual_idx") or []:
            residuals[int(i)] = np.asarray(arrays[f"resid_{int(i)}"])
    trainer_state = None
    if proto.get("trainer_skel") is not None:
        n = len([k for k in arrays if k.startswith("local_")])
        trainer_state = wire.restore_skeleton(proto["trainer_skel"],
                                              [arrays[f"local_{i}"] for i in range(n)])
    return {
        "round_idx": proto.get("round_idx"),
        "session_epoch": proto.get("session_epoch"),
        "rounds_trained": int(proto.get("rounds_trained", 0)),
        "server_restarts_seen": int(proto.get("server_restarts_seen", 0)),
        "upload_attempts": {str(k): int(v)
                            for k, v in (proto.get("upload_attempts") or {}).items()},
        "residuals": residuals,
        "trainer_state": trainer_state,
    }


def prune_retired_client_dirs(root: str, live_ranks, keep: int = 8) -> list[int]:
    """Remove the journal directories of retired ranks (not in
    ``live_ranks``) but the ``keep`` newest (by their newest file's mtime);
    live ranks are never touched.  Returns the pruned ranks."""
    live = {int(r) for r in live_ranks}
    retired: list[tuple[float, int, str]] = []
    try:
        names = os.listdir(str(root))
    except OSError:
        return []
    for name in names:
        m = re.fullmatch(r"client_(\d+)", name)
        if not m or int(m.group(1)) in live:
            continue
        path = os.path.join(str(root), name)
        try:
            mtimes = ([os.path.getmtime(os.path.join(path, f)) for f in os.listdir(path)]
                      or [os.path.getmtime(path)])
        except OSError:
            continue
        retired.append((max(mtimes), int(m.group(1)), path))
    retired.sort(reverse=True)  # newest first
    pruned: list[int] = []
    for _mtime, rank, path in retired[max(0, int(keep)):]:
        try:
            shutil.rmtree(path)
            pruned.append(rank)
        except OSError as e:
            log.warning("client journal: could not prune retired rank %d (%s)", rank, e)
    if pruned:
        log.info("client journal: pruned %d retired rank dir(s) under %s", len(pruned), root)
    return pruned


def client_journal_from_config(cfg: Any, rank: int) -> Optional[ClientJournal]:
    """``None`` unless ``extra.client_journal_dir`` is set."""
    if cfg is None or not cfg_extra(cfg, "client_journal_dir"):
        return None
    root = cfg_extra(cfg, "client_journal_dir")
    try:
        return ClientJournal(str(root), rank, keep=int(cfg_extra(cfg, "client_journal_keep")))
    except OSError as e:
        log.warning("client journal: directory %s unusable (%s): running without crash "
                    "recovery", root, e)
        return None
