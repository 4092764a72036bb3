"""Durable server recovery journal (the port of
``fedml_tpu/cross_silo/journal.py``).

:class:`ServerJournal` snapshots a server's protocol state at round
boundaries (and, under ``server_journal_every_folds``, mid-round):

- the model tree (``{"global_vars", "server_state"}``) through the port's
  :class:`~fedml_tpu_torch.core.checkpoint.RoundCheckpointer` under
  ``<dir>/model`` (``torch.save``, tensors on the CPU; the reference's is
  orbax);
- the protocol sidecar, one file a step in the reference's envelope: ``MAGIC
  + one JSON meta line + an npz payload`` (session epoch, round index,
  dedup keys, the streaming accumulator's partial sums), written to a
  temporary file, fsynced and renamed onto its name (``os.replace``) under a
  cross-process ``flock``, so a reader sees the old step or the complete new
  one.

``restore`` walks the steps newest first and discards one whose sidecar
does not parse (bad magic, truncated meta or payload) or whose model
checkpoint does not load, falling back to the previous step.  A snapshot
taken under session epoch ``e`` makes the recovering server resume under
``e + 1``, so uploads produced by pre-crash dispatches can be told apart.

Gated on ``extra.server_journal_dir``: unset, :func:`journal_from_config`
returns ``None`` and the server runs as before, its wire bytes unchanged.
The reference counts snapshots, recoveries and discards in its metrics
registry (not ported); :attr:`ServerJournal.snapshots`,
:attr:`ServerJournal.discarded` and :attr:`ServerJournal.recoveries` count
them here.
"""

from __future__ import annotations

import contextlib
import io
import json
import logging
import os
import re
import tempfile
import time
from typing import Any, Optional

import numpy as np

from ..core.checkpoint import RoundCheckpointer
from ..core.flags import cfg_extra

log = logging.getLogger("fedml_tpu_torch.cross_silo.journal")

__all__ = ["ServerJournal", "journal_from_config"]

#: on-disk step format: MAGIC + one JSON meta line + an npz payload (the
#: reference's; a step under another magic is discarded as corrupt)
_MAGIC = b"FMLJRN1\n"
_STEP_RE = re.compile(r"^step_(\d{10})\.journal$")


class ServerJournal:
    """Atomic, step-addressed snapshots of one server's protocol state.

    ``snapshot(step, protocol, arrays, model_state)`` commits the model tree
    (when given) and then the sidecar, the commit record;
    ``restore()`` returns the newest intact step as ``{"step", "protocol",
    "arrays", "model", "model_step"}`` or ``None``."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = os.path.abspath(str(directory))
        os.makedirs(self.directory, exist_ok=True)
        self.keep = max(1, int(keep))
        self._model_ckpt: Optional[RoundCheckpointer] = None
        self.snapshots = 0
        self.discarded = 0
        self.recoveries = {"recovered": 0, "empty": 0}

    def _step_path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step):010d}.journal")

    def steps(self) -> list[int]:
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        return sorted(int(m.group(1)) for n in names if (m := _STEP_RE.match(n)))

    def _model(self) -> RoundCheckpointer:
        if self._model_ckpt is None:
            self._model_ckpt = RoundCheckpointer(os.path.join(self.directory, "model"),
                                                 keep=self.keep)
        return self._model_ckpt

    def snapshot(self, step: int, protocol: dict, arrays: Optional[dict] = None,
                 model_state: Optional[dict] = None, model_step: Optional[int] = None) -> None:
        """Commit one step, the model first, so a crash between the two
        writes leaves a model step no sidecar names (ignored).  A mid-round
        snapshot passes ``model_step`` in place of ``model_state``: its
        sidecar names the boundary step whose model holds the round's
        starting global.  Writing the same step again replaces it
        atomically."""
        with self._journal_flock():
            has_model = model_state is not None
            if has_model:
                self._model().save(int(step), model_state)
            buf = io.BytesIO()
            np.savez(buf, **{k: np.asarray(v) for k, v in dict(arrays or {}).items()})
            payload = buf.getvalue()
            meta = {"step": int(step), "has_model": bool(has_model),
                    "payload_len": len(payload), "created_unix": round(time.time(), 3),
                    "protocol": protocol}
            if not has_model and model_step is not None:
                meta["model_step"] = int(model_step)
            blob = (_MAGIC + json.dumps(meta, sort_keys=True).encode("utf-8") + b"\n" + payload)
            fd, tmp = tempfile.mkstemp(dir=self.directory, prefix=".tmp_", suffix=".journal")
            try:
                with os.fdopen(fd, "wb") as f:
                    f.write(blob)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, self._step_path(step))
            except OSError:
                with contextlib.suppress(OSError):
                    os.remove(tmp)
                raise
            self._prune()
        self.snapshots += 1

    def _prune(self) -> None:
        for step in self.steps()[:-self.keep]:
            with contextlib.suppress(OSError):
                os.remove(self._step_path(step))

    def _load_step(self, step: int) -> Optional[tuple[dict, dict]]:
        """``(meta, arrays)`` of one sidecar, or None when it is corrupt."""
        try:
            with open(self._step_path(step), "rb") as f:
                blob = f.read()
        except OSError:
            return None
        try:
            if not blob.startswith(_MAGIC):
                raise ValueError("bad magic")
            rest = blob[len(_MAGIC):]
            nl = rest.find(b"\n")
            if nl < 0:
                raise ValueError("truncated meta")
            meta = json.loads(rest[:nl].decode("utf-8"))
            payload = rest[nl + 1:]
            if int(meta.get("payload_len", -1)) != len(payload):
                raise ValueError("truncated payload")
            with np.load(io.BytesIO(payload), allow_pickle=False) as z:
                arrays = {k: np.asarray(z[k]) for k in z.files}
            return dict(meta), arrays
        except Exception as e:
            log.warning("journal: discarding unusable step %s (%s: %s)", self._step_path(step),
                        type(e).__name__, e)
            return None

    def _discard(self, step: int) -> None:
        self.discarded += 1
        with contextlib.suppress(OSError):
            os.remove(self._step_path(step))

    def restore(self) -> Optional[dict]:
        """The newest intact snapshot; ``model_step`` is the step its model
        was loaded from (None for a model-less sidecar)."""
        for step in reversed(self.steps()):
            loaded = self._load_step(step)
            if loaded is None:
                self._discard(step)
                continue
            meta, arrays = loaded
            model, model_from = None, None
            if meta.get("has_model"):
                model_from = step
            elif meta.get("model_step") is not None:
                model_from = int(meta["model_step"])
            if model_from is not None:
                try:
                    model = self._model().restore(model_from)
                except Exception as e:
                    log.warning("journal: step %d sidecar is intact but the model checkpoint "
                                "it names (step %d) is not (%s: %s): falling back", step,
                                model_from, type(e).__name__, e)
                    self._discard(step)
                    continue
            self.recoveries["recovered"] += 1
            return {"step": step, "protocol": meta["protocol"], "arrays": arrays,
                    "model": model, "model_step": model_from}
        self.recoveries["empty"] += 1
        return None

    @contextlib.contextmanager
    def _journal_flock(self):
        """Exclusive ``flock`` over the journal's writers across processes
        (a restarted server and a not yet dead predecessor)."""
        try:
            import fcntl
        except ImportError:  # not posix: best effort
            yield
            return
        fd = os.open(os.path.join(self.directory, ".journal.lock"), os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            yield
        finally:
            with contextlib.suppress(OSError):
                fcntl.flock(fd, fcntl.LOCK_UN)
            os.close(fd)


def journal_from_config(cfg: Any) -> Optional[ServerJournal]:
    """``None`` unless ``extra.server_journal_dir`` is set."""
    if cfg is None or not cfg_extra(cfg, "server_journal_dir"):
        return None
    root = cfg_extra(cfg, "server_journal_dir")
    try:
        return ServerJournal(str(root), keep=int(cfg_extra(cfg, "server_journal_keep")))
    except OSError as e:
        log.warning("journal: directory %s unusable (%s): running without crash recovery",
                    root, e)
        return None
