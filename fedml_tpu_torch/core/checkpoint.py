"""Round-level checkpoint and resume (the port of
``fedml_tpu/core/checkpoint.py``), written with ``torch.save``.

A step is one file, ``<directory>/round_<step>.pt``, holding the
simulator's round-resumable state (round index, global variables, server
and client state, RNG key) with every tensor on the CPU.  The reference's
contract:

- a write is committed atomically: the state goes to a temporary file in
  the same directory, which ``os.replace`` then renames onto the step's
  name, so a reader never sees a half-written step under it;
- the newest ``keep`` (3) steps are kept, older ones deleted after a save;
- :meth:`RoundCheckpointer.latest_round` returns the newest step that
  loads, and discards a newer one that is truncated or damaged (an empty
  file, or one the zip reader refuses); a state the weights-only
  unpickler rejects is a fault of the program and raises;
- :class:`RoundCheckpointMixin` saves every ``checkpoint_every_rounds``
  completed rounds and at the final round, and on resume the
  checkpointed RNG key replaces the one the config's seed gave.
"""

from __future__ import annotations

import logging
import os
import re
import tempfile
from pathlib import Path
from typing import Optional

import torch

log = logging.getLogger("fedml_tpu_torch.core.checkpoint")

_STEP = re.compile(r"round_(\d+)\.pt")
# what torch.load's zip reader says of a truncated or damaged file (an
# empty one raises EOFError)
_ZIP_DAMAGE = "PytorchStreamReader failed"


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    return tree


class RoundCheckpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    def _path(self, step: int) -> Path:
        return self.directory / f"round_{step}.pt"

    def all_steps(self) -> list[int]:
        return sorted(int(m.group(1)) for p in self.directory.iterdir()
                      if (m := _STEP.fullmatch(p.name)))

    def save(self, round_idx: int, state: dict) -> None:
        """Write ``state`` (tensors copied to the CPU) as step
        ``round_idx``, atomically, then drop all but the newest ``keep``."""
        fd, tmp = tempfile.mkstemp(prefix=f".round_{round_idx}.", suffix=".tmp",
                                   dir=self.directory)
        try:
            with os.fdopen(fd, "wb") as f:
                torch.save(_to_cpu(state), f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._path(round_idx))
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        for step in self.all_steps()[:-self.keep]:
            self._path(step).unlink(missing_ok=True)

    def _load(self, step: int) -> dict:
        return torch.load(self._path(step), map_location="cpu", weights_only=True)

    def latest_round(self) -> Optional[int]:
        """The newest step that loads; a newer one that is truncated or
        damaged is discarded with a warning.  Any other failure to load
        (the weights-only unpickler refusing a type the program saved)
        raises, and no step is discarded for it."""
        for step in reversed(self.all_steps()):
            try:
                self._load(step)
                return step
            except (EOFError, RuntimeError) as e:
                if isinstance(e, RuntimeError) and _ZIP_DAMAGE not in str(e):
                    raise
                log.warning("checkpoint step %s under %s is unreadable (%s: %s): discarding "
                            "it and falling back to the previous step", step, self.directory,
                            type(e).__name__, e)
                self._path(step).unlink(missing_ok=True)
        return None

    def restore(self, round_idx: Optional[int] = None) -> dict:
        step = round_idx if round_idx is not None else self.latest_round()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        return self._load(step)


class RoundCheckpointMixin:
    """Save and resume for a simulator.  The simulator defines
    ``_ckpt_state() -> dict`` (its round-resumable state) and
    ``_apply_ckpt_state(state)`` (installs a restored one on its device;
    the restored RNG key is authoritative), and has ``self.cfg``
    (``checkpoint_dir``, ``checkpoint_every_rounds``, ``resume``) and
    ``self.round_idx``."""

    def _checkpointer(self) -> RoundCheckpointer:
        if getattr(self, "_ckpt", None) is None:
            self._ckpt = RoundCheckpointer(self.cfg.checkpoint_dir)
        return self._ckpt

    def save_checkpoint(self) -> None:
        if not self.cfg.checkpoint_dir:
            return
        self._checkpointer().save(self.round_idx, self._ckpt_state())

    def try_resume(self) -> bool:
        """Install the newest intact checkpoint when ``cfg.resume`` is set
        and one exists; True when one was installed."""
        if not (self.cfg.checkpoint_dir and getattr(self.cfg, "resume", False)):
            return False
        if self._checkpointer().latest_round() is None:
            return False
        self._apply_ckpt_state(self._ckpt.restore())
        return True

    def maybe_save_checkpoint(self, completed_round: int) -> None:
        """Save every ``checkpoint_every_rounds`` completed rounds and at the
        final round."""
        every = getattr(self.cfg, "checkpoint_every_rounds", 0)
        if every and ((completed_round + 1) % every == 0
                      or completed_round == self.cfg.comm_round - 1):
            self.save_checkpoint()


def tree_to_device(tree, device):
    """A restored tree's tensors on ``device`` (other leaves as they are;
    dicts, lists and tuples walked)."""
    if isinstance(tree, dict):
        return {k: tree_to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to_device(v, device) for v in tree)
    return tree.to(device) if torch.is_tensor(tree) else tree
