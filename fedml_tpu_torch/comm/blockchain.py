"""Ledger communication backends, WEB3 and THETASTORE (the port of
``fedml_tpu/comm/blockchain.py``): a message is a transaction on a chain.

The sender appends a transaction ``(sender, recipient, base64 of the
Message bytes)``; each endpoint polls the blocks past the height it has
read and takes those addressed to it.  The chain is a two-method
interface, ``append_tx(sender, recipient, data_b64) -> height`` and
``read_since(height) -> [block]``:

- :class:`InMemoryLedger`: append-only blocks shared by run namespace (the
  endpoints of one process; :meth:`InMemoryLedger.reset` forgets a run's);
- ``comm/web3_real.py``: an EVM mailbox contract through web3.py, and the
  Theta EdgeStore through its put / get client.

A block is ``{"height", "ts", "sender", "recipient", "data"}``, the
reference's.
"""

from __future__ import annotations

import base64
import threading
import time
from typing import Optional

from .base import BaseCommunicationManager, ObserverLoopMixin
from .message import Message


class InMemoryLedger:
    """Append-only block list shared by namespace (one 'chain' per run)."""

    _chains: dict[str, "InMemoryLedger"] = {}
    _lock = threading.Lock()

    def __init__(self):
        self._blocks: list[dict] = []
        self._block_lock = threading.Lock()

    @classmethod
    def get(cls, namespace: str) -> "InMemoryLedger":
        with cls._lock:
            if namespace not in cls._chains:
                cls._chains[namespace] = cls()
            return cls._chains[namespace]

    @classmethod
    def reset(cls, namespace: str) -> None:
        with cls._lock:
            cls._chains.pop(namespace, None)

    # -- Ledger interface ----------------------------------------------------
    def append_tx(self, sender: int, recipient: int, data_b64: str) -> int:
        """Mine one transaction into a block; returns its height."""
        with self._block_lock:
            height = len(self._blocks)
            self._blocks.append({
                "height": height, "ts": time.time(),
                "sender": sender, "recipient": recipient, "data": data_b64,
            })
            return height

    def read_since(self, height: int) -> list[dict]:
        with self._block_lock:
            return list(self._blocks[height:])


class BlockchainCommManager(ObserverLoopMixin, BaseCommunicationManager):
    """Poll-driven endpoint over a Ledger (reference Web3CommManager shape:
    send = submit transaction; receive = scan new blocks for our address)."""

    def __init__(self, run_id: str, rank: int, ledger: Optional[InMemoryLedger] = None,
                 poll_interval_s: float = 0.05):
        self._init_observer_loop()
        self.rank = rank
        self.ledger = ledger if ledger is not None else InMemoryLedger.get(str(run_id))
        self.poll_interval_s = poll_interval_s
        self._height = 0
        self._poll_stop = threading.Event()
        self._poller = threading.Thread(target=self._poll_loop, daemon=True)
        self._poller.start()

    def _poll_loop(self) -> None:
        while not self._poll_stop.wait(self.poll_interval_s):
            for block in self.ledger.read_since(self._height):
                self._height = block["height"] + 1
                if block["recipient"] == self.rank:
                    self._inbox.put(base64.b64decode(block["data"]))

    def send_message(self, msg: Message) -> None:
        data = base64.b64encode(msg.encode()).decode("ascii")
        self.ledger.append_tx(self.rank, msg.get_receiver_id(), data)

    def stop_receive_message(self) -> None:
        super().stop_receive_message()
        self._poll_stop.set()
