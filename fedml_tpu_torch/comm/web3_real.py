"""Ledgers on real chains for the WEB3 / THETASTORE backends (the port of
``fedml_tpu/comm/web3_real.py``), each the ``append_tx`` / ``read_since``
interface ``comm/blockchain.py``'s manager takes:

- :class:`Web3ContractLedger`: an EVM mailbox contract through web3.py
  (``sendMessage(uint64 recipient, string data)`` and the append-only view
  ``getMessages(uint256 fromIndex)`` returning ``(sender, recipient,
  data)[]``, :data:`MAILBOX_ABI`), sent from an unlocked node account or
  signed with a private key; a reverted transaction raises;
- :class:`ThetaEdgeStoreLedger`: the Theta EdgeStore through a put / get
  client: each payload under a key of its own, and a per-run JSON index
  appended with an optimistic retry (re-read after the write; a racer that
  clobbered the index is merged again).

web3.py is imported when a :class:`Web3ContractLedger` is built without a
``web3_module``, and only then; without it the ledger raises
``ImportError``.  The Theta ledger needs its client passed in.
"""

from __future__ import annotations

import importlib
import json
import threading
from typing import Optional


def _web3_module():
    """web3.py, or None when it is not installed."""
    try:
        return importlib.import_module("web3")
    except ImportError:
        return None


# minimal mailbox ABI (see module docstring)
MAILBOX_ABI = [
    {
        "name": "sendMessage",
        "type": "function",
        "stateMutability": "nonpayable",
        "inputs": [
            {"name": "recipient", "type": "uint64"},
            {"name": "data", "type": "string"},
        ],
        "outputs": [],
    },
    {
        "name": "getMessages",
        "type": "function",
        "stateMutability": "view",
        "inputs": [{"name": "fromIndex", "type": "uint256"}],
        "outputs": [
            {
                "components": [
                    {"name": "sender", "type": "uint64"},
                    {"name": "recipient", "type": "uint64"},
                    {"name": "data", "type": "string"},
                ],
                "name": "",
                "type": "tuple[]",
            }
        ],
    },
]


class Web3ContractLedger:
    """web3.py-backed Ledger over the mailbox contract."""

    def __init__(self, rpc_url: str, contract_address: str, account: str,
                 private_key: Optional[str] = None, web3_module=None):
        web3 = web3_module if web3_module is not None else _web3_module()
        if web3 is None:
            raise ImportError(
                "web3.py is not installed; install it for an on-chain ledger "
                "or use comm.blockchain.InMemoryLedger for hermetic runs"
            )
        self._w3 = web3.Web3(web3.Web3.HTTPProvider(rpc_url))
        self._contract = self._w3.eth.contract(address=contract_address, abi=MAILBOX_ABI)
        self._account = account
        self._private_key = private_key
        self._lock = threading.Lock()

    # -- Ledger interface ----------------------------------------------------
    def append_tx(self, sender: int, recipient: int, data_b64: str) -> int:
        """Submit sendMessage.  Sender identity on chain is the ACCOUNT, not
        the FL rank — the rank rides inside the Message control header.
        Returns a local monotonic send counter (advisory only — the manager
        ignores it; a global height would cost an O(history) RPC per send and
        still race other accounts' appends)."""
        with self._lock:
            fn = self._contract.functions.sendMessage(int(recipient), data_b64)
            if self._private_key:
                tx = fn.build_transaction({
                    "from": self._account,
                    "nonce": self._w3.eth.get_transaction_count(self._account),
                })
                signed = self._w3.eth.account.sign_transaction(tx, self._private_key)
                tx_hash = self._w3.eth.send_raw_transaction(signed.raw_transaction)
            else:  # unlocked node account (dev chains)
                tx_hash = fn.transact({"from": self._account})
            receipt = self._w3.eth.wait_for_transaction_receipt(tx_hash)
            # a reverted tx (status 0) means the message never landed on
            # chain — surfacing it here beats a receiver waiting forever
            status = receipt.get("status", 1) if hasattr(receipt, "get") else getattr(receipt, "status", 1)
            if status == 0:
                raise RuntimeError(f"sendMessage transaction reverted: {tx_hash!r}")
            self._sent = getattr(self, "_sent", -1) + 1
            return self._sent

    def read_since(self, height: int) -> list[dict]:
        rows = self._contract.functions.getMessages(int(height)).call()
        return [
            {"height": height + i, "sender": int(s), "recipient": int(r), "data": d}
            for i, (s, r, d) in enumerate(rows)
        ]


class ThetaEdgeStoreLedger:
    """Theta EdgeStore-backed Ledger: payload blobs in the store, an
    append-only JSON index document per run keyed by ``index_key``.

    ``http_client`` is any object with ``put(key, bytes) -> key`` and
    ``get(key) -> bytes`` (the EdgeStore RPC adapter); injected for tests,
    constructed from ``theta_rpc_url`` in production deployments."""

    def __init__(self, run_id: str, http_client=None, theta_rpc_url: str = ""):
        if http_client is None:
            raise ImportError(
                "no Theta EdgeStore client available; pass http_client (an "
                "object with put/get) or use comm.blockchain.InMemoryLedger "
                f"(rpc url given: {theta_rpc_url!r})"
            )
        self._store = http_client
        self._index_key = f"fedml_tpu/{run_id}/ledger_index"
        self._lock = threading.Lock()

    def _read_index(self) -> list[dict]:
        try:
            raw = self._store.get(self._index_key)
        except KeyError:
            return []
        return json.loads(raw.decode())

    # -- Ledger interface ----------------------------------------------------
    def append_tx(self, sender: int, recipient: int, data_b64: str,
                  max_retries: int = 16) -> int:
        """Append with optimistic-concurrency retry.  A put/get store has no
        compare-and-swap, so a concurrent writer can clobber the index
        read-modify-write; every blob therefore gets a UNIQUE key (no payload
        can be overwritten), and after writing the index we re-read and
        verify our entry survived — retrying the merge if a racer dropped it.
        This makes lost updates a transient (retried) condition rather than a
        silent one; deployments whose EdgeStore exposes an atomic append
        should implement this method over that primitive instead."""
        import uuid

        blob_key = f"{self._index_key}/tx-{uuid.uuid4().hex}"
        with self._lock:
            self._store.put(blob_key, data_b64.encode())
            for _ in range(max_retries):
                index = self._read_index()
                height = len(index)
                index.append({"height": height, "sender": int(sender),
                              "recipient": int(recipient), "key": blob_key})
                self._store.put(self._index_key, json.dumps(index).encode())
                written = self._read_index()
                for entry in written:
                    if entry["key"] == blob_key:
                        return entry["height"]
            raise RuntimeError(
                f"could not append to {self._index_key} after {max_retries} "
                "retries (heavy index contention)"
            )

    def read_since(self, height: int) -> list[dict]:
        index = self._read_index()
        out = []
        # heights are POSITIONAL (index order), not the stored hints — after
        # a retried merge an entry's recorded height can lag its position
        for pos in range(height, len(index)):
            entry = index[pos]
            data = self._store.get(entry["key"]).decode()
            out.append({"height": pos, "sender": entry["sender"],
                        "recipient": entry["recipient"], "data": data})
        return out
