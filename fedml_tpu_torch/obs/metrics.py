"""Plain JSONL metrics logger (the port of ``fedml_tpu.obs.metrics.MetricsLogger``)."""

from __future__ import annotations

import json
import logging
import time
from typing import Optional

log = logging.getLogger("fedml_tpu_torch")


class MetricsLogger:
    """One JSON object per ``log`` call to ``jsonl_path`` (if given), kept in
    ``records`` and echoed to the log."""

    def __init__(self, jsonl_path: Optional[str] = None, stdout: bool = True):
        self.jsonl_path = jsonl_path
        self.stdout = stdout
        self.records: list[dict] = []
        self._fh = open(jsonl_path, "a") if jsonl_path else None

    def log(self, metrics: dict, step: Optional[int] = None) -> None:
        rec = {k: (float(v) if hasattr(v, "__float__") else v) for k, v in metrics.items()}
        if step is not None:
            rec["step"] = step
        rec["ts"] = time.time()
        self.records.append(rec)
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if self.stdout:
            items = " ".join(
                f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in rec.items() if k != "ts"
            )
            log.info("metrics %s", items)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
