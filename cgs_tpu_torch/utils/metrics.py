"""Structured metrics (copy of `cgs_tpu/utils/metrics.py`; SURVEY.md §5).

The reference logs via bare prints and a `log.txt` arg dump
(main.py:171-172,320-321). We keep those artifacts for parity and add
a structured JSONL stream (`metrics.jsonl` per run dir) carrying loss
curves, throughput and IoU as first-class records — greppable and
TensorBoard-convertible.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricsWriter:
    def __init__(self, run_dir: str, filename: str = "metrics.jsonl",
                 enabled: bool = True):
        """enabled=False makes write() a no-op and touches no files —
        non-primary hosts of a multi-host run stay silent."""
        self.enabled = enabled
        self._fp = None
        self._t0 = time.time()
        if enabled:
            os.makedirs(run_dir, exist_ok=True)
            self.path = os.path.join(run_dir, filename)
            self._fp = open(self.path, "a", buffering=1)

    def write(self, kind: str, step: Optional[int] = None, **fields):
        if not self.enabled:
            return
        rec = {"t": round(time.time() - self._t0, 3), "kind": kind}
        if step is not None:
            rec["step"] = int(step)
        for k, v in fields.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self._fp.write(json.dumps(rec) + "\n")

    def close(self):
        """Idempotent; writes after close become no-ops rather than
        ValueError-on-closed-file."""
        if self._fp is not None:
            self._fp.close()
            self._fp = None
        self.enabled = False


def write_log_header(run_dir: str, cfg) -> None:
    """The reference's `log.txt` arg dump (main.py:171-172)."""
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "log.txt"), "w") as fp:
        fp.write(f"{cfg}\n\n")
