"""metrics.jsonl -> TensorBoard event files (PyTorch port of
`cgs_tpu/utils/tb_export.py`; SURVEY.md §5: "Structured metrics writer
(jsonl + optional TensorBoard)" — this is the optional half; the
reference has no structured metrics at all, main.py:171-172 dumps args
to log.txt and matplotlib PNGs). It reads the `metrics.jsonl` that the
port's `utils/metrics.py:MetricsWriter` writes, the JAX package's
records, and writes the same scalars under the same tags and steps.

Usage:
    python -m cgs_tpu_torch.utils.tb_export RUN_DIR [RUN_DIR ...] \
        [--out LOGDIR]               # default: {run}/tb/

Each metrics.jsonl record {"t": sec, "kind": k, "step": n, ...fields}
becomes scalars `k/field` at step n (or at the record's index within
its kind when no step was logged), timestamped with the run-relative
wall clock. Non-numeric fields are skipped. TensorBoard itself is an
optional dependency (torch.utils.tensorboard); a missing install is a
clear error, not a crash at import time of cgs_tpu_torch.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Optional


def export_run(run_dir: str, out_dir: Optional[str] = None,
               filename: str = "metrics.jsonl") -> str:
    """Convert one run's metrics.jsonl; returns the event-file dir."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as e:  # keep the package tb-free
        raise RuntimeError(
            "TensorBoard export needs torch.utils.tensorboard "
            f"(pip install tensorboard): {e}") from e

    path = os.path.join(run_dir, filename)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} not found — is {run_dir} a cgs_tpu run directory "
            "(created by a primary-host Handler)?")
    out_dir = out_dir or os.path.join(run_dir, "tb")
    writer = SummaryWriter(log_dir=out_dir)
    per_kind_index: dict = {}
    n = 0
    try:
        with open(path) as fp:
            for line in fp:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn tail line of a live run
                kind = rec.get("kind", "metric")
                step = rec.get("step")
                if step is None:  # e.g. per-eval records
                    step = per_kind_index.get(kind, 0)
                    per_kind_index[kind] = step + 1
                wall = rec.get("t")
                for key, value in rec.items():
                    if key in ("kind", "step", "t"):
                        continue
                    if isinstance(value, bool) or not isinstance(
                            value, (int, float)):
                        continue
                    writer.add_scalar(f"{kind}/{key}", value,
                                      global_step=int(step),
                                      walltime=wall)
                    n += 1
    finally:
        writer.close()
    print(f"[cgs-tpu-torch tb] {path}: {n} scalars -> {out_dir}")
    return out_dir


def main(argv: Optional[Iterable[str]] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="Export cgs_tpu_torch metrics.jsonl to TensorBoard")
    ap.add_argument("runs", nargs="+", help="run directories")
    ap.add_argument("--out", default=None,
                    help="event-file dir (single run only; default "
                         "{run}/tb/)")
    ns = ap.parse_args(argv)
    if ns.out and len(ns.runs) > 1:
        ap.error("--out only applies to a single run directory")
    for run in ns.runs:
        export_run(run, out_dir=ns.out)


if __name__ == "__main__":
    main()
