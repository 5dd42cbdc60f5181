"""One run of one cell: set-up, the measured window, the check, the
result line.

`run_cell` builds the cell's driver (`portbench/drivers/<driver>.py`)
from its configuration and traffic mix, times the set-up from the
process's start, measures for `seconds`, reads the device's peak memory,
frees the program's state, runs the check against the reference, and
returns the result object. With `trace` the window profiles one steady
stretch and the result carries the cell's per-layer metrics, read by
their readers (`portbench/metrics/<name>.py`), with the trace's
breakdown; without it, the cell's end-to-end metrics.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import math
import sys
import time
from collections import Counter
from typing import Optional

import torch

from portbench.lib import flops
from portbench.lib.manifest import Cell, Manifest, readers

FORBIDDEN = ("jax", "jaxlib", "flax", "cgs_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def device_info(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def launches() -> Counter:
    """The port's own count of kernel launches per entry point
    (`ops/_build.py:launches`)."""
    from cgs_tpu_torch.ops import _build
    return _build.launches


def _print_launches(delta: Counter, units) -> None:
    """The window's kernel launches per batch, step or dispatch, on
    standard error: they show that the timed path went through the
    port's kernels."""
    if not units or not units[1]:
        return
    name, n = units
    per = {k: round(v / n, 3) for k, v in sorted(delta.items())}
    print(f"[launches] per {name} over {n}: {per}", file=sys.stderr)


def _fmt_checks(checks: dict, limits: dict) -> dict:
    return {k: {"value": v, "limit": limits[k]["limit"]}
            for k, v in checks.items()}


def run_cell(man: Manifest, cell: Cell, seed: int, seconds: float,
             trace: bool, device="cuda", t_start: Optional[float] = None,
             faults=None, overrides: Optional[dict] = None) -> dict:
    """The result object of one run (see README.md). `overrides`
    replaces traffic parameters (the tests' small sizes); `faults` is a
    `lib.faults.Fault` entered around the whole run."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    traffic = dict(cell.traffic, **(overrides or {}))
    drv_mod = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    metrics = man.metrics_for(cell.name, trace)
    reads = readers(metrics) if trace else {}
    with (faults if faults is not None else contextlib.nullcontext()):
        drv = drv_mod.build(cell.config, traffic, seed, device, faults)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        setup_s = time.perf_counter() - t_start
        before = Counter(launches())
        out = drv.window(seconds, trace)
        _print_launches(Counter(launches()) - before, out.get("units"))
        dev = device_info(device)
        drv.free()
    del drv_mod
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = drv.verify()
    limits = cell.limits
    missing = sorted(set(checks) - set(limits))
    if missing:
        raise KeyError(f"limits/{cell.name}.json lacks {missing}")
    within = all(math.isfinite(v) and v <= limits[k]["limit"]
                 for k, v in checks.items())
    correct = bool(within and out["failed"] == 0)
    result = {"correct": correct, "attempted": int(out["attempted"]),
              "failed": int(out["failed"])}
    if trace:
        summ = out["summary"]
        ctx = {"cell": cell, "config": cell.config, "traffic": traffic,
               "summary": summ, "layer": out["layer"], "flops": flops}
        vals = {}
        for m in metrics:
            v = reads[m.name].read(ctx)
            if v is not None:
                vals[m.name] = {"value": float(v), "unit": m.unit}
        result["metrics"] = vals
        dev["busy_s"] = summ.busy_s
        dev["window_s"] = summ.window_s
        result["device"] = dev
        result["breakdown"] = summ.breakdown()
    else:
        e2e = dict(out["e2e"], setup_s=setup_s)
        result["metrics"] = {m.name: {"value": float(e2e[m.name]),
                                      "unit": m.unit}
                             for m in metrics if m.name in e2e}
        result["device"] = dev
    result["checks"] = _fmt_checks(checks, limits)
    return result

