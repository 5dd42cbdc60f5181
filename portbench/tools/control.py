"""Readings that set a cell's limits: the program's sound runs, its
lower-precision controls and the planted faults (`lib/faults.py`), on
many seeds in one process, at the cell's own size (or at the small
sizes the tests pass in `--overrides`).

    python3 portbench/tools/control.py --workload chfak5.process \
        --seeds 11,12,13 --kinds sound,tf32,bf16,half_batch \
        --seconds 2 [--overrides '{"pool_frames": 64}']

One JSON line a run on stdout: {kind, seed, correct, checks, e2e}. The
benchmark's own runs do not run this.
"""

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def readings(cell_name, seeds, kinds, seconds, overrides=None,
             device="cuda"):
    """Yield one record a (kind, seed)."""
    sys.path.insert(0, str(ROOT))
    from portbench.lib.faults import Fault
    from portbench.lib.harness import run_cell
    from portbench.lib.manifest import Manifest

    man = Manifest(ROOT)
    base = man.cell(cell_name)
    for kind in kinds:
        for seed in seeds:
            cell = base
            fault = None
            if kind != "sound":
                fault = Fault(kind, base.traffic["driver"])
            if kind == "bf16":
                cell = type(base)(**{**base.__dict__, "config": dict(
                    base.config, dtype="bfloat16")})
            t0 = time.perf_counter()
            try:
                r = run_cell(man, cell, seed, seconds, False, device=device,
                             faults=fault, overrides=overrides)
                rec = {"kind": kind, "seed": seed, "correct": r["correct"],
                       "checks": {k: v["value"]
                                  for k, v in r["checks"].items()},
                       "e2e": {k: v["value"]
                               for k, v in r["metrics"].items()},
                       "failed": r["failed"]}
            except Exception as e:      # a control that crashes has failed
                traceback.print_exc()
                rec = {"kind": kind, "seed": seed, "correct": False,
                       "error": f"{type(e).__name__}: {e}"}
            rec["s"] = round(time.perf_counter() - t0, 2)
            yield rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--kinds", default="sound")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--overrides", default="{}")
    p.add_argument("--out", default="")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    sink = open(args.out, "a") if args.out else None
    for rec in readings(args.workload, seeds, args.kinds.split(","),
                        args.seconds, json.loads(args.overrides),
                        args.device):
        line = json.dumps(rec)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
