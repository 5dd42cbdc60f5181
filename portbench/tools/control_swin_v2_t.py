"""The readings behind `limits/swin_v2_t.process.json`: `tools/control.py`'s
runs of the `swin_v2_t.process` cell, with two differences. The faults
are planted as in the other process cells (`lib/faults.py` keys them on
the driver kind `process`, and this cell's driver has its own name), and
one more control runs, `no_shift_mask`: the program's shift mask zeroed
(`cgs_tpu_torch/models/swin.py:shift_mask`), so stage 1's shifted block
attends across the regions the roll brought together.

    python3 portbench/tools/control_swin_v2_t.py \
        --seeds 3600000301,3600000302,3600000303 \
        --kinds sound,tf32,bf16,no_shift_mask,half_batch,answer_altered \
        --seconds 2 [--overrides '{"pool_frames": 64}'] [--out FILE]

One JSON line a run on stdout, as `tools/control.py` prints. The
benchmark's own runs do not run this.
"""

import argparse
import contextlib
import json
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[2]
WORKLOAD = "swin_v2_t.process"
KINDS = ("sound", "tf32", "bf16", "no_shift_mask", "half_batch",
         "answer_altered")


@contextlib.contextmanager
def _planted(kind: str):
    """The patches a kind needs around `tools/control.py:readings`, and
    the kind that function is asked for."""
    import torch

    from cgs_tpu_torch.models import swin
    from portbench.lib import faults

    fault = faults.Fault

    def process_fault(name, driver_kind):
        return fault(name, "process")

    def no_mask(hw, window, shift):
        n = (hw // window) ** 2
        return torch.zeros(n, window * window, window * window)

    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(faults, "Fault",
                                              process_fault))
        if kind == "no_shift_mask":
            stack.enter_context(mock.patch.object(swin, "shift_mask",
                                                  no_mask))
            kind = "sound"
        yield kind


def readings(seeds, kinds, seconds, overrides=None, device="cuda"):
    """Yield one record a (kind, seed), its `kind` the one asked for."""
    sys.path.insert(0, str(ROOT))
    from portbench.tools import control

    for kind in kinds:
        if kind not in KINDS:
            raise ValueError(f"unknown kind {kind!r}; one of {KINDS}")
        with _planted(kind) as run_as:
            for rec in control.readings(WORKLOAD, seeds, [run_as], seconds,
                                        overrides, device):
                yield {**rec, "kind": kind}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", required=True)
    p.add_argument("--kinds", default="sound")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--overrides", default="{}")
    p.add_argument("--out", default="")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    sink = open(args.out, "a") if args.out else None
    for rec in readings(seeds, args.kinds.split(","), args.seconds,
                        json.loads(args.overrides), args.device):
        line = json.dumps(rec)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
