"""Small sizes of each traffic kind for runs on the CPU, and a helper
that runs a cell there."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SMALL = {
    "process": {"pool_frames": 48, "batch": 16,
                "sample_per_call": 8},
    "train_masker": {"k": 4, "bank_frames": 64, "chunk_steps": 3},
}
SEED = 2 ** 31 + 11


def run_small(cell_name: str, trace: bool = False, fault=None,
              seconds: float = 0.5, seed: int = SEED):
    import torch

    from portbench.lib.faults import Fault
    from portbench.lib.harness import run_cell
    from portbench.lib.manifest import Manifest

    torch.set_num_threads(2)
    man = Manifest(ROOT)
    cell = man.cell(cell_name)
    kind = cell.traffic["driver"]
    if fault == "bf16":
        cell = type(cell)(**{**cell.__dict__,
                             "config": dict(cell.config, dtype="bfloat16")})
    return run_cell(man, cell, seed, seconds, trace, device="cpu",
                    faults=None if fault is None else Fault(fault, kind),
                    overrides=SMALL[kind])
