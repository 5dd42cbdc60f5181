"""`host_idle_ms_per_step.train`: the card's idle time while the host
ran the masker chunk's own work, per step of the traced chunk: the idle
gaps named after a `cgs.train.*` span (`train/loops.py`,
`train/steps.py`), over the chunk's steps. A gap inside an operation
(an ATen call, a launch, Adam's region) is named after it instead."""
from portbench.metrics._program import span_gap_s

LAYER = "train loop: train/loops.py masker_chunk"
UNIT = "ms"
MOVES = "train_steps_per_s"


def read(ctx):
    idle = span_gap_s(ctx["summary"], "cgs.train.")
    if idle is None:
        return None
    return 1e3 * idle / ctx["layer"]["steps_traced"]
