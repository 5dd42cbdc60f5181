"""`graph_steps.train`: the share of the run's masker steps that
replayed the captured step (`train/graph.py`), from the program's
counters `train.graph_steps` and `train.eager_steps` (every masker step
`train/loops.py:masker_chunk` ran in the process, set-up included).
None where the program keeps no such counters."""
from portbench.metrics._program import counters

LAYER = "train loop: train/loops.py masker_chunk"
UNIT = "%"
MOVES = "train_steps_per_s"


def read(ctx):
    c = counters()
    if not c:
        return None
    graphed = c.get("train.graph_steps", 0)
    steps = graphed + c.get("train.eager_steps", 0)
    return 100.0 * graphed / steps if steps else None
