"""`mfu.train`: the masker step's share of the card's float32 peak: its
FLOPs (`lib/flops.py:masker_step_flops`, forward, dgrad and wgrad) times
the steps of the window's untraced chunks, over their wall time."""
from portbench.metrics._common import mfu

LAYER = "train step: train/steps.py masker_step, train/losses.py"
UNIT = "%"
MOVES = "train_steps_per_s"


def read(ctx):
    return mfu(ctx)
