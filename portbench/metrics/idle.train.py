"""`idle.train`: as `idle.process`, in the masker training cell."""
from portbench.metrics._common import idle

LAYER = "device"
UNIT = "%"
MOVES = "train_steps_per_s"


def read(ctx):
    return idle(ctx)
