"""`idle.process`: the share of the traced window in which no kernel,
copy or fill ran on the card (the union of device intervals)."""
from portbench.metrics._common import idle

LAYER = "device"
UNIT = "%"
MOVES = "frames_per_s"


def read(ctx):
    return idle(ctx)
