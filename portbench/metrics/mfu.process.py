"""`mfu.process`: the model step's share of the card's float32 peak:
the critic's and the decoder's FLOPs (`lib/flops.py`) of the frames of
the window's untraced calls, over those calls' wall time."""
from portbench.metrics._common import mfu

LAYER = "model step: models/critic.py, models/decoder.py under pipeline.py"
UNIT = "%"
MOVES = "frames_per_s"


def read(ctx):
    return mfu(ctx)
