"""`mask_head_ms_per_batch.process`: the device time of the mask head's
one-launch kernel per batch of the traced call: the kernels named
`mask_head` (`csrc/mask_head.cu`: the LeakyReLU of the head's first
convolution, the 16 -> 1 convolution, its bias and the sigmoid). The
forwards that take it come from the program's counter
`model.mask_heads`; the reading is None where `_counted.per_batch_s`
finds nothing to read, as on a program without that counter."""
from portbench.metrics._counted import per_batch_s

LAYER = "model step: models/critic.py, models/decoder.py under pipeline.py"
UNIT = "ms"
MOVES = "frames_per_s"
NAMES = ("mask_head",)


def read(ctx):
    t = per_batch_s(ctx, "model.mask_heads", NAMES)
    return None if t is None else 1e3 * t
