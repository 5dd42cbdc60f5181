"""`pointwise_ms_per_batch.process`: the device time of the model step's
pointwise passes per batch of the traced call: every kernel whose name
holds `elementwise_kernel` (PyTorch's bias adds, activations and the
wire's conversions), `max_pool` (PyTorch's max-pool) or `bias_act_pool`
(the port's convolution epilogue, which does the bias, activation and
pool of a convolution in one pass). None where the trace holds none."""
from portbench.lib.trace import is_kernel

LAYER = "model step: models/critic.py, models/decoder.py under pipeline.py"
UNIT = "ms"
MOVES = "frames_per_s"
NAMES = ("elementwise_kernel", "max_pool", "bias_act_pool")


def read(ctx):
    s, lay = ctx["summary"], ctx["layer"]
    match = is_kernel(NAMES)
    if s is None or s.device_count(match) == 0:
        return None
    batches = lay["frames_traced"] / lay["batch"]
    return 1e3 * s.device_time_s(match) / batches
