"""`bn_ms_per_batch.process`: the device time of the BatchNorm kernels
(cuDNN's `bn_fw*` and PyTorch's own `batch_norm*`) per batch of the
traced call. The BatchNorm layers a forward applies come from the
program's counter `model.bn_running` (over the critic forwards, from
`model.critic_frames` in batches); the reading is None where the
program keeps no such counter, or where the kernels counted are not a
whole multiple of those layers over the traced batches."""
from portbench.lib.trace import is_kernel
from portbench.metrics._program import counters

LAYER = "model step: models/critic.py, models/decoder.py under pipeline.py"
UNIT = "ms"
MOVES = "frames_per_s"
NAMES = ("bn_fw", "batch_norm", "batchnorm")


def read(ctx):
    s, lay, c = ctx["summary"], ctx["layer"], counters()
    if s is None or not c or not c.get("model.bn_running") \
            or not c.get("model.critic_frames"):
        return None
    batch = lay["batch"]
    per_forward = c["model.bn_running"] * batch / c["model.critic_frames"]
    batches = lay["frames_traced"] / batch
    match = is_kernel(NAMES)
    n = s.device_count(match)
    if n == 0 or n % round(per_forward * batches):
        return None
    return 1e3 * s.device_time_s(match) / batches
