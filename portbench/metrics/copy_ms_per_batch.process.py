"""`copy_ms_per_batch.process`: device time of the host-to-device and
device-to-host copies (`pipeline.py:place_input` and `run`'s
read-back) per batch of the traced call."""
from portbench.lib.trace import is_copy

LAYER = "pipeline host path: pipeline.py run, place_input, read-back"
UNIT = "ms"
MOVES = "frames_per_s"


def read(ctx):
    s, lay = ctx["summary"], ctx["layer"]
    if s is None or s.device_count(is_copy) == 0:
        return None
    batches = lay["frames_traced"] / lay["batch"]
    return 1e3 * s.device_time_s(is_copy) / batches
