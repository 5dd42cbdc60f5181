"""`copy_gb_per_s.process`: the rate of `MaskPipeline.run`'s copies: the
bytes a batch moves, from the program's counters (`pipeline.h2d_bytes`
and `pipeline.d2h_bytes` over `pipeline.rows`, times the batch), over
the device time of the copies a batch of the traced call (as
`copy_ms_per_batch.process` reads it). Fewer bytes and faster copies
move `copy_ms_per_batch.process` alike; this tells them apart."""
from portbench.lib.trace import is_copy
from portbench.metrics._program import counters

LAYER = "pipeline host path: pipeline.py run, place_input, read-back"
UNIT = "GB/s"
MOVES = "frames_per_s"


def read(ctx):
    s, lay, c = ctx["summary"], ctx["layer"], counters()
    if s is None or not c or not c.get("pipeline.rows") \
            or s.device_count(is_copy) == 0:
        return None
    batch = lay["batch"]
    nbytes = (c["pipeline.h2d_bytes"] + c["pipeline.d2h_bytes"]) \
        / c["pipeline.rows"] * batch
    copy_s = s.device_time_s(is_copy) / (lay["frames_traced"] / batch)
    return nbytes / copy_s / 1e9
