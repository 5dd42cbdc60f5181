"""`host_idle_ms_per_batch.process`: the card's idle time while the host
ran `MaskPipeline.run`'s own work, per batch of the traced call: the
idle gaps named after a `cgs.pipeline.*` span (`pipeline.py`: run, pad,
upload, forward, read_back, assemble), over the call's batches."""
from portbench.metrics._program import span_gap_s

LAYER = "pipeline host path: pipeline.py run, place_input, read-back"
UNIT = "ms"
MOVES = "frames_per_s"


def read(ctx):
    idle = span_gap_s(ctx["summary"], "cgs.pipeline.")
    if idle is None:
        return None
    lay = ctx["layer"]
    return 1e3 * idle / (lay["frames_traced"] / lay["batch"])
