"""`host_work_ms_per_batch.process`: the host's own work in
`MaskPipeline.run` per batch, the span `cgs.pipeline.run` less the
host's blocks on the card inside it (`cgs.pipeline.wait`), over the
batches (`cgs.pipeline.forward`), from the program's span totals of the
traced calls. Where it nears a batch's wall time the host sets the
pace, and faster kernels stop moving `frames_per_s`."""
from portbench.metrics._spans import RUN, span_ms

LAYER = "pipeline host path: pipeline.py run, place_input, read-back"
UNIT = "ms"
MOVES = "frames_per_s"


def read(ctx):
    return span_ms([RUN], ["cgs.pipeline.wait"], per="cgs.pipeline.forward")
