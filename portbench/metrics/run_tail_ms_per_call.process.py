"""`run_tail_ms_per_call.process`: the host time at the end of each
`MaskPipeline.run` call after the card holds none of its work, the span
`cgs.pipeline.tail` (the last batch's rows written from its slot into
the call's outputs once its read-back has landed: at batch 8192, 67.1 MB
into fresh pages), per traced call, from the program's span totals."""
from portbench.metrics._spans import span_ms

LAYER = "pipeline host path: pipeline.py run, place_input, read-back"
UNIT = "ms"
MOVES = "frames_per_s"


def read(ctx):
    return span_ms(["cgs.pipeline.tail"])
