"""`run_lead_ms_per_call.process`: the host time at the start of each
`MaskPipeline.run` call before the card holds any of its work, the span
`cgs.pipeline.lead` (the first batch's slot, padding and upload: at
batch 8192, 100.7 MB copied into a pinned slot), per traced call, from
the program's span totals."""
from portbench.metrics._spans import span_ms

LAYER = "pipeline host path: pipeline.py run, place_input, read-back"
UNIT = "ms"
MOVES = "frames_per_s"


def read(ctx):
    return span_ms(["cgs.pipeline.lead"])
