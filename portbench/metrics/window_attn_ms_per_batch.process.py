"""`window_attn_ms_per_batch.process`: the device time of the window
attention per batch of the traced call (Swin V2-T's 12 layers a
forward): the kernels named `fmha_cutlassF`, PyTorch's memory-efficient
attention forward (`fmha_cutlassF_f32_aligned_64x64_rf_sm80` in float32
on the H100), which the program's fused route launches once a layer.
The attention layers a forward applies come from the program's counter
`model.window_attns`; the reading is None where `_counted.per_batch_s`
finds nothing to read, as on a program without that counter or whose
attention took another route."""
from portbench.metrics._counted import per_batch_s

LAYER = "model step: models/swin.py under pipeline.py"
UNIT = "ms"
MOVES = "frames_per_s"
NAMES = ("fmha_cutlassF",)


def read(ctx):
    t = per_batch_s(ctx, "model.window_attns", NAMES)
    return None if t is None else 1e3 * t
