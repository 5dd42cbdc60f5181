"""`window_attn_roofline.swin_v2_t`: the critic forward's 12 window
attention launches (the kernels `window_attn_ms_per_batch.process`
times) against their bound (`lib/shapes_swin_v2_t.py`): the larger of
their bytes (`window_attn_bytes`: q, k and v read once and the output
written once, each layer's bias once a batch) over the HBM rate and
their FLOPs (`window_attn_flops`: 4 N^2 d a window and head) over the
f32 peak outside the tensor cores, over their device time a batch of
the traced call; None where `_counted.per_batch_s` finds nothing to
read."""
from portbench.lib import shapes_swin_v2_t
from portbench.metrics._counted import per_batch_s

LAYER = "model step: models/swin.py under pipeline.py"
UNIT = "%"
MOVES = "frames_per_s"
NAMES = ("fmha_cutlassF",)


def read(ctx):
    t = per_batch_s(ctx, "model.window_attns", NAMES)
    if t is None:
        return None
    cfg, batch = ctx["config"], ctx["layer"]["batch"]
    bound = ctx["flops"].bound_s(
        nbytes=shapes_swin_v2_t.window_attn_bytes(cfg, batch),
        flops=shapes_swin_v2_t.window_attn_flops(cfg, batch))
    return 100.0 * bound / t
