"""`dwconv_roofline.convnext_t`: the critic forward's 18 depthwise 7x7
convolutions (the kernels `dwconv_ms_per_batch.process` times) against
their bound (`lib/shapes_convnext_t.py`): the larger of their bytes
(`dw_convs_bytes`: each reads its input once and writes its output
once) over the HBM rate and their FLOPs (2 x `dw_convs`' multiply-adds)
over the f32 peak outside the tensor cores, over their device time a
batch of the traced call; None where `_counted.per_batch_s` finds
nothing to read."""
from portbench.lib import shapes_convnext_t
from portbench.metrics._counted import per_batch_s

LAYER = "model step: models/convnext.py under pipeline.py"
UNIT = "%"
MOVES = "frames_per_s"
NAMES = ("conv2d_c1_k1_nhwc",)


def read(ctx):
    t = per_batch_s(ctx, "model.dw_convs", NAMES)
    if t is None:
        return None
    cfg, batch = ctx["config"], ctx["layer"]["batch"]
    flops = 2 * batch * sum(L.macs_per_frame
                            for L in shapes_convnext_t.dw_convs(cfg))
    bound = ctx["flops"].bound_s(
        nbytes=shapes_convnext_t.dw_convs_bytes(cfg, batch), flops=flops)
    return 100.0 * bound / t
