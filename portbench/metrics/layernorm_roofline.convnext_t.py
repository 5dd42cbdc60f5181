"""`layernorm_roofline.convnext_t`: the critic forward's LayerNorms (23
a ConvNeXt-T forward: the stem's, the 18 blocks', the 3 downsamples'
and the head's; PyTorch's `layer_norm` kernels) against their byte
bound (`lib/shapes_convnext_t.py:layer_norms_bytes`: each reads its
input once and writes its output once), over their device time a batch
of the traced call. The LayerNorms a forward applies come from the
program's counter `model.layer_norms`; the reading is None where
`_counted.per_batch_s` finds nothing to read."""
from portbench.lib import shapes_convnext_t
from portbench.metrics._counted import per_batch_s

LAYER = "model step: models/convnext.py under pipeline.py"
UNIT = "%"
MOVES = "frames_per_s"
NAMES = ("layer_norm",)


def read(ctx):
    t = per_batch_s(ctx, "model.layer_norms", NAMES)
    if t is None:
        return None
    nbytes = shapes_convnext_t.layer_norms_bytes(ctx["config"],
                                                 ctx["layer"]["batch"])
    return 100.0 * ctx["flops"].bound_s(nbytes=nbytes) / t
