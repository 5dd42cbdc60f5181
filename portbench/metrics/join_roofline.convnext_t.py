"""`join_roofline.convnext_t`: the decoder's five upsample-into-concat
joins (`ops/upsample.py:up_cat`, `csrc/upsample2x.cu`) at the
`convnext_t` pyramid's shapes (`lib/shapes_convnext_t.py:joins`: 384 @
4x4 with the 768 @ 2x2 neck, down to 3 @ 64x64 with 96 @ 32x32, and the
32x32 level's join with no skip, the 16x16 output upsampled alone),
summed over a batch, against their byte bound: skip and input read once,
the joined buffer written once."""
from portbench.lib import shapes_convnext_t
from portbench.metrics._common import roofline

LAYER = "kernels: ops/kernels.py, ops/upsample.py, csrc/"
UNIT = "%"
MOVES = "frames_per_s"


def read(ctx):
    batch = ctx["layer"].get("batch")
    if batch is None or ctx["summary"] is None:
        return None
    return roofline(ctx, ("upsample_cat_fwd",),
                    shapes_convnext_t.joins_bytes(ctx["config"], batch), 5)
