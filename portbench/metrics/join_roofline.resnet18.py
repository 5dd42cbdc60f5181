"""`join_roofline.resnet18`: the decoder's five upsample-into-concat
joins (`ops/upsample.py:up_cat`, `csrc/upsample2x.cu`) at the `resnet18`
pyramid's shapes (`lib/shapes_resnet18.py:joins`: 256 @ 4x4 with the
512 @ 2x2 neck up to 3 @ 64x64 with 64 @ 32x32), summed over a batch,
against their byte bound: skip and input read once, the joined buffer
written once."""
from portbench.lib import shapes_resnet18
from portbench.metrics._common import roofline

LAYER = "kernels: ops/kernels.py, ops/upsample.py, csrc/"
UNIT = "%"
MOVES = "frames_per_s"


def read(ctx):
    batch = ctx["layer"].get("batch")
    if batch is None or ctx["summary"] is None:
        return None
    return roofline(ctx, ("upsample_cat_fwd",),
                    shapes_resnet18.joins_bytes(ctx["config"], batch), 5)
