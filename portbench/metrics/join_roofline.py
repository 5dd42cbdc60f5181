"""`join_roofline`: the decoder's five upsample-into-concat
joins (`ops/upsample.py:up_cat`, `csrc/upsample2x.cu`), summed over a
batch, against their byte bound: skip and input read once, the joined
buffer written once."""
from portbench.metrics._common import roofline

LAYER = "kernels: ops/kernels.py, ops/upsample.py, csrc/"
UNIT = "%"
MOVES = "frames_per_s"


def read(ctx):
    batch = ctx["layer"].get("batch")
    if batch is None or ctx["summary"] is None:
        return None
    return roofline(ctx, ("upsample_cat_fwd",),
                    ctx["flops"].joins_bytes(ctx["config"], batch), 5)
