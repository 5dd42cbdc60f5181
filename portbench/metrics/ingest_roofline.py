"""`ingest_roofline`: the ingest kernel (`ops/kernels.py:
gather_normalize_u8`, `csrc/normalize_u8.cu`) against its byte bound,
one launch a batch: uint8 frames read once, float32 written once."""
from portbench.metrics._common import roofline

LAYER = "kernels: ops/kernels.py, ops/upsample.py, csrc/"
UNIT = "%"
MOVES = "frames_per_s"


def read(ctx):
    batch = ctx["layer"].get("batch")
    if batch is None or ctx["summary"] is None:
        return None
    return roofline(ctx, ("ingest_rows", "ingest_any"),
                    ctx["flops"].ingest_bytes(batch), 1)
