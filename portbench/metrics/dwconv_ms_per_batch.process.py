"""`dwconv_ms_per_batch.process`: the device time of the depthwise 7x7
convolutions (ConvNeXt's 18 a forward) per batch of the traced call:
the kernels named `conv2d_c1_k1_nhwc`, cuDNN's depthwise kernel on
channels_last activations on the H100 (one launch a layer; the bias
PyTorch adds after it is an elementwise kernel, read by
`pointwise_ms_per_batch.process`). The depthwise layers a forward
applies come from the program's counter `model.dw_convs`; the reading
is None where `_counted.per_batch_s` finds nothing to read."""
from portbench.metrics._counted import per_batch_s

LAYER = "model step: models/convnext.py under pipeline.py"
UNIT = "ms"
MOVES = "frames_per_s"
NAMES = ("conv2d_c1_k1_nhwc",)


def read(ctx):
    t = per_batch_s(ctx, "model.dw_convs", NAMES)
    return None if t is None else 1e3 * t
