"""The eval forward's convolution epilogues.

On the card, with grad mode off, each convolution of `Critic` and
`UnetDecoder` runs through cuDNN without its bias, and one
`ops.kernels.bias_act_pool` launch (`csrc/conv_epilogue.cu`) adds the
bias, applies the activation and, where the block pools, takes the 2x2
max: one pass over the convolution's output where PyTorch makes three to
five (the bias add, the activation, the pool and its indices). The
result is bit-equal to the modules' own chain in f32 and bf16, and the
route reads the same parameters.

`fused(x, convs)` decides for a forward, on what it can observe: x on a
CUDA device and grad mode off (`torch.no_grad`, `inference_mode`), as in
`MaskPipeline`, the contrastive sweep and the training visualisations.
A forward under grad mode keeps the eager chain, even where nothing in
it requires grad (the -frozen critic's passes in a masker step), so a
training step and its captured graph stay as they are. It adds the
forward's convolutions to the counter `model.epilogue_fused` or
`model.epilogue_eager` (`utils/profiling.py:counts`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cgs_tpu_torch.ops.kernels import bias_act_pool
from cgs_tpu_torch.utils.profiling import counts


def on_card(x: torch.Tensor) -> bool:
    """The route's device check, one place a CPU test can fake."""
    return x.is_cuda


def fused(x: torch.Tensor, convs: int) -> bool:
    """Whether a forward on x with `convs` convolutions takes the fused
    epilogues; counts them under the route taken."""
    take = on_card(x) and not torch.is_grad_enabled()
    counts["model.epilogue_fused" if take else "model.epilogue_eager"] += (
        convs)
    return take


def conv_epilogue(conv: nn.Conv2d, x: torch.Tensor, act: str = "none",
                  pool: int = 1, slope: float = 0.01,
                  out_dtype=None) -> torch.Tensor:
    """`conv(x)`, its activation and, with pool 2, `MaxPool2d(2)`: the
    convolution without its bias, then one `bias_act_pool`. x and the
    result are NCHW stored channels_last; under autocast the convolution
    and the bias are in the autocast type, as `conv(x)` has them."""
    y = F.conv2d(x, conv.weight, None, conv.stride, conv.padding,
                 conv.dilation, conv.groups)
    out = bias_act_pool(y.permute(0, 2, 3, 1), conv.bias.to(y.dtype), act,
                        pool, slope, out_dtype)
    return out.permute(0, 3, 1, 2)
