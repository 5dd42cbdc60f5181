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

The decoder's mask head goes further where `head_fused` says so, on the
same observations and the head's type and width. In f32, where the
join's width and the head's fit `ops.kernels.conv_mask_head_takes`, the
whole head is one `ops.kernels.conv_mask_head` launch
(`csrc/conv_mask_head.cu`): both convolutions, the LeakyReLU, the bias
and the sigmoid, the first convolution's output never written out; such
a forward also counts one `model.mask_head_convs`. Otherwise (bf16, a
wider join) its first convolution runs through cuDNN without its bias,
then one `ops.kernels.mask_head` launch (`csrc/mask_head.cu`) for the
rest. Either way the sums run in another order than cuDNN's, so the
mask is close to the chain's, not bit-equal. Such a forward counts one
`model.mask_heads`, and its head's two convolutions under neither
`model.epilogue_*` counter.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cgs_tpu_torch.ops.kernels import (
    bias_act_pool, conv_mask_head as conv_mask_head_op,
    conv_mask_head_takes, mask_head, mask_head_takes,
)
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


def head_fused(x: torch.Tensor, head: nn.Sequential) -> bool:
    """Whether a decoder forward on x runs its mask head `head`
    (conv, LeakyReLU, conv, sigmoid) through `mask_head`; counts it."""
    take = (on_card(x) and not torch.is_grad_enabled()
            and mask_head_takes(x.dtype, head[0].out_channels))
    counts["model.mask_heads"] += take
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


def conv_mask_head(head: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    """`head(x)` as the mask, (N, 1, H, W) float32: one `conv_mask_head`
    where it takes the head (counted under `model.mask_head_convs`), else
    the first convolution without its bias, then one `mask_head` for the
    rest, the parameters in the convolution's type, as autocast has
    them."""
    conv0, act, conv2 = head[0], head[1], head[2]
    if (conv_mask_head_takes(x.dtype, x.shape[1], conv0.out_channels,
                             x.shape[3])
            and not torch.is_autocast_enabled(x.device.type)):
        counts["model.mask_head_convs"] += 1
        mask = conv_mask_head_op(x.permute(0, 2, 3, 1), conv0.weight,
                                 conv0.bias, conv2.weight, conv2.bias,
                                 act.negative_slope)
        return mask.unsqueeze(1)
    y = F.conv2d(x, conv0.weight, None, conv0.stride, conv0.padding,
                 conv0.dilation, conv0.groups)
    mask = mask_head(y.permute(0, 2, 3, 1), conv0.bias.to(y.dtype),
                     conv2.weight.to(y.dtype), conv2.bias.to(y.dtype),
                     act.negative_slope)
    return mask.unsqueeze(1)
