"""U-Net mask decoder (PyTorch port of `cgs_tpu/models/decoder.py`;
reference nets.py:452-523 `UnetDecoder`).

    out4 = 1x1 conv(bottleneck -> bottleneck) on embeds[4]      # 1x1
    in3  = cat(embeds[3], up_f(out4));    out3 = 3x3 conv       # 4x4
    in2  = cat(embeds[2], up(out3));      out2 = 3x3 conv       # 8x8
    in1  = cat(embeds[1], up(out2));      out1 = 3x3 conv       # 16x16
    in0  = cat(embeds[0], up(out1));      out0 = 3x3 conv       # 32x32
    mask = sigmoid(conv(leaky_relu(conv(cat(X, up(out0))))))    # 64x64

No activation sits between the decoder convs (the reference binds
LeakyReLU 0.01 but uses it only in the mask head, nets.py:487-492).
`dec_model.{0..4}` and `masker.{0,2}` are the reference's state_dict
keys. The neck join's factor f is read from the pyramid, the height of
embeds[3] over that of embeds[4]: 4 for the paper critic's 1x1 neck, 2
for ResNet-18's, ConvNeXt-T's and Swin V2-T's 2x2 one
(`models/zoo.py:ResNetCritic`, `models/convnext.py`, `models/swin.py`).
A pyramid with no 32x32 tap (ConvNeXt-T's stride-4 stem and Swin's
stride-4 patch embedding leave none) has `edims[0] = 0` and `embeds[0] =
None`: that level is `conv(up(out1))`, the join with no skip channels. Each
`cat(skip, up(...))` is one `ops.upsample.up_cat`, the fused
upsample-into-concat kernel on the card (the x4 join too): 5 launches
per forward and 5 per backward, and no `torch.cat`. Activations stay
`torch.channels_last`, so the NHWC views the kernel takes are
`permute`s with no copy, and the joins keep the JAX layout's channel
order (skip first). On the card with grad mode off, each conv and its
bias run as the conv without its bias and one `bias_act_pool` launch
(`models/epilogue.py`): 5 a forward, bit-equal to the modules' chain;
the mask head runs in f32 as one `conv_mask_head` launch for both its
convs, the LeakyReLU, the biases and the sigmoid, in bf16 as its first
conv without its bias and one `mask_head` launch for the rest, close to
the chain's mask either way (its sums in another order).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from cgs_tpu_torch.models import epilogue
from cgs_tpu_torch.models.critic import compute_autocast
from cgs_tpu_torch.ops.upsample import up_cat


class UnetDecoder(nn.Module):
    """Decoder-only U-Net over the critic's skip features."""

    def __init__(self, edims: Sequence[int] = (8, 8, 8, 16),
                 ddims: Sequence[int] = (8, 8, 8, 16),
                 bottleneck: int = 32, masker_channels: int = 16,
                 colorchs: int = 3, chfak: int = 1,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        e = [k * chfak for k in edims]
        d = [k * chfak for k in ddims]
        neck = bottleneck * chfak
        self.compute_dtype = compute_dtype
        self.dec_model = nn.ModuleList([
            nn.Conv2d(e[0] + d[1], d[0], 3, padding=1),
            nn.Conv2d(e[1] + d[2], d[1], 3, padding=1),
            nn.Conv2d(e[2] + d[3], d[2], 3, padding=1),
            nn.Conv2d(e[3] + neck, d[3], 3, padding=1),
            nn.Conv2d(neck, neck, 1),
        ])
        # masker channels are NOT scaled by chfak (nets.py:466)
        self.masker = nn.Sequential(
            nn.Conv2d(colorchs + d[0], masker_channels, 3, padding=1),
            nn.LeakyReLU(0.01),
            nn.Conv2d(masker_channels, 1, 3, padding=1),
            nn.Sigmoid())

    def forward(self, x: torch.Tensor, embeds: List[torch.Tensor]
                ) -> torch.Tensor:
        """x: (B, 3, 64, 64) in [0, 1]; embeds: the critic pyramid
        (embeds[0] None where edims[0] is 0).
        Returns the mask (B, 1, 64, 64) in (0, 1), float32."""
        x = x.to(self.compute_dtype)
        embeds = [None if e is None else e.to(self.compute_dtype)
                  for e in embeds]
        dec, head = self.dec_model, self.masker
        head_fused = epilogue.head_fused(x, head)
        fused = epilogue.fused(x, len(dec) + (0 if head_fused else 2))
        conv = epilogue.conv_epilogue if fused else (lambda m, t: m(t))
        with compute_autocast(x.device.type, self.compute_dtype):
            out = conv(dec[4], embeds[4])
            neck_up = embeds[3].shape[2] // embeds[4].shape[2]
            out = conv(dec[3], up_cat(embeds[3], out, neck_up))
            out = conv(dec[2], up_cat(embeds[2], out))
            out = conv(dec[1], up_cat(embeds[1], out))
            out = conv(dec[0], up_cat(embeds[0], out))
            if head_fused:
                return epilogue.conv_mask_head(head, up_cat(x, out))
            if fused:
                h = conv(head[0], up_cat(x, out), "leaky_relu",
                         slope=head[1].negative_slope)
                return conv(head[2], h, "sigmoid", out_dtype=torch.float32)
            h = head[0](up_cat(x, out))
            h = head[2](head[1](h))
        return torch.sigmoid(h.float())
