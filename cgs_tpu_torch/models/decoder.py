"""U-Net mask decoder (PyTorch port of `cgs_tpu/models/decoder.py`;
reference nets.py:452-523 `UnetDecoder`).

    out4 = 1x1 conv(bottleneck -> bottleneck) on embeds[4]      # 1x1
    in3  = cat(embeds[3], up(up(out4)));  out3 = 3x3 conv       # 4x4
    in2  = cat(embeds[2], up(out3));      out2 = 3x3 conv       # 8x8
    in1  = cat(embeds[1], up(out2));      out1 = 3x3 conv       # 16x16
    in0  = cat(embeds[0], up(out1));      out0 = 3x3 conv       # 32x32
    mask = sigmoid(conv(leaky_relu(conv(cat(X, up(out0))))))    # 64x64

No activation sits between the decoder convs (the reference binds
LeakyReLU 0.01 but uses it only in the mask head, nets.py:487-492).
`dec_model.{0..4}` and `masker.{0,2}` are the reference's state_dict
keys. Every `up` is `ops.upsample.upsample2x`, the CUDA kernel on the
card: 6 launches per forward. Activations stay `torch.channels_last`,
so the NHWC view the kernel takes is a `permute` with no copy, and the
concats keep the JAX layout's channel order.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from cgs_tpu_torch.models.critic import compute_autocast
from cgs_tpu_torch.ops.upsample import upsample2x


def up2(t: torch.Tensor) -> torch.Tensor:
    """x2 nearest upsample of an NCHW channels_last activation."""
    return upsample2x(t.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


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
        """x: (B, 3, 64, 64) in [0, 1]; embeds: the critic pyramid.
        Returns the mask (B, 1, 64, 64) in (0, 1), float32."""
        x = x.to(self.compute_dtype)
        embeds = [e.to(self.compute_dtype) for e in embeds]
        dec = self.dec_model
        with compute_autocast(x.device.type, self.compute_dtype):
            out = dec[4](embeds[4])
            out = dec[3](torch.cat([embeds[3], up2(up2(out))], dim=1))
            out = dec[2](torch.cat([embeds[2], up2(out)], dim=1))
            out = dec[1](torch.cat([embeds[1], up2(out)], dim=1))
            out = dec[0](torch.cat([embeds[0], up2(out)], dim=1))
            h = self.masker[0](torch.cat([x, up2(out)], dim=1))
            h = self.masker[2](self.masker[1](h))
        return torch.sigmoid(h.float())
