"""The critic and the mask decoder in plain PyTorch, float32, NCHW, from a
state dict (reference nets.py:160-212 `NewCritic` and nets.py:452-523
`UnetDecoder`; the port's keys). No kernel of the port, no cache, no
batching: `forward_masks` runs blocks of frames one after the other.

Dropout draws replay the port's generator stream: one
`uniform_` of a float32 tensor per dropout layer, in layer order, with
the activation's memory order, which for the convolution stack is the
port's channels_last (N, H, W, C) order. So the same seed gives the same
masks on both sides.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

INV255 = float(np.float32(1.0 / 255.0))
CONVS = ("features.0", "features.3", "features.6", "features.10")


def set_f32() -> None:
    """float32 means float32: no TF32 in cuDNN or cuBLAS."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def ingest(u8: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) uint8 -> (N, 3, H, W) float32 in [0, 1]
    (main.py:189 `.float()/255`, as the multiply by float32(1/255))."""
    return (u8.float() * INV255).permute(0, 3, 1, 2).contiguous()


def dropout(x: torch.Tensor, p: float, gen: Optional[torch.Generator]):
    """Inverted dropout; the uniforms are drawn in NHWC memory order for
    a 4-d activation."""
    if gen is None or p == 0.0:
        return x
    if x.dim() == 4:
        n, c, h, w = x.shape
        u = torch.empty((n, h, w, c), device=x.device).uniform_(
            generator=gen).permute(0, 3, 1, 2)
    else:
        u = torch.empty(x.shape, device=x.device).uniform_(generator=gen)
    return torch.where(u >= p, x / (1.0 - p), torch.zeros_like(x))


def critic(p: Dict[str, torch.Tensor], x: torch.Tensor, drop: float = 0.0,
           gen: Optional[torch.Generator] = None):
    """(pred (N,), [4 post-pool features, bottleneck]); dropout is live
    when `gen` is given."""
    embeds: List[torch.Tensor] = []
    h = x
    for i, key in enumerate(CONVS):
        h = F.max_pool2d(F.relu(F.conv2d(h, p[key + ".weight"],
                                         p[key + ".bias"], padding=1)), 2)
        embeds.append(h)
        if i >= 2:
            h = dropout(h, drop, gen)
    h = F.relu(F.conv2d(h, p["features.14.weight"], p["features.14.bias"]))
    embeds.append(h)
    h = F.relu(F.linear(h.flatten(1), p["crit.1.weight"], p["crit.1.bias"]))
    h = dropout(h, drop, gen)
    h = F.linear(h, p["crit.4.weight"], p["crit.4.bias"])
    return torch.sigmoid(h)[:, 0], embeds


def _up(x: torch.Tensor, f: int) -> torch.Tensor:
    return x.repeat_interleave(f, 2).repeat_interleave(f, 3)


def _conv(p, key, x, pad=1):
    return F.conv2d(x, p[key + ".weight"], p[key + ".bias"], padding=pad)


def decoder(p: Dict[str, torch.Tensor], x: torch.Tensor,
            embeds: List[torch.Tensor]) -> torch.Tensor:
    """The mask (N, 1, H, W) in (0, 1); no activation between the decoder
    convolutions, LeakyReLU 0.01 in the mask head (nets.py:487-492)."""
    out = _conv(p, "dec_model.4", embeds[4], pad=0)
    out = _conv(p, "dec_model.3", torch.cat([embeds[3], _up(out, 4)], 1))
    out = _conv(p, "dec_model.2", torch.cat([embeds[2], _up(out, 2)], 1))
    out = _conv(p, "dec_model.1", torch.cat([embeds[1], _up(out, 2)], 1))
    out = _conv(p, "dec_model.0", torch.cat([embeds[0], _up(out, 2)], 1))
    h = _conv(p, "masker.0", torch.cat([x, _up(out, 2)], 1))
    h = _conv(p, "masker.2", F.leaky_relu(h, 0.01))
    return torch.sigmoid(h)


@torch.no_grad()
def forward_masks(params: dict, frames_u8: torch.Tensor,
                  block: int = 4096):
    """(pred (N,), mask (N, H, W)) float32 of eval-mode inference over
    uint8 (N, H, W, 3) frames on any device, in blocks."""
    set_f32()
    preds, masks = [], []
    for lo in range(0, frames_u8.shape[0], block):
        x = ingest(frames_u8[lo:lo + block])
        pred, embeds = critic(params["critic"], x)
        preds.append(pred)
        masks.append(decoder(params["masker"], x, embeds)[:, 0])
    return torch.cat(preds), torch.cat(masks)
