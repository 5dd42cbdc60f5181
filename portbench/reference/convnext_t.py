"""The `convnext_t` pair in plain PyTorch, float32, NCHW, from state
dicts: the ConvNeXt-T critic (Liu et al., arXiv:2201.03545, as
torchvision's `convnext_tiny`) with its taps, the paper's U-Net decoder
on them (nets.py:452-523), and the masker step's loss terms by separate
critic passes (main.py:340-463). No kernel or module of the port, no
cache, no fused pass: the LayerNorms and GELU are written out over the
channel axis of NCHW tensors, the 1x1 projections are einsums, and
`forward_masks` runs blocks of frames one after the other. The port's
keys, which are torchvision's.

Departures from torchvision's convnext_tiny, each the program's too:
- the head has one output, a raw score (`classifier.2` is Linear(768,
  1), no sigmoid), where torchvision's has 1000 classes;
- the critic returns taps besides the score, for the decoder: None at
  the decoder's 32x32 level, then the last block output of stages 1-4
  (the fourth the neck), each before the next downsample's LayerNorm;
- the decoder's 32x32 level has no skip (the stride-4 stem leaves no
  32x32 tap): a plain 2x nearest upsample of the 16x16 output, then its
  3x3 conv; the neck join upsamples the 2x2 neck by 2; widths 96, 96,
  192, 384 and the 768 neck, mask head 16 channels;
- the layer scale gamma is whatever the weights hold (the benchmark
  draws it from the seed, `lib/shapes_convnext_t.py`), not the
  published 1e-6 init;
- no drop-path: this is the eval forward (the program's frozen critic
  runs it in eval mode too);
- the ImageNet normalisation (nets.py:802-804) and the `x.max() > 1`
  rescale (nets.py:721) of the reference's ImageNet critics are kept.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from portbench.reference.model import ingest, set_f32
from portbench.reference.resnet18 import MEAN, STD, _conv

EPS = 1e-6


def _ln(p, key: str, h: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the channels (axis 1) of h, biased variance."""
    mean = h.mean(1, keepdim=True)
    var = ((h - mean) ** 2).mean(1, keepdim=True)
    shape = (1, -1) + (1,) * (h.dim() - 2)
    return (h - mean) / torch.sqrt(var + EPS) * p[key + ".weight"].view(
        shape) + p[key + ".bias"].view(shape)


def _proj(p, key: str, h: torch.Tensor) -> torch.Tensor:
    """A linear layer over the channels of an NCHW tensor."""
    return torch.einsum("nchw,oc->nohw", h, p[key + ".weight"]) \
        + p[key + ".bias"].view(1, -1, 1, 1)


def _gelu(h: torch.Tensor) -> torch.Tensor:
    return 0.5 * h * (1.0 + torch.erf(h / math.sqrt(2.0)))


def depths(p: Dict[str, torch.Tensor]) -> List[int]:
    """The blocks of each stage, read from the keys."""
    return [sum(1 for k in p if k.startswith(f"features.{s}.")
                and k.endswith(".layer_scale")) for s in (1, 3, 5, 7)]


def critic(p: Dict[str, torch.Tensor], x: torch.Tensor):
    """(score (N,), [None, 4 stage taps]) of frames x (N, 3, 64, 64) in
    [0, 1]."""
    x = torch.where(x.max() > 1.0, x / 255.0, x)
    mean = torch.tensor(MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(STD, device=x.device).view(1, 3, 1, 1)
    h = F.conv2d((x - mean) / std, p["features.0.0.weight"],
                 p["features.0.0.bias"], stride=4)
    h = _ln(p, "features.0.1", h)
    taps: List[Optional[torch.Tensor]] = [None]
    for s, n in enumerate(depths(p)):
        if s:
            d = f"features.{2 * s}"
            h = F.conv2d(_ln(p, d + ".0", h), p[d + ".1.weight"],
                         p[d + ".1.bias"], stride=2)
        for j in range(n):
            b = f"features.{2 * s + 1}.{j}"
            w = p[b + ".block.0.weight"]
            y = F.conv2d(h, w, p[b + ".block.0.bias"], padding=3,
                         groups=w.shape[0])
            y = _ln(p, b + ".block.2", y)
            y = _proj(p, b + ".block.5", _gelu(_proj(p, b + ".block.3", y)))
            h = h + p[b + ".layer_scale"].view(1, -1, 1, 1) * y
        taps.append(h)
    pooled = _ln(p, "classifier.0", h.mean((2, 3)))
    score = pooled @ p["classifier.2.weight"].t() + p["classifier.2.bias"]
    return score[:, 0], taps


def _join(skip: Optional[torch.Tensor], x: torch.Tensor, hw: int
          ) -> torch.Tensor:
    up = F.interpolate(x, size=(hw, hw), mode="nearest")
    return up if skip is None else torch.cat([skip, up], 1)


def decoder(p: Dict[str, torch.Tensor], x: torch.Tensor,
            taps: List[Optional[torch.Tensor]]) -> torch.Tensor:
    """The mask (N, 1, 64, 64) in (0, 1) from the frames and the taps;
    the 32x32 level, with no tap, joins nothing to its upsample."""
    out = _conv(p, "dec_model.4", taps[4], pad=0)
    for i, hw in zip((3, 2, 1, 0), (4, 8, 16, 32)):
        out = _conv(p, f"dec_model.{i}", _join(taps[i], out, hw))
    h = _conv(p, "masker.0", _join(x, out, 64))
    h = _conv(p, "masker.2", F.leaky_relu(h, 0.01))
    return torch.sigmoid(h)


@torch.no_grad()
def forward_masks(params: dict, frames_u8: torch.Tensor,
                  block: int = 4096):
    """(score (N,), mask (N, H, W)) float32 of eval-mode inference over
    uint8 (N, H, W, 3) frames on any device, in blocks."""
    set_f32()
    preds, masks = [], []
    for lo in range(0, frames_u8.shape[0], block):
        x = ingest(frames_u8[lo:lo + block])
        score, taps = critic(params["critic"], x)
        preds.append(score)
        masks.append(decoder(params["masker"], x, taps)[:, 0])
    return torch.cat(preds), torch.cat(masks)


def masker_loss(train: dict, params: dict, a: torch.Tensor, y: torch.Tensor,
                b: torch.Tensor, live: bool):
    """(loss, {'replace', 'inject', 'norm', 'critic'}) of one masker step
    by separate critic passes (main.py:360-429): critic(A) with its
    taps, critic(B), the mask, critic(replaced), critic(injected); a
    live critic adds its regression term. Inject on; L2 = 0; the
    sparsity on |Z| (staticnorm)."""
    if not train["inject"] or not train["staticnorm"] or train["L2"]:
        raise ValueError("the reference masker loss takes inject, "
                         "staticnorm and L2 = 0")
    cp, mp = params["critic"], params["masker"]
    pred, taps = critic(cp, a)
    negpred = critic(cp, b)[0].detach()
    z = decoder(mp, a, taps)
    replacevalue = critic(cp, a * (1.0 - z) + z * b)[0]
    injectvalue = critic(cp, b * (1.0 - z) + z * a)[0]
    terms = {"replace": ((replacevalue - negpred) ** 2).mean(),
             "inject": ((injectvalue - pred.detach()) ** 2).mean(),
             "norm": float(train["L1"]) * z.abs().mean(),
             "critic": ((pred - y) ** 2).mean() if live
             else torch.zeros((), device=a.device)}
    loss = terms["replace"] + terms["inject"] + terms["norm"]
    if live:
        loss = float(train["lfak"]) * terms["critic"] + loss
    return loss, terms
