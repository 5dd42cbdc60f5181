"""ConvNeXt-T as the reward critic (Liu et al., "A ConvNet for the
2020s", arXiv:2201.03545; torchvision `convnext_tiny`), for the paper's
U-Net masker on its four stages (`models/build.py`, `--critic
convnext_t`).

    stem      Conv2d(3, 96, k=4, s=4) -> LayerNorm2d(96)          16x16
    stage i   blocks at width d_i = 96, 192, 384, 768, depths 3, 3,
              9, 3, at 16x16, 8x8, 4x4, 2x2; before stages 2-4
              LayerNorm2d(d) -> Conv2d(d, 2d, k=2, s=2)
    block     y = dwconv7x7(x) (groups d, pad 3, bias) -> NHWC ->
              LayerNorm(d) -> Linear(d, 4d) -> GELU (erf) ->
              Linear(4d, d) -> NCHW;  x + drop_path(gamma * y)
    head      global average pool -> LayerNorm(768) -> Linear(768, 1)

Every LayerNorm has eps 1e-6. The state_dict keys are torchvision's
(`features.0.{0,1}` the stem, `features.{1,3,5,7}.{j}.block.{0,2,3,5}`
and `.layer_scale` the blocks, `features.{2,4,6}.{0,1}` the
downsamples, `classifier.{0,2}` the head), so a published ImageNet
backbone loads with `models/interop.py:load_pt_convnext_critic(...,
head=False)`; only its 1000-class `classifier.2` differs from the
critic's one-output head. gamma starts at the published 1e-6.

The critic interface of `models/critic.py:Critic`: `forward(x,
collect=True)` also returns the taps, stored channels_last: None where
the decoder's 32x32 level would take one (the stride-4 stem leaves
none), then the last block output of stages 1-4 (96 @ 16x16, 192 @
8x8, 384 @ 4x4, 768 @ 2x2, the neck), each before the next
downsample's LayerNorm. The score is raw, as `ResNetCritic`'s, and the
input is `ImageNetCritic`'s. Drop-path (torchvision's
`StochasticDepth(p, "row")`, p rising linearly from 0 to `drop_path`
over the 18 blocks) acts in train mode only and draws from `generator`.
The LayerNorms run over channels on NHWC views of channels_last
activations and the 1x1 projections are `nn.Linear` GEMMs on them:
no layout copy anywhere. Under `compute_dtype=torch.bfloat16` the
convolutions and linears run in bf16 with f32 parameters, the
LayerNorms in f32 (autocast's rule).

`layer_norms` (23) and `dw_convs` (18) list the forward's LayerNorm
and depthwise layers (the counters `model.layer_norms` and
`model.dw_convs`, `models/build.py:critic_forward`), `drop_paths` its
drop-path layers (a frozen critic runs them in eval mode,
`train/steps.py:set_masker_modes`). Under a profiler the stem, each
stage (its downsample with it) and the head are the spans
`cgs.model.convnext.stem`, `.stage1` ... `.stage4` and `.head`.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from cgs_tpu_torch.models.critic import compute_autocast
from cgs_tpu_torch.models.zoo import ImageNetCritic
from cgs_tpu_torch.utils.profiling import span

DIMS = (96, 192, 384, 768)
DEPTHS = (3, 3, 9, 3)
LN_EPS = 1e-6
LAYER_SCALE = 1e-6        # the published init of gamma
DROP_PATH = 0.1           # convnext_tiny's stochastic depth
CL = torch.channels_last


def drop_path(x: torch.Tensor, p: float, training: bool,
              generator: Optional[torch.Generator] = None
              ) -> torch.Tensor:
    """torchvision's `stochastic_depth(x, p, "row", training)`: each row
    (frame) kept with probability 1 - p and scaled by 1 / (1 - p), or
    zeroed, drawn from `generator`; x itself when not training or p 0."""
    if not training or p == 0.0:
        return x
    keep = 1.0 - p
    noise = torch.empty((x.shape[0],) + (1,) * (x.dim() - 1),
                        dtype=x.dtype, device=x.device)
    noise.bernoulli_(keep, generator=generator)
    if keep > 0.0:
        noise.div_(keep)
    return x * noise


class DropPath(nn.Module):
    """The drop-path of one block: its rate, and its mode."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        return drop_path(x, self.p, self.training, generator)


class Permute(nn.Module):
    """torchvision's `Permute` (a view: NCHW channels_last <-> NHWC)."""

    def __init__(self, dims: Sequence[int]):
        super().__init__()
        self.dims = tuple(dims)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.permute(self.dims)


class LayerNorm2d(nn.LayerNorm):
    """LayerNorm over the channels of an NCHW tensor, on its NHWC view
    (no copy for a channels_last one)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 2, 3, 1)
        x = F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                         self.eps)
        return x.permute(0, 3, 1, 2)


class Block(nn.Module):
    """torchvision's `CNBlock` at width `dim`."""

    def __init__(self, dim: int, drop: float):
        super().__init__()
        self.block = nn.Sequential(
            nn.Conv2d(dim, dim, 7, padding=3, groups=dim),
            Permute((0, 2, 3, 1)),
            nn.LayerNorm(dim, eps=LN_EPS),
            nn.Linear(dim, 4 * dim),
            nn.GELU(),
            nn.Linear(4 * dim, dim),
            Permute((0, 3, 1, 2)))
        self.layer_scale = nn.Parameter(torch.full((dim, 1, 1),
                                                   LAYER_SCALE))
        self.drop_path = DropPath(drop)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        y = self.drop_path(self.layer_scale * self.block(x), generator)
        return x + y


class ConvNeXtCritic(ImageNetCritic):
    """ConvNeXt-T features and a one-output head (module docstring)."""

    def __init__(self, dims: Sequence[int] = DIMS,
                 depths: Sequence[int] = DEPTHS,
                 drop_path: float = DROP_PATH,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        total, seen = sum(depths), 0
        layers: List[nn.Module] = [nn.Sequential(
            nn.Conv2d(3, dims[0], 4, stride=4),
            LayerNorm2d(dims[0], eps=LN_EPS))]
        for i, (dim, depth) in enumerate(zip(dims, depths)):
            if i:
                layers.append(nn.Sequential(
                    LayerNorm2d(dims[i - 1], eps=LN_EPS),
                    nn.Conv2d(dims[i - 1], dim, 2, stride=2)))
            blocks = []
            for _ in range(depth):
                blocks.append(Block(dim, drop_path * seen / max(total - 1,
                                                                1)))
                seen += 1
            layers.append(nn.Sequential(*blocks))
        self.features = nn.Sequential(*layers)
        self.avgpool = nn.AdaptiveAvgPool2d(1)
        self.classifier = nn.Sequential(
            LayerNorm2d(dims[-1], eps=LN_EPS), nn.Flatten(1),
            nn.Linear(dims[-1], 1))
        mods = list(self.modules())
        self.layer_norms = [m for m in mods if isinstance(m, nn.LayerNorm)]
        self.dw_convs = [m for m in mods if isinstance(m, nn.Conv2d)
                         and m.groups > 1]
        self.drop_paths = [m for m in mods if isinstance(m, DropPath)]

    def forward(self, x: torch.Tensor, collect: bool = False,
                generator: Optional[torch.Generator] = None):
        """x: (B, 3, 64, 64). The score (B, 1) and, with collect=True,
        the taps [None, stage1, ..., stage4]."""
        x = self.normalize(x).contiguous(memory_format=CL)
        taps: List[Optional[torch.Tensor]] = [None]
        f = self.features
        with compute_autocast(x.device.type, self.compute_dtype):
            with span("cgs.model.convnext.stem"):
                x = f[0](x)
            for s in range(4):
                with span(f"cgs.model.convnext.stage{s + 1}"):
                    if s:
                        x = f[2 * s](x)
                    for block in f[2 * s + 1]:
                        x = block(x, generator)
                taps.append(x.contiguous(memory_format=CL))
            with span("cgs.model.convnext.head"):
                score = self.classifier(self.avgpool(x))
        if self.compute_dtype == torch.bfloat16:
            score = score.float()
        return (score, taps) if collect else score
