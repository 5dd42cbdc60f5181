"""Reward critic CNN (PyTorch port of `cgs_tpu/models/critic.py`;
reference nets.py:160-212 `NewCritic`).

The modules sit at the reference's `nn.Sequential` indices, so
`state_dict()` keys are `features.{0,3,6,10,14}` and `crit.{1,4}` and a
reference or `cgs_tpu` `.pt` loads with plain `load_state_dict`:

    features: 0 conv, 1 relu, 2 pool, 3 conv, 4 relu, 5 pool, 6 conv,
              7 relu, 8 pool, 9 dropout, 10 conv, 11 relu, 12 pool,
              13 dropout, 14 conv 4x4 VALID (bottleneck), 15 relu
    crit:     0 flatten, 1 linear, 2 relu, 3 dropout, 4 linear, 5 sigmoid

The 5 embeds are taken after each pool, before dropout, plus the
bottleneck. Layout is NCHW (keep activations `torch.channels_last`,
which the decoder's NHWC upsample kernel reads without a copy).
Under `compute_dtype=torch.bfloat16` the convs and linears run in bf16
with f32 params, and the sigmoid head runs in f32, as in the JAX
critic.

Dropout draws from an explicit `torch.Generator` (`generator=`) so a
`-noevalmode` run is reproducible; it is live only in `train()` mode.

On the card with grad mode off, each conv with its ReLU and pool runs as
the conv without its bias and one `bias_act_pool` launch
(`models/epilogue.py`), bit-equal to the modules' chain.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from cgs_tpu_torch.models import epilogue


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout drawing from `generator`; keeps x's memory
    format (a channels_last activation stays channels_last)."""
    if not training or p == 0.0:
        return x
    u = torch.empty_like(x, dtype=torch.float32).uniform_(
        generator=generator)
    return torch.where(u >= p, x / (1.0 - p), torch.zeros_like(x))


def compute_autocast(device_type: str, compute_dtype: torch.dtype):
    """bf16 compute with f32 params: autocast the convs and linears."""
    return torch.autocast(device_type=device_type, dtype=torch.bfloat16,
                          enabled=compute_dtype == torch.bfloat16)


CONVS = 5      # the convolutions of `features`


class Critic(nn.Module):
    """Discounted-reward regressor on (B, 3, 64, 64) frames in [0, 1]."""

    def __init__(self, dims: Sequence[int] = (8, 8, 8, 16),
                 bottleneck: int = 32, colorchs: int = 3, chfak: int = 1,
                 dropout: float = 0.3,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        d = [k * chfak for k in dims]
        neck = bottleneck * chfak
        self.compute_dtype = compute_dtype

        def block(cin, cout):
            return [nn.Conv2d(cin, cout, 3, padding=1), nn.ReLU(),
                    nn.MaxPool2d(2)]

        self.features = nn.Sequential(
            *block(colorchs, d[0]), *block(d[0], d[1]), *block(d[1], d[2]),
            nn.Dropout(dropout),
            *block(d[2], d[3]),
            nn.Dropout(dropout),
            nn.Conv2d(d[3], neck, 4), nn.ReLU())
        self.crit = nn.Sequential(
            nn.Flatten(), nn.Linear(neck, neck), nn.ReLU(),
            nn.Dropout(dropout), nn.Linear(neck, 1), nn.Sigmoid())

    def forward(self, x: torch.Tensor, collect: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Union[torch.Tensor,
                           Tuple[torch.Tensor, List[torch.Tensor]]]:
        """x: (B, 3, 64, 64). Returns the sigmoid pred (B, 1) and, with
        collect=True, the 5-entry feature pyramid for the decoder."""
        x = x.to(self.compute_dtype)
        embeds: List[torch.Tensor] = []
        fused = epilogue.fused(x, CONVS)
        with compute_autocast(x.device.type, self.compute_dtype):
            if fused:
                x = self._features_fused(x, embeds, generator)
            else:
                for layer in self.features:
                    if isinstance(layer, nn.Dropout):
                        x = dropout(x, layer.p, self.training, generator)
                        continue
                    x = layer(x)
                    if isinstance(layer, nn.MaxPool2d):
                        embeds.append(x)  # post-pool, pre-dropout
            embeds.append(x)              # bottleneck tap
            h = x
            for layer in self.crit[:-1]:  # the sigmoid runs in f32 below
                if isinstance(layer, nn.Dropout):
                    h = dropout(h, layer.p, self.training, generator)
                else:
                    h = layer(h)
        pred = torch.sigmoid(h.float())
        if collect:
            return pred, embeds
        return pred

    def _features_fused(self, x: torch.Tensor, embeds: List[torch.Tensor],
                        generator: Optional[torch.Generator]
                        ) -> torch.Tensor:
        """`features` with each conv, its ReLU and its pool (none after
        the bottleneck conv) as one `conv_epilogue`; dropout as above."""
        f = self.features
        for i, layer in enumerate(f):
            if isinstance(layer, nn.Dropout):
                x = dropout(x, layer.p, self.training, generator)
            elif isinstance(layer, nn.Conv2d):
                pool = i + 2 < len(f) and isinstance(f[i + 2], nn.MaxPool2d)
                x = epilogue.conv_epilogue(layer, x, "relu", 2 if pool else 1)
                if pool:
                    embeds.append(x)      # post-pool, pre-dropout
        return x
