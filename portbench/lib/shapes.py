"""The layers of the critic and the decoder at a configuration's widths,
as the reference describes them (nets.py:160-212 `NewCritic`,
nets.py:452-523 `UnetDecoder`), under the port's state-dict keys.

A configuration file gives `chfak`, `dims` (the critic's and the
decoder's base widths), `neck` (the bottleneck's base width),
`masker_channels` (not scaled by chfak, nets.py:466) and `colorchs`.
Frames are 64 x 64.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

FRAME = 64


@dataclass(frozen=True)
class Layer:
    key: str        # state-dict prefix: `<key>.weight`, `<key>.bias`
    cin: int
    cout: int
    k: int          # kernel size (1 for a linear layer)
    out_hw: int     # output height = width (1 for a linear layer)
    linear: bool = False

    @property
    def weight_shape(self):
        if self.linear:
            return (self.cout, self.cin)
        return (self.cout, self.cin, self.k, self.k)

    @property
    def macs_per_frame(self) -> int:
        return self.out_hw * self.out_hw * self.cout * self.cin * self.k * self.k


def widths(cfg: dict):
    c = int(cfg["chfak"])
    d = [int(k) * c for k in cfg["dims"]]
    return d, int(cfg["neck"]) * c, int(cfg["masker_channels"]), \
        int(cfg.get("colorchs", 3))


def critic_layers(cfg: dict) -> List[Layer]:
    d, neck, _, col = widths(cfg)
    return [Layer("features.0", col, d[0], 3, FRAME),
            Layer("features.3", d[0], d[1], 3, FRAME // 2),
            Layer("features.6", d[1], d[2], 3, FRAME // 4),
            Layer("features.10", d[2], d[3], 3, FRAME // 8),
            Layer("features.14", d[3], neck, 4, 1),
            Layer("crit.1", neck, neck, 1, 1, linear=True),
            Layer("crit.4", neck, 1, 1, 1, linear=True)]


def decoder_layers(cfg: dict) -> List[Layer]:
    """In forward order: dec_model.4 (1x1 on the bottleneck), 3, 2, 1,
    0, then the mask head masker.0 and masker.2."""
    d, neck, mc, col = widths(cfg)
    return [Layer("dec_model.4", neck, neck, 1, 1),
            Layer("dec_model.3", d[3] + neck, d[3], 3, FRAME // 16),
            Layer("dec_model.2", d[2] + d[3], d[2], 3, FRAME // 8),
            Layer("dec_model.1", d[1] + d[2], d[1], 3, FRAME // 4),
            Layer("dec_model.0", d[0] + d[1], d[0], 3, FRAME // 2),
            Layer("masker.0", col + d[0], mc, 3, FRAME),
            Layer("masker.2", mc, 1, 3, FRAME)]


def joins(cfg: dict):
    """The decoder's five skip joins `cat([skip, up_f(x)])`, each as
    (skip channels, skip height, x channels, x height, factor)."""
    d, neck, _, col = widths(cfg)
    return [(d[3], 4, neck, 1, 4), (d[2], 8, d[3], 4, 2),
            (d[1], 16, d[2], 8, 2), (d[0], 32, d[1], 16, 2),
            (col, 64, d[0], 32, 2)]


def state_shapes(cfg: dict):
    """{'critic': [(key, shape)], 'masker': [(key, shape)]} in a fixed
    order, weight before bias."""
    out = {}
    for model, layers in (("critic", critic_layers(cfg)),
                          ("masker", decoder_layers(cfg))):
        out[model] = [(f"{L.key}.{p}", L.weight_shape if p == "weight"
                       else (L.cout,)) for L in layers
                      for p in ("weight", "bias")]
    return out
