"""The `convnext_t` configuration's layers, operations, bytes and seeded
weights (`configs/convnext_t.json`): the ConvNeXt-T critic (torchvision
`convnext_tiny`, arXiv:2201.03545) and the paper's U-Net decoder on its
four stages, under the port's state-dict keys
(`cgs_tpu_torch/models/convnext.py`, `models/decoder.py`). Frozen here,
as `lib/shapes.py` and `lib/flops.py` are for the chfak configurations:
a change to the program does not change them.

The configuration gives `dims` and `depths` (the four stages' widths
and blocks), `kernel` (the depthwise kernel), `mlp_ratio`, `stem_kernel`
and `downsample_kernel`, `decoder_edims` (the skips the decoder takes,
0 at its 32x32 level, which has none), `decoder_widths`, `neck`,
`masker_channels` and `colorchs`.
"""

from __future__ import annotations

import math
from typing import List

import torch

from portbench.lib.flops import F32
from portbench.lib.shapes import FRAME, Layer
from portbench.lib.weights import substream


def _stages(cfg: dict):
    """(width, depth, height) of the four stages."""
    hw = FRAME // int(cfg["stem_kernel"])
    out = []
    for i, (d, n) in enumerate(zip(cfg["dims"], cfg["depths"])):
        if i:
            hw //= int(cfg["downsample_kernel"])
        out.append((int(d), int(n), hw))
    return out


def taps(cfg: dict):
    """The decoder's five levels' skips as (channels, height): none (0)
    at 32x32, then stages 1-4 (the last one the neck)."""
    return [(0, FRAME // 2)] + [(d, hw) for d, _, hw in _stages(cfg)]


def critic_layers(cfg: dict) -> List[Layer]:
    """Every convolution and linear layer, in forward order; a depthwise
    one has cin 1 (one input channel a group), a block's projections are
    linears applied at each of the stage's pixels."""
    col = int(cfg.get("colorchs", 3))
    k, ks, kd = int(cfg["kernel"]), int(cfg["stem_kernel"]), \
        int(cfg["downsample_kernel"])
    r = int(cfg["mlp_ratio"])
    stages = _stages(cfg)
    layers = [Layer("features.0.0", col, stages[0][0], ks, stages[0][2])]
    for i, (d, n, hw) in enumerate(stages):
        if i:
            layers.append(Layer(f"features.{2 * i}.1", stages[i - 1][0], d,
                                kd, hw))
        for j in range(n):
            pre = f"features.{2 * i + 1}.{j}.block"
            layers += [Layer(pre + ".0", 1, d, k, hw),
                       Layer(pre + ".3", d, r * d, 1, hw, linear=True),
                       Layer(pre + ".5", r * d, d, 1, hw, linear=True)]
    return layers + [Layer("classifier.2", stages[-1][0], 1, 1, 1,
                           linear=True)]


def layer_norms(cfg: dict) -> List[tuple]:
    """(key, channels, height) of the forward's LayerNorms in order: the
    stem's, each block's, each downsample's (on its input) and the
    head's (on the pooled 1x1)."""
    stages = _stages(cfg)
    out = [("features.0.1", stages[0][0], stages[0][2])]
    for i, (d, n, hw) in enumerate(stages):
        if i:
            pd, _, phw = stages[i - 1]
            out.append((f"features.{2 * i}.0", pd, phw))
        out += [(f"features.{2 * i + 1}.{j}.block.2", d, hw)
                for j in range(n)]
    return out + [("classifier.0", stages[-1][0], 1)]


def dw_convs(cfg: dict) -> List[Layer]:
    return [L for L in critic_layers(cfg) if L.cin == 1 and not L.linear]


def decoder_layers(cfg: dict) -> List[Layer]:
    """dec_model.4 (1x1 on the neck), 3, 2, 1, 0, then the mask head."""
    t = taps(cfg)
    e = [int(c) for c in cfg["decoder_edims"]]
    dd = [int(c) for c in cfg["decoder_widths"]]
    col, mc = int(cfg.get("colorchs", 3)), int(cfg["masker_channels"])
    neck = int(cfg["neck"])
    out = [Layer("dec_model.4", neck, neck, 1, t[4][1])]
    up = neck
    for i in (3, 2, 1, 0):
        out.append(Layer(f"dec_model.{i}", e[i] + up, dd[i], 3, t[i][1]))
        up = dd[i]
    return out + [Layer("masker.0", col + up, mc, 3, FRAME),
                  Layer("masker.2", mc, 1, 3, FRAME)]


def joins(cfg: dict):
    """The decoder's five joins `cat([skip, up(x)])`, each as (skip
    channels, skip height, x channels, x height); the 32x32 one has no
    skip channels."""
    t = taps(cfg)
    e = [int(c) for c in cfg["decoder_edims"]]
    dd = [int(c) for c in cfg["decoder_widths"]]
    col = int(cfg.get("colorchs", 3))
    skips = [(e[3], t[3][1]), (e[2], t[2][1]), (e[1], t[1][1]),
             (e[0], t[0][1]), (col, FRAME)]
    ups = [(int(cfg["neck"]), t[4][1]), (dd[3], t[3][1]), (dd[2], t[2][1]),
           (dd[1], t[1][1]), (dd[0], t[0][1])]
    return [(cs, hs, cx, hx) for (cs, hs), (cx, hx) in zip(skips, ups)]


def process_flops_per_frame(cfg: dict) -> int:
    """2 x the multiply-adds of every convolution and linear layer of
    one frame through the critic (with its taps) and the decoder; the
    LayerNorms, GELU, the layer scale, the residual adds, the pool and
    the joins are not counted."""
    return 2 * sum(L.macs_per_frame for L in critic_layers(cfg)
                   + decoder_layers(cfg))


def joins_bytes(cfg: dict, n: int, elem: int = F32) -> int:
    """The five joins of a batch of n: skip and x read once, the joined
    buffer written once."""
    return n * elem * sum(cs * hs * hs + cx * hx * hx + (cs + cx) * hs * hs
                          for cs, hs, cx, hx in joins(cfg))


def layer_norms_bytes(cfg: dict, n: int, elem: int = F32) -> int:
    """The forward's LayerNorms of a batch of n: each reads its input
    once and writes its output once (their weights not counted)."""
    return n * elem * sum(2 * c * hw * hw for _, c, hw in layer_norms(cfg))


def dw_convs_bytes(cfg: dict, n: int, elem: int = F32) -> int:
    """The depthwise layers of a batch of n: each reads its input once
    and writes its output once (their weights not counted)."""
    return n * elem * sum(2 * L.cout * L.out_hw * L.out_hw
                          for L in dw_convs(cfg))


def _drawn(cfg: dict):
    """(model, key, shape, low, high) of every leaf drawn from the seed:
    conv and linear weights and biases U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    (a bias takes its layer's fan-in); each block's layer scale and every
    LayerNorm weight U(0.5, 1.5); the LayerNorm biases U(-0.1, 0.1)."""
    out = []

    def linear(model, L):
        b = 1.0 / math.sqrt(math.prod(L.weight_shape[1:]))
        out.append((model, L.key + ".weight", L.weight_shape, -b, b))
        out.append((model, L.key + ".bias", (L.cout,), -b, b))

    def norm(key, c):
        out.append(("critic", key + ".weight", (c,), 0.5, 1.5))
        out.append(("critic", key + ".bias", (c,), -0.1, 0.1))

    for L in critic_layers(cfg):
        linear("critic", L)
    for key, c, _ in layer_norms(cfg):
        norm(key, c)
    for L in dw_convs(cfg):
        out.append(("critic", L.key[:-len(".block.0")] + ".layer_scale",
                    (L.cout, 1, 1), 0.5, 1.5))
    for L in decoder_layers(cfg):
        linear("masker", L)
    return out


def seeded_params(cfg: dict, seed: int, device) -> dict:
    """{'critic': state_dict, 'masker': state_dict} of float32 tensors on
    `device`, every leaf from one `torch.rand` on `device` mapped onto
    its range (`_drawn`), as `lib/weights.py` draws the chfak
    configurations'."""
    flat = _drawn(cfg)
    sizes = [math.prod(s) for _, _, s, _, _ in flat]
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(substream(seed, "weights"))
    u = torch.rand(sum(sizes), generator=gen, device=dev)
    reps = torch.tensor(sizes, device=dev)
    low = torch.repeat_interleave(
        torch.tensor([lo for *_, lo, _ in flat], device=dev), reps)
    high = torch.repeat_interleave(
        torch.tensor([hi for *_, hi in flat], device=dev), reps)
    vals = low + (high - low) * u
    out = {"critic": {}, "masker": {}}
    for (model, key, shape, _, _), piece in zip(flat, vals.split(sizes)):
        out[model][key] = piece.view(shape)
    return out
