"""The `resnet18` configuration's layers, operations, join bytes and
seeded weights (`configs/resnet18.json`): the ResNet-18 critic
(torchvision `resnet18`, nets.py:704-730) and the paper's U-Net decoder
on its five taps, under the port's state-dict keys
(`cgs_tpu_torch/models/zoo.py:ResNetCritic`, `models/decoder.py`).
Frozen here, as `lib/shapes.py` and `lib/flops.py` are for the chfak
configurations: a change to the program does not change them.

The configuration gives `stem` (the 7x7 stride-2 stem's width),
`stages` (layer1-4's widths, two BasicBlocks each, stride 2 from
layer2 on), `head` (the 2048 -> head -> 1 score head's width),
`masker_channels` and `colorchs`; the decoder's widths are the taps'.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from portbench.lib.flops import F32
from portbench.lib.shapes import FRAME, Layer
from portbench.lib.weights import substream

BN_FRAMES_TAG = 8        # the stream of the BatchNorm statistics' frames


def taps(cfg: dict):
    """The five taps' (channels, height): the stem's ReLU, layer1-4."""
    s = [int(c) for c in cfg["stages"]]
    return [(int(cfg["stem"]), FRAME // 2), (s[0], FRAME // 4),
            (s[1], FRAME // 8), (s[2], FRAME // 16), (s[3], FRAME // 32)]


def critic_layers(cfg: dict) -> List[Layer]:
    """Every convolution (no bias) and linear layer, in forward order."""
    col, stem = int(cfg.get("colorchs", 3)), int(cfg["stem"])
    layers = [Layer("resnet.0", col, stem, 7, FRAME // 2)]
    cin = stem
    for s, (cout, hw) in enumerate(taps(cfg)[1:]):
        for blk in range(2):
            pre = f"resnet.{4 + s}.{blk}"
            layers.append(Layer(pre + ".conv1", cin, cout, 3, hw))
            layers.append(Layer(pre + ".conv2", cout, cout, 3, hw))
            if cin != cout:
                layers.append(Layer(pre + ".downsample.0", cin, cout, 1, hw))
            cin = cout
    head = int(cfg["head"])
    neck_c, neck_hw = taps(cfg)[4]
    return layers + [
        Layer("head.1", neck_c * neck_hw * neck_hw, head, 1, 1, linear=True),
        Layer("head.3", head, 1, 1, 1, linear=True)]


def batch_norms(cfg: dict) -> List[tuple]:
    """(key, channels) of the 20 BatchNorm layers, in forward order."""
    bn_of = {"resnet.0": "resnet.1", "conv1": "bn1", "conv2": "bn2",
             "downsample.0": "downsample.1"}
    out = []
    for L in critic_layers(cfg):
        if L.linear:
            continue
        for conv, bn in bn_of.items():
            if L.key.endswith(conv):
                out.append((L.key[:-len(conv)] + bn, L.cout))
    return out


def decoder_layers(cfg: dict) -> List[Layer]:
    """dec_model.4 (1x1 on the neck), 3, 2, 1, 0, then the mask head."""
    t = taps(cfg)
    col, mc = int(cfg.get("colorchs", 3)), int(cfg["masker_channels"])
    neck = t[4][0]
    out = [Layer("dec_model.4", neck, neck, 1, t[4][1])]
    up = neck
    for i in (3, 2, 1, 0):
        out.append(Layer(f"dec_model.{i}", t[i][0] + up, t[i][0], 3,
                         t[i][1]))
        up = t[i][0]
    return out + [Layer("masker.0", col + up, mc, 3, FRAME),
                  Layer("masker.2", mc, 1, 3, FRAME)]


def joins(cfg: dict):
    """The decoder's five skip joins, each as (skip channels, skip
    height, x channels, x height)."""
    t = taps(cfg)
    col = int(cfg.get("colorchs", 3))
    skips = [t[3], t[2], t[1], t[0], (col, FRAME)]
    ups = [t[4]] + [t[i] for i in (3, 2, 1, 0)]
    return [(cs, hs, cx, hx) for (cs, hs), (cx, hx) in zip(skips, ups)]


def process_flops_per_frame(cfg: dict) -> int:
    """2 x the multiply-adds of every convolution and linear layer of
    one frame through the critic (with its taps) and the decoder;
    BatchNorm, ReLU, pooling, the residual adds and the joins are not
    counted."""
    return 2 * sum(L.macs_per_frame for L in critic_layers(cfg)
                   + decoder_layers(cfg))


def joins_bytes(cfg: dict, n: int, elem: int = F32) -> int:
    """The five joins of a batch of n: skip and x read once, the joined
    buffer written once."""
    return n * elem * sum(cs * hs * hs + cx * hx * hx + (cs + cx) * hs * hs
                          for cs, hs, cx, hx in joins(cfg))


def _drawn(cfg: dict):
    """(model, key, shape) of every leaf drawn from the seed: conv and
    linear weights, the linears' and the decoder's biases."""
    out = []
    for model, layers in (("critic", critic_layers(cfg)),
                          ("masker", decoder_layers(cfg))):
        for L in layers:
            out.append((model, L.key + ".weight", L.weight_shape))
            if model == "masker" or L.linear:
                out.append((model, L.key + ".bias", (L.cout,)))
    return out


def seeded_params(cfg: dict, seed: int, device) -> dict:
    """{'critic': state_dict, 'masker': state_dict} of float32 tensors on
    `device` (`num_batches_tracked` int64): conv and linear weights and
    biases U(-1/sqrt(fan_in), 1/sqrt(fan_in)) from one `torch.rand` on
    `device`, as `lib/weights.py` draws the chfak configurations';
    BatchNorm gamma 1 and beta 0; the running statistics those of one
    train-mode pass of the plain reference over `bn_stat_frames` seeded
    frames (`reference/resnet18.py:running_stats`)."""
    from portbench.reference import resnet18 as ref

    flat = _drawn(cfg)
    sizes = [math.prod(s) for _, _, s in flat]
    bounds = []
    for (_, key, shape) in flat:
        if key.endswith(".weight"):     # a bias takes its layer's fan-in
            fan_in = math.prod(shape[1:])
        bounds.append(1.0 / math.sqrt(fan_in))
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(substream(seed, "weights"))
    u = torch.rand(sum(sizes), generator=gen, device=dev)
    scale = torch.repeat_interleave(torch.tensor(bounds, device=dev),
                                    torch.tensor(sizes, device=dev))
    vals = (u * 2.0 - 1.0) * scale
    out = {"critic": {}, "masker": {}}
    for (model, key, shape), piece in zip(flat, vals.split(sizes)):
        out[model][key] = piece.view(shape)
    crit = out["critic"]
    for key, c in batch_norms(cfg):
        crit[key + ".weight"] = torch.ones(c, device=dev)
        crit[key + ".bias"] = torch.zeros(c, device=dev)
        crit[key + ".running_mean"] = torch.zeros(c, device=dev)
        crit[key + ".running_var"] = torch.ones(c, device=dev)
        crit[key + ".num_batches_tracked"] = torch.zeros(
            (), dtype=torch.long, device=dev)
    frames = bn_frames(int(cfg["bn_stat_frames"]), seed, dev)
    crit.update(ref.running_stats(crit, frames))
    return out


def bn_frames(n: int, seed: int, device) -> torch.Tensor:
    """(n, 64, 64, 3) uint8 frames of the BatchNorm statistics' own
    stream of the seed."""
    state = np.random.SeedSequence([int(seed), BN_FRAMES_TAG]) \
        .generate_state(2, dtype=np.uint32)
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(
        (int(state[0]) << 31) ^ int(state[1]))
    return torch.randint(0, 256, (n, FRAME, FRAME, 3), dtype=torch.uint8,
                         device=dev, generator=gen)
