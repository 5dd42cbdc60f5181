"""The `swin_v2_t` configuration's layers, operations, bytes and seeded
weights (`configs/swin_v2_t.json`): the Swin Transformer V2-T critic
(arXiv:2111.09883, `swinv2_tiny_patch4_window8_256`) and the paper's
U-Net decoder on its four stages, under the port's state-dict keys,
which are torchvision `swin_v2_t`'s (`cgs_tpu_torch/models/swin.py`,
`models/decoder.py`). Frozen here, as `lib/shapes.py` and
`lib/flops.py` are for the chfak configurations: a change to the
program does not change them.

The configuration gives `embed_dim`, `depths` and `num_heads` (the four
stages' blocks and heads), `window_size`, `patch_size`, `mlp_ratio`,
`cpb_hidden` (the position-bias network's width), `decoder_edims`,
`decoder_widths`, `neck`, `masker_channels` and `colorchs`. A stage's
window follows the authors' rule for maps no larger than the window:
the map itself, unshifted.
"""

from __future__ import annotations

import math
from typing import List

import torch

from portbench.lib.flops import F32
from portbench.lib.shapes import FRAME, Layer
from portbench.lib.weights import substream


def stages(cfg: dict):
    """(width, depth, heads, height, window, shift of the odd blocks) of
    the four stages."""
    hw = FRAME // int(cfg["patch_size"])
    dim, ws = int(cfg["embed_dim"]), int(cfg["window_size"])
    out = []
    for i, (n, h) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        if i:
            hw, dim = hw // 2, 2 * dim
        w, s = (hw, 0) if hw <= ws else (ws, ws // 2)
        out.append((dim, int(n), int(h), hw, w, s))
    return out


def taps(cfg: dict):
    """The decoder's five levels' skips as (channels, height): none (0)
    at 32x32, then stages 1-4 (the last one the neck)."""
    return [(0, FRAME // 2)] + [(d, hw) for d, _, _, hw, _, _ in
                                stages(cfg)]


def _block(s: int, j: int) -> str:
    return f"features.{2 * s + 1}.{j}"


def critic_layers(cfg: dict) -> List[Layer]:
    """Every convolution and linear layer that runs on the frames, in
    forward order: the patch embedding, each block's qkv, proj and two
    MLP linears and each merge's reduction (linears applied at each of
    their map's tokens), the head. The position-bias networks run on
    the offset table once a forward, not on the frames, and are not
    listed."""
    col, p = int(cfg.get("colorchs", 3)), int(cfg["patch_size"])
    r = int(cfg["mlp_ratio"])
    st = stages(cfg)
    layers = [Layer("features.0.0", col, st[0][0], p, st[0][3])]
    for s, (d, n, _, hw, _, _) in enumerate(st):
        if s:
            layers.append(Layer(f"features.{2 * s}.reduction",
                                4 * st[s - 1][0], d, 1, hw, linear=True))
        for j in range(n):
            pre = _block(s, j)
            layers += [Layer(pre + ".attn.qkv", d, 3 * d, 1, hw,
                             linear=True),
                       Layer(pre + ".attn.proj", d, d, 1, hw, linear=True),
                       Layer(pre + ".mlp.0", d, r * d, 1, hw, linear=True),
                       Layer(pre + ".mlp.3", r * d, d, 1, hw, linear=True)]
    return layers + [Layer("head", st[-1][0], 1, 1, 1, linear=True)]


def layer_norms(cfg: dict) -> List[tuple]:
    """(key, channels, height) of the forward's LayerNorms in order: the
    patch embedding's, each block's two post-norms, each merge's and the
    final one (29 at the published depths)."""
    st = stages(cfg)
    out = [("features.0.2", st[0][0], st[0][3])]
    for s, (d, n, _, hw, _, _) in enumerate(st):
        if s:
            out.append((f"features.{2 * s}.norm", d, hw))
        for j in range(n):
            out += [(_block(s, j) + ".norm1", d, hw),
                    (_block(s, j) + ".norm2", d, hw)]
    return out + [("norm", st[-1][0], st[-1][3])]


def window_attns(cfg: dict) -> List[tuple]:
    """(key, windows a frame, heads, tokens a window N, head size d,
    shift) of the forward's attention layers (12)."""
    out = []
    for s, (d, n, h, hw, w, shift) in enumerate(stages(cfg)):
        for j in range(n):
            out.append((_block(s, j) + ".attn", (hw // w) ** 2, h, w * w,
                        d // h, shift if j % 2 else 0))
    return out


def window_attn_flops(cfg: dict, n: int) -> int:
    """The attention's FLOPs for a batch of n: 4 N^2 d for each window
    and head (q k^T and the product with v, 2 N^2 d each)."""
    return n * sum(4 * nw * h * t * t * d
                   for _, nw, h, t, d, _ in window_attns(cfg))


def window_attn_bytes(cfg: dict, n: int, elem: int = F32) -> int:
    """The attention's bytes for a batch of n: q, k and v read once and
    the output written once, and each layer's (windows x heads, N, N)
    bias read once a batch."""
    return elem * sum(4 * n * nw * h * t * d + nw * h * t * t
                      for _, nw, h, t, d, _ in window_attns(cfg))


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


def process_flops_per_frame(cfg: dict) -> int:
    """2 x the multiply-adds of every convolution and linear layer of
    one frame through the critic (with its taps) and the decoder, and
    the window attention's 4 N^2 d a window and head; the LayerNorms,
    the normalisation of q and k, GELU, the residual adds, the rolls,
    the position-bias networks, the mean over tokens and the joins are
    not counted."""
    return 2 * sum(L.macs_per_frame for L in critic_layers(cfg)
                   + decoder_layers(cfg)) + window_attn_flops(cfg, 1)


def _drawn(cfg: dict):
    """(model, key, shape, low, high, log) of every leaf drawn from the
    seed: conv and linear weights and biases U(-1/sqrt(fan_in),
    1/sqrt(fan_in)) (a bias takes its layer's fan-in; the position-bias
    networks' layers too); every LayerNorm weight U(0.5, 1.5) and bias
    U(-0.1, 0.1); each head's temperature log of U(5, 20) (`log`)."""
    out = []
    cpb = int(cfg["cpb_hidden"])

    def linear(model, key, shape, bias=True):
        b = 1.0 / math.sqrt(math.prod(shape[1:]))
        out.append((model, key + ".weight", shape, -b, b, False))
        if bias:
            out.append((model, key + ".bias", (shape[0],), -b, b, False))

    def norm(key, c):
        out.append(("critic", key + ".weight", (c,), 0.5, 1.5, False))
        out.append(("critic", key + ".bias", (c,), -0.1, 0.1, False))

    for L in critic_layers(cfg):
        linear("critic", L.key, L.weight_shape,
               bias=not L.key.endswith(".reduction"))
    for key, c, _ in layer_norms(cfg):
        norm(key, c)
    for key, _, h, _, _, _ in window_attns(cfg):
        out.append(("critic", key + ".logit_scale", (h, 1, 1), 5.0, 20.0,
                    True))
        linear("critic", key + ".cpb_mlp.0", (cpb, 2))
        linear("critic", key + ".cpb_mlp.2", (h, cpb), bias=False)
    for L in decoder_layers(cfg):
        linear("masker", L.key, L.weight_shape)
    return out


def seeded_params(cfg: dict, seed: int, device) -> dict:
    """{'critic': state_dict, 'masker': state_dict} of float32 tensors on
    `device`, every leaf from one `torch.rand` on `device` mapped onto
    its range (`_drawn`), as `lib/weights.py` draws the chfak
    configurations'; a temperature is the log of its draw."""
    flat = _drawn(cfg)
    sizes = [math.prod(s) for _, _, s, *_ in flat]
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(substream(seed, "weights"))
    u = torch.rand(sum(sizes), generator=gen, device=dev)
    reps = torch.tensor(sizes, device=dev)
    low = torch.repeat_interleave(
        torch.tensor([f[3] for f in flat], device=dev), reps)
    high = torch.repeat_interleave(
        torch.tensor([f[4] for f in flat], device=dev), reps)
    vals = low + (high - low) * u
    out = {"critic": {}, "masker": {}}
    for (model, key, shape, _, _, log), piece in zip(flat, vals.split(sizes)):
        out[model][key] = (piece.log() if log else piece).view(shape)
    return out
