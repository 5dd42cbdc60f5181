"""The `swin_v2_t` pair in plain PyTorch, float32, from state dicts: the
Swin Transformer V2-T critic (Liu et al., arXiv:2111.09883, the authors'
`swinv2_tiny_patch4_window8_256`) with its taps, the paper's U-Net
decoder on them (nets.py:452-523), and the masker step's loss terms by
separate critic passes (main.py:340-463). No kernel or module of the
port, no cache, no fused pass: the token maps are (N, H, W, C), the
LayerNorms, GELU and linears are written out, the roll and the window
partition are plain indexing, and the attention materialises its
scores, adds the position bias and the shift mask, and takes an explicit
softmax. `forward_masks` runs blocks of frames one after the other. The
port's keys, which are torchvision `swin_v2_t`'s.

    block  x = x + LN(attn(x)); x = x + LN(mlp(x))   (res-post-norm)
    attn   softmax(cos(q, k) exp(min(tau, log 100)) + 16 sigmoid(B) + M) v

Departures from the authors' code, each the program's too:
- the head has one output, a raw score (`head` is Linear(768, 1), no
  sigmoid), where the published one has 1000 classes;
- the critic returns taps besides the score, for the decoder: None at
  the decoder's 32x32 level, then the last block output of stages 1-4
  (the fourth the neck, before the final LayerNorm), each before the
  merge that follows it;
- the decoder's 32x32 level has no skip (the stride-4 patch embedding
  leaves no 32x32 tap), as in `reference/convnext_t.py`, whose decoder
  this is;
- the window of a stage whose map is no larger than the configured 8 is
  the map itself, unshifted (the authors' rule in
  `SwinTransformerBlock.__init__`): stage 1 (16x16) has four 8x8
  windows and its second block shifts by 4; stages 2-4 (8x8, 4x4, 2x2)
  attend over the whole map; the position-bias offsets are normalised
  by each stage's window - 1;
- the LayerNorm weights and the temperatures are whatever the weights
  hold (the benchmark draws them from the seed,
  `lib/shapes_swin_v2_t.py`), not the authors' zeroed post-norms;
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

from portbench.reference.convnext_t import decoder
from portbench.reference.model import ingest, set_f32
from portbench.reference.resnet18 import MEAN, STD

EPS = 1e-5
WINDOW = 8
LOGIT_MAX = math.log(1.0 / 0.01)


def _ln(p, key: str, h: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last axis of h, biased variance."""
    mean = h.mean(-1, keepdim=True)
    var = ((h - mean) ** 2).mean(-1, keepdim=True)
    return (h - mean) / torch.sqrt(var + EPS) * p[key + ".weight"] \
        + p[key + ".bias"]


def _linear(p, key: str, h: torch.Tensor, bias=True) -> torch.Tensor:
    out = h @ p[key + ".weight"].t()
    return out + p[key + ".bias"] if bias else out


def _gelu(h: torch.Tensor) -> torch.Tensor:
    return 0.5 * h * (1.0 + torch.erf(h / math.sqrt(2.0)))


def depths(p: Dict[str, torch.Tensor]) -> List[int]:
    """The blocks of each stage, read from the keys."""
    return [sum(1 for k in p if k.startswith(f"features.{s}.")
                and k.endswith(".norm1.weight")) for s in (1, 3, 5, 7)]


def position_bias(p, key: str, w: int) -> torch.Tensor:
    """16 sigmoid(B): (heads, w^2, w^2) from the layer's CPB network on
    the log-spaced offsets of a w x w window."""
    pairs = [(a, b) for a in range(-(w - 1), w) for b in range(-(w - 1), w)]
    w0 = p[key + ".cpb_mlp.0.weight"]
    t = torch.tensor(pairs, dtype=w0.dtype, device=w0.device)
    t = t / (w - 1) * 8.0
    t = torch.sign(t) * torch.log2(torch.abs(t) + 1.0) / 3.0
    table = _linear(p, key + ".cpb_mlp.2",
                    torch.relu(_linear(p, key + ".cpb_mlp.0", t)),
                    bias=False)                    # ((2w-1)^2, heads)
    cells = [(i, j) for i in range(w) for j in range(w)]
    idx = torch.tensor([[(a[0] - b[0] + w - 1) * (2 * w - 1)
                         + (a[1] - b[1] + w - 1) for b in cells]
                        for a in cells], device=t.device)
    return 16.0 * torch.sigmoid(table[idx].permute(2, 0, 1))


def region_mask(hw: int, w: int, s: int, device) -> torch.Tensor:
    """(windows, w^2, w^2): -100 where two tokens of a window of the
    rolled map come from different regions (rows and columns cut at
    hw - w and hw - s), 0 elsewhere."""
    def band(r):
        return 0 if r < hw - w else (1 if r < hw - s else 2)
    masks = []
    for wi in range(hw // w):
        for wj in range(hw // w):
            ids = torch.tensor([band(wi * w + i) * 3 + band(wj * w + j)
                                for i in range(w) for j in range(w)],
                               device=device)
            masks.append(torch.where(ids[:, None] == ids[None, :], 0.0,
                                     -100.0))
    return torch.stack(masks)


def attention(p, key: str, x: torch.Tensor, heads: int, w: int, s: int
              ) -> torch.Tensor:
    """Scaled cosine attention over the w x w windows of x (N, H, W, C),
    rolled by (-s, -s) first and back after."""
    n, hw, _, c = x.shape
    d, nw = c // heads, hw // w
    dev = x.device
    if s:
        rows = (torch.arange(hw, device=dev) + s) % hw
        x = x[:, rows][:, :, rows]
    win = torch.stack([x[:, a * w:(a + 1) * w, b * w:(b + 1) * w]
                       .reshape(n, w * w, c)
                       for a in range(nw) for b in range(nw)], 1)
    b = p[key + ".qkv.bias"]
    q = win @ p[key + ".qkv.weight"][:c].t() + b[:c]
    k = win @ p[key + ".qkv.weight"][c:2 * c].t()          # no k bias
    v = win @ p[key + ".qkv.weight"][2 * c:].t() + b[2 * c:]
    q, k, v = (t.reshape(n, nw * nw, w * w, heads, d).transpose(2, 3)
               for t in (q, k, v))                  # (N, nW, h, T, d)
    q = q / torch.clamp(torch.sqrt((q * q).sum(-1, keepdim=True)),
                        min=1e-12)
    k = k / torch.clamp(torch.sqrt((k * k).sum(-1, keepdim=True)),
                        min=1e-12)
    scale = torch.exp(torch.clamp(p[key + ".logit_scale"], max=LOGIT_MAX))
    scores = (q @ k.transpose(-2, -1)) * scale + position_bias(p, key, w)
    if s:
        scores = scores + region_mask(hw, w, s, dev)[:, None]
    scores = scores - scores.max(-1, keepdim=True).values
    e = torch.exp(scores)
    out = (e / e.sum(-1, keepdim=True)) @ v         # (N, nW, h, T, d)
    out = _linear(p, key + ".proj",
                  out.transpose(2, 3).reshape(n, nw * nw, w * w, c))
    y = torch.empty_like(x)
    for i, (a, bb) in enumerate((a, bb) for a in range(nw)
                                for bb in range(nw)):
        y[:, a * w:(a + 1) * w, bb * w:(bb + 1) * w] = out[:, i].reshape(
            n, w, w, c)
    if s:
        back = (torch.arange(hw, device=dev) - s) % hw
        y = y[:, back][:, :, back]
    return y


def critic(p: Dict[str, torch.Tensor], x: torch.Tensor):
    """(score (N,), [None, 4 stage taps as (N, C, H, W)]) of frames x
    (N, 3, 64, 64) in [0, 1]."""
    x = torch.where(x.max() > 1.0, x / 255.0, x)
    mean = torch.tensor(MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(STD, device=x.device).view(1, 3, 1, 1)
    h = F.conv2d((x - mean) / std, p["features.0.0.weight"],
                 p["features.0.0.bias"], stride=4).permute(0, 2, 3, 1)
    h = _ln(p, "features.0.2", h)
    heads = [p[f"features.{2 * s + 1}.0.attn.logit_scale"].shape[0]
             for s in range(4)]
    taps: List[Optional[torch.Tensor]] = [None]
    for s, n in enumerate(depths(p)):
        if s:
            m = f"features.{2 * s}"
            h = torch.cat([h[:, 0::2, 0::2], h[:, 1::2, 0::2],
                           h[:, 0::2, 1::2], h[:, 1::2, 1::2]], -1)
            h = _ln(p, m + ".norm", _linear(p, m + ".reduction", h,
                                             bias=False))
        hw = h.shape[1]
        w = hw if hw <= WINDOW else WINDOW
        for j in range(n):
            b = f"features.{2 * s + 1}.{j}"
            shift = w // 2 if (j % 2 and hw > WINDOW) else 0
            h = h + _ln(p, b + ".norm1",
                        attention(p, b + ".attn", h, heads[s], w, shift))
            y = _linear(p, b + ".mlp.3", _gelu(_linear(p, b + ".mlp.0", h)))
            h = h + _ln(p, b + ".norm2", y)
        taps.append(h.permute(0, 3, 1, 2))
    pooled = _ln(p, "norm", h).mean((1, 2))
    score = pooled @ p["head.weight"].t() + p["head.bias"]
    return score[:, 0], taps


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
