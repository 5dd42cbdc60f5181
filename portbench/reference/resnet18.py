"""The `resnet18` pair in plain PyTorch, float32, NCHW, from state dicts:
the ResNet-18 critic (He et al., arXiv:1512.03385, as torchvision's
`resnet18` and the reference's `ResNetCritic`, nets.py:704-730) with its
five taps, the paper's U-Net decoder on them (nets.py:452-523, the
decoder's widths following the encoder's), and the masker step's loss
terms by the reference's separate critic passes (main.py:340-463). No
kernel or module of the port, no cache, no fused pass: `forward_masks`
runs blocks of frames one after the other. The port's keys.

Departures from nets.py, each the program's too:
- the critic returns its five post-ReLU taps (the stem's ReLU at 32x32,
  layer1-4) besides the score, for the decoder; nets.py's ResNetCritic
  feeds no decoder;
- the decoder's neck join upsamples the 2x2 neck by 2 (nets.py's by 4,
  from the paper critic's 1x1 neck), and its widths are the taps'
  (64, 64, 128, 256, neck 512; mask head 16 channels);
- BatchNorm in train mode normalises with the biased batch variance and
  keeps it as the running variance (the JAX package's flax BatchNorm,
  which the port follows); torch's nn.BatchNorm2d keeps the unbiased one;
- with a frozen critic, BatchNorm runs on its running statistics (a
  frozen backbone); nets.py leaves the critic in train mode throughout;
- the ImageNet normalisation (nets.py:802-804) and the `x.max() > 1`
  rescale (nets.py:721) are kept, and the upsample is `F.interpolate`
  nearest, where the reference repeats.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from portbench.reference.masker import B1, B2, EPS, LR, draw_shift
from portbench.reference.model import ingest, set_f32

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
STAGES = ((64, 1), (128, 2), (256, 2), (512, 2))   # width, first stride
MOMENTUM = 0.1
BN_EPS = 1e-5


def _bn(p, key: str, h: torch.Tensor, train: bool, buffers: dict,
        momentum: float) -> torch.Tensor:
    """BatchNorm of layer `key`: running statistics from `buffers`, or,
    in train mode, the batch's, written back into `buffers` at
    `momentum`."""
    if train:
        mean = h.mean((0, 2, 3))
        var = h.var((0, 2, 3), unbiased=False)
        rm, rv = buffers[key + ".running_mean"], buffers[key + ".running_var"]
        buffers[key + ".running_mean"] = (1 - momentum) * rm \
            + momentum * mean.detach()
        buffers[key + ".running_var"] = (1 - momentum) * rv \
            + momentum * var.detach()
        buffers[key + ".num_batches_tracked"] = \
            buffers[key + ".num_batches_tracked"] + 1
    else:
        mean = buffers[key + ".running_mean"]
        var = buffers[key + ".running_var"]
    shape = (1, -1, 1, 1)
    return (h - mean.view(shape)) / torch.sqrt(var.view(shape) + BN_EPS) \
        * p[key + ".weight"].view(shape) + p[key + ".bias"].view(shape)


def critic(p: Dict[str, torch.Tensor], x: torch.Tensor, train: bool = False,
           buffers: Optional[dict] = None, momentum: float = MOMENTUM):
    """(score (N,), [5 taps]) of frames x (N, 3, 64, 64) in [0, 1].
    BatchNorm on the running statistics in `buffers` (default: p), or
    with `train` on the batch's, moving those in `buffers`."""
    buffers = p if buffers is None else buffers

    def conv(key, h, stride, pad):
        return F.conv2d(h, p[key + ".weight"], None, stride, pad)

    def bn(key, h):
        return _bn(p, key, h, train, buffers, momentum)

    x = torch.where(x.max() > 1.0, x / 255.0, x)
    mean = torch.tensor(MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(STD, device=x.device).view(1, 3, 1, 1)
    h = F.relu(bn("resnet.1", conv("resnet.0", (x - mean) / std, 2, 3)))
    taps = [h]
    h = F.max_pool2d(h, 3, 2, 1)
    for s, (_, stride) in enumerate(STAGES):
        for blk in range(2):
            pre = f"resnet.{4 + s}.{blk}"
            st = stride if blk == 0 else 1
            y = F.relu(bn(pre + ".bn1", conv(pre + ".conv1", h, st, 1)))
            y = bn(pre + ".bn2", conv(pre + ".conv2", y, 1, 1))
            if pre + ".downsample.0.weight" in p:
                h = bn(pre + ".downsample.1",
                       conv(pre + ".downsample.0", h, st, 0))
            h = F.relu(h + y)
        taps.append(h)
    h = F.relu(F.linear(h.flatten(1), p["head.1.weight"], p["head.1.bias"]))
    score = F.linear(h, p["head.3.weight"], p["head.3.bias"])
    return score[:, 0], taps


def _join(skip: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    f = skip.shape[2] // x.shape[2]
    return torch.cat([skip, F.interpolate(x, scale_factor=f,
                                          mode="nearest")], 1)


def _conv(p, key, x, pad=1):
    return F.conv2d(x, p[key + ".weight"], p[key + ".bias"], padding=pad)


def decoder(p: Dict[str, torch.Tensor], x: torch.Tensor,
            taps: List[torch.Tensor]) -> torch.Tensor:
    """The mask (N, 1, 64, 64) in (0, 1) from the frames and the taps."""
    out = _conv(p, "dec_model.4", taps[4], pad=0)
    for i in (3, 2, 1, 0):
        out = _conv(p, f"dec_model.{i}", _join(taps[i], out))
    h = _conv(p, "masker.0", _join(x, out))
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


@torch.no_grad()
def running_stats(critic_p: Dict[str, torch.Tensor],
                  frames_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The BatchNorm buffers of one train-mode pass over the frames, in
    one batch, at momentum 1: each running statistic is the batch's
    (the variance biased), so that eval mode normalises as a trained
    backbone's does; `num_batches_tracked` 1. TF32 is off for the pass
    and as it was after it: set-up runs this before the program, whose
    own switches (and a control's) must hold."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    set_f32()
    try:
        buffers = {k: v.clone() for k, v in critic_p.items()
                   if k.rsplit(".", 1)[1] in ("running_mean", "running_var",
                                              "num_batches_tracked")}
        critic(critic_p, ingest(frames_u8), train=True, buffers=buffers,
               momentum=1.0)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    return buffers


def masker_loss(train: dict, params: dict, a: torch.Tensor, y: torch.Tensor,
                b: torch.Tensor, live: bool, buffers: dict):
    """(loss, {'replace', 'inject', 'norm', 'critic'}) of one masker step
    by the reference's separate critic passes (main.py:360-429):
    critic(A) with its taps, critic(B), the mask, critic(replaced),
    critic(injected). A live critic runs BatchNorm on each pass's batch
    statistics, moving `buffers` once a pass; a frozen one on the running
    statistics in `buffers`. Inject on; L2 = 0; the sparsity on |Z|
    (staticnorm)."""
    if not train["inject"] or not train["staticnorm"] or train["L2"]:
        raise ValueError("the reference masker loss takes inject, "
                         "staticnorm and L2 = 0")
    cp, mp = params["critic"], params["masker"]
    pred, taps = critic(cp, a, live, buffers)
    negpred, _ = critic(cp, b, live, buffers)
    negpred = negpred.detach()
    z = decoder(mp, a, taps)
    replacevalue, _ = critic(cp, a * (1.0 - z) + z * b, live, buffers)
    injectvalue, _ = critic(cp, b * (1.0 - z) + z * a, live, buffers)
    terms = {"replace": ((replacevalue - negpred) ** 2).mean(),
             "inject": ((injectvalue - pred.detach()) ** 2).mean(),
             "norm": float(train["L1"]) * z.abs().mean(),
             "critic": ((pred - y) ** 2).mean() if live
             else torch.zeros((), device=a.device)}
    loss = terms["replace"] + terms["inject"] + terms["norm"]
    if live:
        loss = float(train["lfak"]) * terms["critic"] + loss
    return loss, terms


def run_frozen_steps(train: dict, params: dict, banks: dict, stacks,
                     shift_seed: int, dtype=torch.float32) -> dict:
    """Follow the port's frozen masker steps from the seeded weights and
    a fresh Adam (written out, lr 1e-3, betas (0.9, 0.999), eps 1e-8):
    stacks is [(h, l, c)] of int64 index tensors, one a step; the shift
    is one draw a step from a CPU generator seeded with `shift_seed`.
    `dtype` float64 gives what the same steps come to without f32's
    rounding. Returns {'losses': [(replace, inject, norm)], 'grad1':
    {key: the first step's gradient}, 'params0' and 'params': the
    masker's leaves before the first step and after the last}."""
    set_f32()

    def cast(v):
        return v.detach().to(dtype) if v.is_floating_point() else v

    cp = {k: cast(v) for k, v in params["critic"].items()}
    leaves = {k: cast(v).clone().requires_grad_(True)
              for k, v in params["masker"].items()}
    m = {k: torch.zeros_like(v) for k, v in leaves.items()}
    v2 = {k: torch.zeros_like(v) for k, v in leaves.items()}
    gen = torch.Generator().manual_seed(shift_seed)
    out = {"losses": [], "grad1": None,
           "params0": {k: v.detach().clone() for k, v in leaves.items()}}
    keys = list(leaves)
    for t, (h, l, c) in enumerate(stacks, start=1):
        a_u8 = torch.cat([banks["xpos"].index_select(0, h),
                          banks["xneg"].index_select(0, l)])
        if train["shift"]:
            a_u8 = torch.roll(a_u8, draw_shift(int(train["shift"]), gen),
                              dims=2)
        a = ingest(a_u8).to(dtype)
        b = ingest(banks["xneg"].index_select(0, c)).to(dtype)
        y = torch.zeros(a.shape[0], device=a.device, dtype=dtype)
        loss, terms = masker_loss(train, {"critic": cp, "masker": leaves},
                                  a, y, b, False, cp)
        grads = torch.autograd.grad(loss, [leaves[k] for k in keys])
        out["losses"].append(tuple(float(terms[k].detach()) for k in
                                   ("replace", "inject", "norm")))
        if t == 1:
            out["grad1"] = {k: g.detach().clone()
                            for k, g in zip(keys, grads)}
        with torch.no_grad():
            bc1, bc2 = 1.0 - B1 ** t, 1.0 - B2 ** t
            for k, g in zip(keys, grads):
                m[k].mul_(B1).add_(g, alpha=1.0 - B1)
                v2[k].mul_(B2).addcmul_(g, g, value=1.0 - B2)
                denom = (v2[k].sqrt() / math.sqrt(bc2)).add_(EPS)
                leaves[k].addcdiv_(m[k], denom, value=-LR / bc1)
    out["params"] = {k: v.detach().clone() for k, v in leaves.items()}
    return out
