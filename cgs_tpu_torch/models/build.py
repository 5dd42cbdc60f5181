"""The critic and masker pair a run serves and trains, chosen by
`--critic`, and the two forwards that name and count their work.

    paper     `models/critic.py:Critic` (nets.py:160-212) at --chfak and
              --neck, with `models/decoder.py:UnetDecoder` on its
              pyramid (nets.py:452-523)
    resnet18  `models/zoo.py:ResNetCritic` (nets.py:704-730, torchvision
              resnet18, 20 BatchNorm layers) with the same `UnetDecoder`
              on its five-level pyramid, the decoder's widths following
              the encoder's as the paper's do at every chfak (ddims =
              edims): taps 64 @ 32x32, 64 @ 16x16, 128 @ 8x8, 256 @ 4x4
              and the 512 @ 2x2 neck; mask head 67 -> 16 -> 1 @ 64x64
    convnext_t `models/convnext.py:ConvNeXtCritic` (ConvNeXt-T,
              arXiv:2201.03545, torchvision convnext_tiny, 23 LayerNorm
              and 18 depthwise layers) with the same `UnetDecoder` on
              its four stages: no 32x32 tap (the stride-4 stem leaves
              none), so that level upsamples alone (edims 0, 96, 192,
              384; ddims 96, 96, 192, 384); the 768 @ 2x2 neck; mask
              head 99 -> 16 -> 1 @ 64x64
    swin_v2_t `models/swin.py:SwinV2Critic` (Swin Transformer V2-T,
              arXiv:2111.09883, swinv2_tiny_patch4_window8_256 under
              torchvision swin_v2_t's keys, 29 LayerNorms and 12 window
              attentions) with the decoder on its four stages, whose
              pyramid is ConvNeXt-T's: the same decoder widths

`-train`, `-eval`, `-process`, the server and the benchmark build the
pair here, so all of them run the same architecture.

`critic_forward` and `masker_forward` are the forwards of
`MaskPipeline` and of the masker step's passes: under a profiler each is
a span (`cgs.model.critic`, `cgs.model.masker`), and each adds to the
counters (`utils/profiling.py:counts`) the frames it ran
(`model.critic_frames`, `model.masker_frames`; a fused pass counts every
frame) and, for a critic with BatchNorm, its layers applied on running
statistics (`model.bn_running`) and on batch statistics
(`model.bn_batch`), and, for a critic that lists them, its LayerNorm
and depthwise layers (`model.layer_norms`, `model.dw_convs`) and its
window attentions (`model.window_attns`). They add no device operation.
"""

from __future__ import annotations

from typing import List

import torch

from cgs_tpu_torch.core.config import CRITICS
from cgs_tpu_torch.models.convnext import ConvNeXtCritic
from cgs_tpu_torch.models.critic import Critic
from cgs_tpu_torch.models.decoder import UnetDecoder
from cgs_tpu_torch.models.swin import SwinV2Critic
from cgs_tpu_torch.models.zoo import ResNetCritic
from cgs_tpu_torch.utils.profiling import counts, span

RESNET18_TAPS = (64, 64, 128, 256)     # the decoder's edims = ddims
RESNET18_NECK = 512
CONVNEXT_T_TAPS = (0, 96, 192, 384)   # the decoder's edims; no 32x32 tap
CONVNEXT_T_DDIMS = (96, 96, 192, 384)
CONVNEXT_T_NECK = 768


def build_pair(cfg, compute_dtype: torch.dtype = torch.float32):
    """(critic, masker) templates of `cfg.critic_arch` at
    `compute_dtype`. resnet18, convnext_t and swin_v2_t have fixed
    widths: --chfak other than 1, or --neck other than its default, is
    an error."""
    arch = cfg.critic_arch
    if arch == "paper":
        return (Critic(bottleneck=cfg.neck, chfak=cfg.chfak,
                       dropout=cfg.dropout, compute_dtype=compute_dtype),
                UnetDecoder(bottleneck=cfg.neck, chfak=cfg.chfak,
                            compute_dtype=compute_dtype))
    if arch not in CRITICS:
        raise ValueError(f"--critic {arch!r} not in {CRITICS}")
    if cfg.chfak != 1 or cfg.neck != 32:
        raise ValueError(
            f"--critic {arch} has its published widths: "
            f"--chfak {cfg.chfak} and --neck {cfg.neck} size the paper "
            "critic only (leave them at 1 and 32)")
    if arch == "resnet18":
        return (ResNetCritic(compute_dtype=compute_dtype),
                UnetDecoder(edims=RESNET18_TAPS, ddims=RESNET18_TAPS,
                            bottleneck=RESNET18_NECK, chfak=1,
                            compute_dtype=compute_dtype))
    critic = (ConvNeXtCritic if arch == "convnext_t" else SwinV2Critic)(
        compute_dtype=compute_dtype)
    return (critic,
            UnetDecoder(edims=CONVNEXT_T_TAPS, ddims=CONVNEXT_T_DDIMS,
                        bottleneck=CONVNEXT_T_NECK, chfak=1,
                        compute_dtype=compute_dtype))


def batch_norms(model: torch.nn.Module) -> list:
    """The model's BatchNorm layers (none for the paper critic)."""
    return getattr(model, "batch_norms", ())


def drop_paths(model: torch.nn.Module) -> list:
    """The model's drop-path layers (ConvNeXt's and Swin's; none
    elsewhere)."""
    return getattr(model, "drop_paths", ())


def critic_forward(critic, x: torch.Tensor, collect: bool = False,
                   generator=None):
    """`critic(x, collect, generator)`, named and counted."""
    with span("cgs.model.critic"):
        counts["model.critic_frames"] += x.shape[0]
        bns = batch_norms(critic)
        if bns:
            live = sum(m.training for m in bns)
            counts["model.bn_batch"] += live
            counts["model.bn_running"] += len(bns) - live
        for key in ("layer_norms", "dw_convs", "window_attns"):
            n = len(getattr(critic, key, ()))
            if n:
                counts[f"model.{key}"] += n
        return critic(x, collect=collect, generator=generator)


def masker_forward(masker, x: torch.Tensor,
                   embeds: List[torch.Tensor]) -> torch.Tensor:
    """`masker(x, embeds)`, named and counted."""
    with span("cgs.model.masker"):
        counts["model.masker_frames"] += x.shape[0]
        return masker(x, embeds)
