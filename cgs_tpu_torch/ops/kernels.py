"""The uint8 ingest and the fused threshold+IoU count: CUDA kernel
wrappers and their plain PyTorch versions.

Ports of `cgs_tpu/ops/pallas_kernels.py:normalize_u8` and
`:threshold_iou`. On a CUDA tensor each wrapper launches its kernel
(`csrc/normalize_u8.cu`, `csrc/threshold_iou.cu`) or raises; on a CPU
tensor it runs the plain version, which is also the oracle the kernel
is held against on the card. There is no fallback from the kernel to
the plain version.

`merge_pair` and `merge_pair_bwd` belong to the masker train step and
are not ported yet (ROADMAP.md, queue 2).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from cgs_tpu_torch.ops import _build

# float32(1/255) == 0x3B808081: the JAX kernel and plain path multiply
# by it (pallas_kernels.py:67, pipeline.py:338); x / 255 rounds
# differently for many byte values
INV255 = float(np.float32(1.0 / 255.0))


# ---------------------------------------------------------------------
# uint8 -> f32 ingest
# ---------------------------------------------------------------------

def normalize_u8_plain(x_u8: torch.Tensor) -> torch.Tensor:
    return x_u8.to(torch.float32) * INV255


def normalize_u8(x_u8: torch.Tensor) -> torch.Tensor:
    """uint8 tensor of any shape -> float32 `x * float32(1/255)`, same
    shape. Bit-equal to `normalize_u8_plain`."""
    if x_u8.dtype != torch.uint8:
        raise ValueError(f"normalize_u8: expected uint8, got {x_u8.dtype}")
    if x_u8.device.type == "cpu":
        return normalize_u8_plain(x_u8)
    _build.require_cuda_tensor(x_u8, "normalize_u8")
    out = torch.empty(x_u8.shape, dtype=torch.float32, device=x_u8.device)
    n = x_u8.numel()
    if n == 0:            # a grid of 0 blocks is an invalid launch
        return out
    lib = _build.kernel("normalize_u8")
    err = lib.cgs_normalize_u8(x_u8.data_ptr(), out.data_ptr(), n,
                               _build.stream_ptr(x_u8.device))
    _build.check(err, "normalize_u8")
    _build.launches["normalize_u8"] += 1
    return out


# ---------------------------------------------------------------------
# fused threshold + IoU counts
# ---------------------------------------------------------------------

def _check_iou_args(masks: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    if masks.dtype != torch.float32:
        raise ValueError(f"threshold_iou: masks must be float32, got "
                         f"{masks.dtype}")
    if gt.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"threshold_iou: gt must be bool or uint8, got "
                         f"{gt.dtype}")
    if masks.shape != gt.shape:
        raise ValueError(f"threshold_iou: masks {tuple(masks.shape)} and "
                         f"gt {tuple(gt.shape)} differ in shape")
    if masks.device != gt.device:
        raise ValueError("threshold_iou: masks and gt on different "
                         "devices")
    return gt.view(torch.uint8) if gt.dtype == torch.bool else gt


def threshold_iou_plain(masks: torch.Tensor, gt: torch.Tensor,
                        thresh: float) -> Tuple[torch.Tensor, torch.Tensor]:
    hard = masks > thresh
    g = gt > 0
    return (hard & g).sum(), (hard | g).sum()


def threshold_iou(masks: torch.Tensor, gt: torch.Tensor,
                  thresh: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(inter, union) int64 0-dim tensors on the masks' device: counts
    of (masks > thresh) AND / OR (gt > 0). masks float32 and gt bool or
    uint8 of one shape, e.g. (N, H*W). Does not synchronise."""
    gt_u8 = _check_iou_args(masks, gt)
    if masks.device.type == "cpu":
        return threshold_iou_plain(masks, gt_u8, thresh)
    _build.require_cuda_tensor(masks, "threshold_iou")
    _build.require_cuda_tensor(gt_u8, "threshold_iou")
    counts = torch.zeros(2, dtype=torch.int64, device=masks.device)
    n = masks.numel()
    if n == 0:            # empty set: (0, 0) without a launch
        return counts[0], counts[1]
    lib = _build.kernel("threshold_iou")
    err = lib.cgs_threshold_iou(masks.data_ptr(), gt_u8.data_ptr(), n,
                                float(thresh), counts.data_ptr(),
                                _build.stream_ptr(masks.device))
    _build.check(err, "threshold_iou")
    _build.launches["threshold_iou"] += 1
    return counts[0], counts[1]
