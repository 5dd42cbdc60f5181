"""The uint8 ingest, the fused counterfactual merges and their
gradient, and the fused threshold+IoU count: CUDA kernel wrappers and
their plain PyTorch versions.

Ports of `cgs_tpu/ops/pallas_kernels.py:normalize_u8`, `:merge_pair`,
`:merge_pair_bwd` and `:threshold_iou`. On a CUDA tensor each wrapper
launches its kernel (`csrc/normalize_u8.cu`, `csrc/merge_pair.cu`,
`csrc/threshold_iou.cu`) or raises; on a CPU tensor it runs the plain
version, which is also the oracle the kernel is held against on the
card. There is no fallback from the kernel to the plain version.
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
# fused replace + inject merge and its gradient
# ---------------------------------------------------------------------
#
# Frames a, b are NCHW (N, C, H, W) float32 stored channels_last (the
# layout the critic takes); the mask z is (N, 1, H, W), one float per
# pixel, broadcast over the channels inside the kernel (the TPU kernel
# took it pre-broadcast, pallas_kernels.py:broadcast_mask).

def blend(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor
          ) -> torch.Tensor:
    """x with its masked pixels taken from y: x(1 - z) + zy, in the
    kernel's order of operations. Both merges are this blend."""
    return x * (1.0 - z) + z * y


def merge_pair_plain(a: torch.Tensor, b: torch.Tensor, z: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    return blend(a, b, z), blend(b, a, z)          # main.py:395,406


def merge_pair_bwd_plain(a, b, z, gr, gi):
    """(da, db, dz): the merges' VJP, dz summed over the channels in
    the order ((d0 + d1) + d2)."""
    keep = 1.0 - z
    da = gr * keep + gi * z
    db = gr * z + gi * keep
    d = (gr - gi) * (b - a)
    dz = d[:, 0:1]
    for c in range(1, d.shape[1]):
        dz = dz + d[:, c:c + 1]
    return da, db, dz


def _check_merge_args(name: str, a, b, z, *grads) -> None:
    if a.dim() != 4 or a.shape != b.shape:
        raise ValueError(f"{name}: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} must be one (N, C, H, W) shape")
    n, _, h, w = a.shape
    if tuple(z.shape) != (n, 1, h, w):
        raise ValueError(f"{name}: z {tuple(z.shape)} must be "
                         f"{(n, 1, h, w)}")
    for g in grads:
        if g.shape != a.shape:
            raise ValueError(f"{name}: gradient {tuple(g.shape)} must be "
                             f"{tuple(a.shape)}")
    for t in (a, b, z) + grads:
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32, got {t.dtype}")
        if t.device != a.device:
            raise ValueError(f"{name}: tensors on different devices")


def _nchw_empty(like: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(like, memory_format=torch.channels_last)


def _grad_strides(g: torch.Tensor, name: str) -> Tuple[int, int, int]:
    """(n, c, pixel) element strides of a gradient dense in either
    memory format, which the kernel reads in place."""
    sn, sc = g.stride()[:2]
    if g.is_contiguous():
        return sn, sc, 1
    if g.is_contiguous(memory_format=torch.channels_last):
        return sn, sc, g.shape[1]
    raise ValueError(f"{name}: gradient is neither NCHW- nor "
                     "channels_last-dense")


def merge_pair(a: torch.Tensor, b: torch.Tensor, z: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(replaced, injected) = (a(1-z) + zb, b(1-z) + za), both
    channels_last like a. Bit-equal to `merge_pair_plain`."""
    _check_merge_args("merge_pair", a, b, z)
    if a.device.type == "cpu":
        return merge_pair_plain(a, b, z)
    for t in (a, b):
        _build.require_cuda_tensor(t, "merge_pair", torch.channels_last)
    _build.require_cuda_tensor(z, "merge_pair")
    rep, inj = _nchw_empty(a), _nchw_empty(a)
    n, c, h, w = a.shape
    if a.numel() == 0:
        return rep, inj
    lib = _build.kernel("merge_pair")
    err = lib.cgs_merge_pair(a.data_ptr(), b.data_ptr(), z.data_ptr(),
                             rep.data_ptr(), inj.data_ptr(), n * h * w, c,
                             _build.stream_ptr(a.device))
    _build.check(err, "merge_pair")
    _build.launches["merge_pair"] += 1
    return rep, inj


def merge_pair_bwd(a, b, z, gr, gi):
    """(da, db, dz) for cotangents gr, gi of (replaced, injected): da
    and db channels_last like a, dz (N, 1, H, W) summed over the
    channels. gr and gi may each be NCHW- or channels_last-dense (as
    autograd hands them over); the kernel reads either in place.
    Bit-equal to `merge_pair_bwd_plain`."""
    _check_merge_args("merge_pair_bwd", a, b, z, gr, gi)
    if a.device.type == "cpu":
        return merge_pair_bwd_plain(a, b, z, gr, gi)
    for t in (a, b):
        _build.require_cuda_tensor(t, "merge_pair_bwd", torch.channels_last)
    _build.require_cuda_tensor(z, "merge_pair_bwd")
    for t in (gr, gi):
        if t.device.type != "cuda":
            raise ValueError("merge_pair_bwd: expected CUDA gradients")
    gr_s = _grad_strides(gr, "merge_pair_bwd")
    gi_s = _grad_strides(gi, "merge_pair_bwd")
    da, db = _nchw_empty(a), _nchw_empty(a)
    dz = torch.empty_like(z, memory_format=torch.contiguous_format)
    n, c, h, w = a.shape
    if a.numel() == 0:
        return da, db, dz
    lib = _build.kernel("merge_pair")
    err = lib.cgs_merge_pair_bwd(
        a.data_ptr(), b.data_ptr(), z.data_ptr(), gr.data_ptr(),
        gi.data_ptr(), da.data_ptr(), db.data_ptr(), dz.data_ptr(),
        n * h * w, h * w, c, *gr_s, *gi_s, _build.stream_ptr(a.device))
    _build.check(err, "merge_pair_bwd")
    _build.launches["merge_pair_bwd"] += 1
    return da, db, dz


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
